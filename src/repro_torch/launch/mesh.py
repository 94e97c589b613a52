"""Meshes of ranks for the sharded path: one worker process a rank, joined
by a ``torch.distributed`` process group.

The reference runs ``shard_map`` from one controller over a
``jax.sharding.Mesh``.  The port takes PyTorch's idiom, one process a
shard, and keeps the reference's single-caller API: a :class:`Mesh` names
one device a rank and starts its workers (``torch.multiprocessing`` with
the ``spawn`` method) on first use, keeping them until :meth:`Mesh.close`
or interpreter exit.  The workers rendezvous through a ``FileStore`` in a
temporary directory.  The caller stays outside the group, as a
controller: it sends each rank a job (:meth:`Mesh.run`) and waits for
every rank's result, so a worker that dies cannot hang it inside a
collective.

Backends: NCCL where every rank has its own CUDA device, gloo otherwise
(CPU ranks, or ranks sharing a card: NCCL refuses two ranks on one GPU,
and gloo stages CUDA tensors through the host).  Every process group
has a finite timeout, the caller waits with one, and a failed, dead or
late rank closes the mesh's workers and raises :class:`MeshError` with
the rank's traceback.  Nothing falls back: a mesh asked for on CUDA never
runs a rank on the CPU.

The step builder and the dry run (:mod:`repro_torch.launch.steps`,
:mod:`repro_torch.launch.dryrun`) take another kind of mesh: a
``torch.distributed`` ``DeviceMesh`` over the caller's own process group,
of the reference's production shape (:func:`make_production_mesh`).  The
dry run opens that group with PyTorch's ``fake`` backend
(:func:`fake_process_group`), so one process stands for every rank.
"""
from __future__ import annotations

import atexit
import collections
import contextlib
import dataclasses
import datetime
import os
import queue
import shutil
import socket
import tempfile
import threading
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing

BACKENDS = ("nccl", "gloo")
GROUP_TIMEOUT_S = 60.0      # a collective that waits longer raises
START_TIMEOUT_S = 300.0     # spawn, import torch, join the group
JOB_TIMEOUT_S = 3600.0      # one job, by default
_POLL_S = 0.5
_REPORTS_KEPT = 256


class MeshError(RuntimeError):
    """A rank of a mesh failed, died or ran out of time."""


@dataclasses.dataclass(frozen=True)
class RankContext:
    """What a job's function gets on its rank."""

    rank: int
    size: int
    device: torch.device
    group: object            # the process group of the mesh's ranks


def _normalize(device) -> str:
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", 0)
    if d.type not in ("cpu", "cuda"):
        raise ValueError(f"a rank runs on 'cpu' or 'cuda', got {device!r}")
    return str(d)


def _backend(devices: tuple[str, ...]) -> str:
    if all(d.startswith("cuda") for d in devices) and \
            len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


def _worker(rank, devices, backend, store_path, jobs, results):
    """A rank's process: join the group, then run jobs until ``None``."""
    try:
        t0 = time.perf_counter()
        device = torch.device(devices[rank])
        if device.type == "cuda":
            torch.cuda.set_device(device)
        else:
            torch.set_num_threads(1)
        if backend == "gloo" and "GLOO_SOCKET_IFNAME" not in os.environ and \
                "lo" in (name for _, name in socket.if_nameindex()):
            # every rank is a local process: talk over loopback, whatever
            # the host name resolves to
            os.environ["GLOO_SOCKET_IFNAME"] = "lo"
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, len(devices)),
            rank=rank, world_size=len(devices),
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        ctx = RankContext(rank, len(devices), device, dist.group.WORLD)
    except Exception:
        results.put((rank, False, traceback.format_exc()))
        return
    results.put((rank, True, time.perf_counter() - t0))
    try:
        while (job := jobs.get()) is not None:
            fn, args = job
            try:
                results.put((rank, True, fn(ctx, *args)))
            except Exception:
                results.put((rank, False, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


class _Pool:
    """The worker processes of one mesh, started on first use."""

    def __init__(self, devices: tuple[str, ...], backend: str):
        self.devices = devices
        self.backend = backend
        self.startup_seconds = None
        self.reports = collections.deque(maxlen=_REPORTS_KEPT)
        self._lock = threading.Lock()
        self._procs = []
        self._jobs = []
        self._results = None
        self._tmp = None
        self._atexit = False

    @property
    def alive(self) -> bool:
        return bool(self._procs) and all(p.is_alive() for p in self._procs)

    def _start(self):
        self._stop(graceful=False)
        mp = torch.multiprocessing.get_context("spawn")
        self._tmp = tempfile.mkdtemp(prefix="repro_torch_mesh_")
        store = os.path.join(self._tmp, "store")
        self._results = mp.Queue()
        self._jobs = [mp.Queue() for _ in self.devices]
        t0 = time.perf_counter()
        self._procs = [
            mp.Process(target=_worker, daemon=True,
                       name=f"repro_torch-rank{r}",
                       args=(r, self.devices, self.backend, store,
                             self._jobs[r], self._results))
            for r in range(len(self.devices))]
        for p in self._procs:
            p.start()
        if not self._atexit:
            atexit.register(self.close)
            self._atexit = True
        self._collect(time.monotonic() + START_TIMEOUT_S, "start")
        self.startup_seconds = time.perf_counter() - t0

    def _collect(self, deadline: float, what: str) -> list:
        """Every rank's next result, in rank order; on a failed, dead or
        late rank, stop the workers and raise :class:`MeshError`."""
        out = [None] * len(self.devices)
        missing = set(range(len(self.devices)))
        while missing:
            try:
                rank, ok, payload = self._results.get(timeout=_POLL_S)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if p.exitcode is not None]
                late = time.monotonic() > deadline
                if dead or late:
                    codes = [p.exitcode for p in self._procs]
                    self._stop(graceful=False)
                    raise MeshError(
                        f"{what} on mesh {self.devices}: "
                        + (f"ranks {dead} died (exit codes {codes})" if dead
                           else f"ranks {sorted(missing)} late")) from None
                continue
            if not ok:
                self._stop(graceful=False)
                raise MeshError(f"{what} on mesh {self.devices}: rank {rank} "
                                f"({self.devices[rank]}) failed:\n{payload}")
            out[rank] = payload
            missing.discard(rank)
        return out

    def run(self, fn, args, timeout: float) -> list:
        with self._lock:
            if not self.alive:
                self._start()
            for q in self._jobs:
                q.put((fn, args))
            return self._collect(time.monotonic() + timeout, "a job")

    def _stop(self, graceful: bool):
        procs, self._procs = self._procs, []
        if graceful:
            for q in self._jobs:
                q.put(None)
        if self._results is not None:   # drain before joining the writers
            try:
                while True:
                    self._results.get_nowait()
            except (queue.Empty, OSError, ValueError):
                pass
        for p in procs:
            p.join(timeout=10.0 if graceful else 0.0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
            if p.is_alive():
                p.kill()
                p.join()
        for q in [*self._jobs, self._results]:
            if q is not None:
                q.cancel_join_thread()
                q.close()
        self._jobs, self._results = [], None
        if self._tmp is not None:
            shutil.rmtree(self._tmp, ignore_errors=True)
            self._tmp = None

    def close(self):
        with self._lock:
            self._stop(graceful=True)

    def pids(self) -> list[int]:
        return [p.pid for p in self._procs]


@dataclasses.dataclass(frozen=True)
class Mesh:
    """One device a rank (``devices``, e.g. ``("cuda:0", "cuda:1")``) and
    the process-group backend (``'nccl'`` or ``'gloo'``).

    Frozen and hashable by those two fields; the worker processes belong
    to the object (two equal meshes made apart have their own workers).
    Build one with :func:`make_mesh` or :func:`make_host_mesh`, which
    resolve the backend.
    """

    devices: tuple[str, ...]
    backend: str
    _pool: _Pool = dataclasses.field(init=False, compare=False, hash=False,
                                     repr=False)

    def __post_init__(self):
        devices = tuple(_normalize(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one rank")
        if len({d.split(":")[0] for d in devices}) != 1:
            raise ValueError(f"a mesh's ranks share one device kind, got "
                             f"{devices}")
        if self.backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got "
                             f"{self.backend!r}")
        if self.backend == "nccl" and _backend(devices) != "nccl":
            raise ValueError("NCCL takes one CUDA device a rank, got "
                             f"{devices}: use 'gloo'")
        object.__setattr__(self, "devices", devices)
        object.__setattr__(self, "_pool", _Pool(devices, self.backend))

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def alive(self) -> bool:
        """Whether the workers are running."""
        return self._pool.alive

    @property
    def startup_seconds(self):
        """Wall seconds the last start of the workers took (spawn, import,
        joining the group), or ``None`` before the first."""
        return self._pool.startup_seconds

    @property
    def reports(self) -> collections.deque:
        """Per-rank reports the sharded driver left, newest last (bounded;
        clear it to read one call's)."""
        return self._pool.reports

    def pids(self) -> list[int]:
        """The workers' process ids (empty when they are not running)."""
        return self._pool.pids()

    def start(self):
        """Start the workers now, if they are not running."""
        with self._pool._lock:
            if not self._pool.alive:
                self._pool._start()

    def run(self, fn, *args, timeout: float = JOB_TIMEOUT_S) -> list:
        """``fn(ctx, *args)`` on every rank (``ctx`` a :class:`RankContext`);
        the results in rank order.  ``fn`` and ``args`` go to each worker
        by pickle (CPU tensors through shared memory), so ``fn`` is a
        module-level function.  Raises :class:`MeshError` when a rank
        raises, dies or takes longer than ``timeout`` seconds, after
        stopping every worker (the next call starts them anew)."""
        return self._pool.run(fn, args, timeout)

    def close(self):
        """Stop the workers (the mesh starts them again on its next use)."""
        self._pool.close()


def make_mesh(devices) -> Mesh:
    """A mesh of one rank for each entry of ``devices`` (a card may repeat:
    its ranks then share it over gloo)."""
    devices = tuple(_normalize(d) for d in devices)
    return Mesh(devices, _backend(devices) if devices else "gloo")


_HOST_MESHES: dict = {}


def make_host_mesh(n=None, *, device=None) -> Mesh:
    """``n`` ranks on the caller's device kind, cached per ``(n, kind)``
    with live workers.  ``device=None`` means CUDA: ``cuda:0..n-1`` (every
    card for ``n=None``), raising when ``n`` exceeds the cards there are.
    ``device='cpu'`` gives ``n`` CPU ranks over gloo."""
    kind = "cuda" if device is None else torch.device(device).type
    if kind == "cuda":
        avail = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = avail if n is None else int(n)
        if n < 1 or n > avail:
            raise ValueError(
                f"mesh={n} devices requested, {avail} CUDA devices "
                "available (pass device='cpu' for CPU ranks)")
        devices = tuple(f"cuda:{i}" for i in range(n))
    elif kind == "cpu":
        if n is None or int(n) < 1:
            raise ValueError(f"CPU ranks need a count >= 1, got {n}")
        n = int(n)
        devices = ("cpu",) * n
    else:
        raise ValueError(f"a rank runs on 'cpu' or 'cuda', got {device!r}")
    mesh = _HOST_MESHES.get((n, kind))
    if mesh is None:
        mesh = _HOST_MESHES[(n, kind)] = make_mesh(devices)
    return mesh


def resolve_mesh(mesh, device=None):
    """``None``, or a :class:`Mesh`: ``mesh`` itself, or for an int that
    many ranks by :func:`make_host_mesh` on ``device``'s kind."""
    if mesh is None or isinstance(mesh, Mesh):
        return mesh
    if isinstance(mesh, bool) or not isinstance(mesh, int):
        raise TypeError(f"mesh must be None, an int or a Mesh, got {mesh!r}")
    return make_host_mesh(mesh, device=device)


# --------------------------------------------------------------------------
# production meshes for the step builder and the dry run
# --------------------------------------------------------------------------

POD_SHAPE, POD_AXES = (16, 16), ("data", "model")
MULTIPOD_SHAPE, MULTIPOD_AXES = (2, 16, 16), ("pod", "data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type="cuda"):
    """The reference's production mesh as a ``DeviceMesh`` over the default
    process group: ``(16, 16)`` ``(data, model)``, or with ``multi_pod``
    ``(2, 16, 16)`` ``(pod, data, model)``.  Raises unless the group's
    world size equals the mesh's size (256 or 512)."""
    from torch.distributed.device_mesh import init_device_mesh

    shape = MULTIPOD_SHAPE if multi_pod else POD_SHAPE
    axes = MULTIPOD_AXES if multi_pod else POD_AXES
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized() or dist.get_world_size() != n:
        have = dist.get_world_size() if dist.is_initialized() else None
        raise ValueError(f"the {'multi-pod' if multi_pod else 'pod'} mesh "
                         f"{shape} needs a process group of {n} ranks, got "
                         f"{have}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def flat_axes(mesh) -> tuple:
    """All axis names of a mesh: the edge-parallel axis set for graph
    work."""
    names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names
    return tuple(names)


@contextlib.contextmanager
def fake_process_group(n: int):
    """The default process group as ``n`` ranks of PyTorch's ``fake``
    backend, this process rank 0, for the body of the ``with``: its
    collectives return at once and move no data, so one process traces a
    step of any mesh.  Destroyed on exit.  The one place the port imports
    ``torch.testing._internal.distributed.fake_pg`` (it registers the
    backend)."""
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:          # pragma: no cover - torch builds vary
        raise RuntimeError(
            "the dry run needs PyTorch's fake process-group backend "
            "(torch.testing._internal.distributed.fake_pg), which this "
            f"torch ({torch.__version__}) does not provide") from e
    if dist.is_initialized():
        raise RuntimeError("a default process group is already open")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=int(n))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()
