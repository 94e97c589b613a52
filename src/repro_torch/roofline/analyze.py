"""Roofline terms of a traced step (port of ``repro/roofline/analyze.py``).

The reference reads XLA's ``cost_analysis()`` and the optimized HLO text.
The port has no compiler in between: :class:`StepTracer` watches the ops
one step dispatches, as a ``TorchDispatchMode``, while the step runs on
DTensors whose local shards are fake tensors (no memory, no kernel), and
:func:`analyze_trace` turns what it saw into the reference's record.

Under DTensor every op is seen twice: once with DTensor arguments (the
global op) and once more for each local op DTensor runs on the shards
(the local compute, and the functional collectives a redistribution
issues).  Only the local ops are counted, so every term is per device.
An LM step repeats the same few dozen global ops on the same shapes and
placements in every layer and every attention block, so once an op has
counted the same in two runs in a row, its repeats are replayed: the
counts added again and new fake outputs of the same metadata made,
without DTensor's dispatch (a full-depth trace would otherwise take an
hour).  Every op of every layer is still counted.  A trace's counts vary
by a few per cent between a fresh process and one whose DTensor caches
are warm (DTensor's one-time work on a cache miss runs local ops too).

Record keys, as in the reference, and what each counts in the port
(per device, per step):

* ``hlo_flops``: the flops of the local ops that ``torch.utils.flop_counter``
  has a formula for (matrix products, convolutions, attention, and the
  flash-attention op :mod:`repro_torch.kernels.flash_attn` registers).
  Elementwise ops add none (XLA counts them; they are a small share of an
  LM's and run off the tensor cores anyway).
* ``hlo_bytes``: each local op's input bytes plus its output bytes, views
  and allocations excepted (an input read once however often it is
  passed, a broadcast input by its distinct elements, and a gather's
  source by the rows it takes).  Eager PyTorch reads and writes device memory
  once an op; XLA's figure comes after fusion, so the port's figure is an
  upper bound on the traffic a fused step needs.
* ``collective_bytes`` / ``collective_breakdown`` / ``collective_ops``: the
  output bytes and counts of the collectives DTensor issued, by the
  reference's five kinds (:func:`collective_bytes`).
* ``t_compute`` / ``t_memory`` / ``t_collective``: the three above over
  ``HW.peak_flops_bf16``, ``HW.hbm_bw`` and ``HW.coll_bw``
  (:mod:`repro_torch.roofline.hw`); ``bottleneck`` the largest,
  ``step_time_bound`` its time.
* ``model_flops`` (global, the cell's analytic useful work),
  ``useful_flops_ratio`` (its per-device share over ``hlo_flops``) and
  ``roofline_fraction`` (that share at peak over ``step_time_bound``).
* ``flops_by_op`` (the port's own): ``hlo_flops`` by op;
  ``gathered_fallbacks``: whether the tracer gathered any input itself
  (:meth:`StepTracer._global_op`: an op DTensor could not run on its
  placements, or a view it could not size on fake tensors); where it
  did, ``gathered_ops`` (the ops DTensor refused, with its reason) and
  ``gathered_bytes``: of ``collective_bytes``, what those gathers add
  (``collective``, and ``collective_by_op``), and of the peak, the live
  bytes of the gathered inputs and of the outputs of ops run on them
  (``peak``).  Such a record's terms hold the cost of a replication the
  step's shardings did not ask for: an upper bound, not the sharded
  step's.
* ``bytes_per_device``: ``argument`` and ``output`` exact from the
  placements (the local shards' bytes), ``temp`` and ``peak`` from the
  live bytes of the local tensors during the trace (``peak`` counts the
  arguments; ``temp`` is ``peak`` less them).  The step's arguments stay
  live while it runs: nothing is donated, so a train step's old and new
  parameters are both counted.
"""
from __future__ import annotations

import contextlib
import math
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten

from repro_torch.roofline.hw import HW

_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)

# torch.ops._c10d_functional op name -> the reference's collective kind
_FUNCTIONAL_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
}

# ops that move no data of their own
_FREE_OPS = {
    "empty", "empty_strided", "empty_like", "detach", "lift_fresh", "alias",
    "_local_scalar_dense", "wait_tensor", "device", "sym_size",
    "sym_stride", "sym_numel", "sym_storage_offset", "is_same_size",
}


def _itemsize(dtype) -> int:
    if isinstance(dtype, str):
        dtype = getattr(torch, dtype)
    return torch.empty((), dtype=dtype, device="meta").element_size()


def collective_bytes(records) -> dict:
    """Sum the output bytes of every collective in ``records``.

    A record is ``dict(kind=, shape=, dtype=)`` or a ``(kind, shape,
    dtype)`` tuple: ``kind`` one of the reference's five
    (``'all-gather'``, ``'all-reduce'``, ``'reduce-scatter'``,
    ``'all-to-all'``, ``'collective-permute'``; another kind is not a
    collective and is skipped), ``shape`` the op's output shape,
    ``dtype`` a torch dtype or its name.  Returns ``{kind: bytes}`` for
    the five, ``'total'`` and ``'n_ops'`` (the kinds seen, by count), the
    reference's dict: output-shape accounting counts each collective's
    payload once, a proxy for link traffic up to the ``(n - 1) / n`` ring
    factor that ``HW.coll_bw`` folds in."""
    out: dict = {k: 0 for k in _COLLECTIVES}
    n_ops: dict = {k: 0 for k in _COLLECTIVES}
    for r in records:
        kind, shape, dtype = ((r["kind"], r["shape"], r["dtype"])
                              if isinstance(r, dict) else r)
        if kind not in out:
            continue
        out[kind] += math.prod(shape) * _itemsize(dtype)
        n_ops[kind] += 1
    out["total"] = sum(out[k] for k in _COLLECTIVES)
    out["n_ops"] = {k: v for k, v in n_ops.items() if v}
    return out


def _local_tensors(tree) -> list:
    """The plain (local) tensors of ``tree``: DTensors give their shard."""
    from torch.distributed.tensor import DTensor

    out = []
    for x in tree_flatten(tree)[0]:
        if isinstance(x, DTensor):
            out.append(x._local_tensor)
        elif isinstance(x, torch.Tensor):
            out.append(x)
    return out


_GATHERS = {"index", "gather", "embedding", "index_select"}


class _Delta:
    """What one op on DTensors added to the counts (for its replays)."""

    def __init__(self):
        self.flops: list = []
        self.bytes = 0
        self.collectives: list = []
        self.n_ops = 0
        self.gathered = False      # the tracer gathered an input of it

    def state(self):
        return (len(self.flops), self.bytes, len(self.collectives),
                self.n_ops)

    def restore(self, state):
        nf, self.bytes, nc, self.n_ops = state
        del self.flops[nf:]
        del self.collectives[nc:]

    def __eq__(self, other):
        return isinstance(other, _Delta) and (
            self.flops, self.bytes, self.collectives, self.n_ops) == (
            other.flops, other.bytes, other.collectives, other.n_ops)


def _replay_key(func, flat_in, in_spec):
    """A hashable key of an op's arguments' metadata, or ``None`` (a
    mutating op, or an argument that is not a tensor or a plain value)."""
    from torch.distributed.tensor import DTensor

    schema = getattr(func, "_schema", None)
    if schema is not None and schema.is_mutable:
        return None
    parts = [func, str(in_spec)]
    for x in flat_in:
        if isinstance(x, DTensor):
            parts.append(("D", tuple(x.shape), x.stride(), x.dtype,
                          x.placements, id(x.device_mesh),
                          x._local_tensor.stride()))
        elif isinstance(x, torch.Tensor):
            parts.append(("T", tuple(x.shape), x.stride(), x.dtype,
                          x.device))
        elif x is None or isinstance(x, (bool, int, float, str, torch.dtype,
                                         torch.device, torch.memory_format,
                                         torch.layout)):
            parts.append((type(x), x))
        else:
            return None
    return tuple(parts)


def _is_view_op(func) -> bool:
    return any(r.alias_info is not None for r in func._schema.returns)


def _entry(out, delta, *, view: bool):
    """A replay entry for an output tree, or ``None`` where an output is
    not a DTensor (or ``None``)."""
    from torch.distributed.tensor import DTensor

    leaves, spec = tree_flatten(out)
    outs = []
    for o in leaves:
        if o is None:
            outs.append(None)
        elif isinstance(o, DTensor):
            loc = o._local_tensor
            outs.append((o._spec, tuple(loc.shape), loc.stride(),
                         loc.device))
        else:
            return None
    return dict(outs=outs, spec=spec, delta=delta, view=view)


def _group_size(flat_args) -> int:
    """The size of the group a functional collective names (its last
    string argument), or 0 where it cannot be told."""
    from torch.distributed.distributed_c10d import _resolve_process_group

    names = [a for a in flat_args if isinstance(a, str)]
    try:
        return _resolve_process_group(names[-1]).size()
    except (IndexError, KeyError, ValueError, RuntimeError):
        return 0             # a group it cannot tell counts


def _is_strided(p) -> bool:
    """Whether a placement is DTensor's strided shard."""
    return type(p).__name__ == "_StridedShard"


def _distinct_tensors(flat) -> list:
    """The tensors of ``flat``, each once (``x * x`` reads ``x`` once)."""
    seen, out = set(), []
    for x in flat:
        if isinstance(x, torch.Tensor) and id(x) not in seen:
            seen.add(id(x))
            out.append(x)
    return out


def _read_bytes(t: torch.Tensor) -> int:
    """Bytes an op reads of ``t``: its distinct elements (a broadcast
    view, stride 0 along a dim, reads that dim's elements once)."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class StepTracer(TorchDispatchMode):
    """Count what one step does on a device: local flops and bytes, the
    collectives DTensor issues, and the live local bytes (see the module
    docstring).  Enter it with :meth:`watching`, inside ``FakeTensorMode``
    (or on real tensors), around the step; :meth:`track` the arguments
    first.  An op on DTensors is handed back to DTensor
    (``NotImplemented``), whose local ops then come to the tracer: those
    are what it counts."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self.flops = 0
        self.bytes = 0
        self.flops_by_op: dict = {}
        self.collectives: list = []
        self.live = 0
        self.peak = 0
        self.live_gathered = 0       # of live: the tracer's gathers
        self.peak_gathered = 0       # of peak: the tracer's gathers
        self._gathering = 0
        self._storages: dict = {}
        self._paused = 0
        self._in_global = 0
        self._replays: dict = {}
        self._seen: dict = {}
        self._recorders: list = []     # _Delta of each replay being learnt
        self._fn_replays: dict = {}
        self._fn_seen: dict = {}
        self.replayed = 0
        self.gathered: dict = {}      # op -> why DTensor could not run it

    def track(self, tensors) -> int:
        """Count the storages of ``tensors`` (a tree; DTensors by their
        shards) as live from now on; returns their bytes."""
        n = 0
        for t in _local_tensors(tensors):
            n += self._alloc(t)
        return n

    def _alloc(self, t: torch.Tensor, gathered: bool = False) -> int:
        """Count ``t``'s storage live until it is freed; ``gathered``: it
        is a gathered input of an op, or an output of an op run on such
        inputs (:meth:`_global_op`)."""
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages:
            return 0
        nbytes = st.nbytes()
        gathered = gathered or self._gathering > 0
        self._storages[key] = (nbytes, gathered)
        weakref.finalize(st, self._free, key)
        self.live += nbytes
        self.live_gathered += nbytes if gathered else 0
        if self.live > self.peak:
            self.peak, self.peak_gathered = self.live, self.live_gathered
        return nbytes

    def _free(self, key):
        nbytes, gathered = self._storages.pop(key, (0, False))
        self.live -= nbytes
        self.live_gathered -= nbytes if gathered else 0

    def _mark_gathered(self):
        for d in self._recorders:
            d.gathered = True

    def _add_flops(self, key, f):
        self.flops += f
        self.flops_by_op[key] = self.flops_by_op.get(key, 0) + f
        for d in self._recorders:
            d.flops.append((key, f))

    def _add_bytes(self, n):
        self.bytes += n
        for d in self._recorders:
            d.bytes += n

    def _collective(self, rec):
        self.collectives.append(rec)
        for d in self._recorders:
            d.collectives.append(rec)

    def _replay(self, entry):
        """A repeat of an op on DTensors of the same shapes, strides,
        dtypes and placements (each layer, each attention block): its
        counts again, and new fake outputs of the first run's metadata,
        without DTensor's dispatch."""
        from torch.distributed.tensor import DTensor

        self.replayed += 1
        d = entry["delta"]
        for key, f in d.flops:
            self._add_flops(key, f)
        self._add_bytes(d.bytes)
        for rec in d.collectives:
            self._collective(rec)
        for r in self._recorders:
            r.n_ops += d.n_ops
        outs = []
        for o in entry["outs"]:
            if o is None:
                outs.append(None)
                continue
            spec, lshape, lstride, device = o
            local = torch.empty_strided(lshape, lstride,
                                        dtype=spec.tensor_meta.dtype,
                                        device=device)
            if not entry["view"]:
                self._alloc(local, gathered=d.gathered)
            outs.append(DTensor(local, spec, requires_grad=False))
        return tree_unflatten(outs, entry["spec"])

    def _global_op(self, func, args, kwargs):
        """An op on DTensors, run by DTensor with the tracer active again
        (its local ops and collectives come back here).

        Where DTensor cannot run it on these placements (no strategy, a
        view that would split a shard unevenly, a propagation DTensor
        fails on), the counts of the failed attempt are dropped and the op
        runs again on its inputs gathered (:meth:`_gathered`): first all
        but their batch shards (dim 0), then wholly replicated.  An output
        DTensor returns as a strided shard (a view that merged a sharded
        dim into an outer one) is gathered along that shard, and a view's
        input is gathered along any shard that splits its dim unevenly
        first: DTensor computes the local size of either from a tensor of
        indices, which a fake tensor cannot give it (and which, for a
        graph's millions of vertices, takes minutes)."""
        from torch.distributed.tensor import DTensor, Shard

        def batch_only(x, p, n):
            return type(p) is Shard and p.dim == 0

        def nothing(x, p, n):
            return False

        def plain_shard(x, p, n):
            return not _is_strided(p)

        def even(x, p, n):
            return not (p.is_shard() and x.shape[p.dim] % n)

        if _is_view_op(func):
            args, kwargs = tree_map(
                lambda x: self._gathered(x, even, str(func))
                if isinstance(x, DTensor) else x, (args, kwargs))

        snap = (self.flops, self.bytes, len(self.collectives),
                dict(self.flops_by_op),
                [d.state() for d in self._recorders])
        self._in_global += 1
        try:
            with self:
                for keep in (None, batch_only, nothing):
                    if keep is not None:
                        args, kwargs = tree_map(
                            lambda x: self._gathered(x, keep, str(func))
                            if isinstance(x, DTensor) else x,
                            (args, kwargs))
                        self._gathering += 1
                        self._mark_gathered()
                    try:
                        out = func(*args, **kwargs)
                    except (RuntimeError, NotImplementedError, ValueError,
                            AssertionError, IndexError) as e:
                        if keep is nothing:
                            raise
                        (self.flops, self.bytes, n, self.flops_by_op,
                         states) = snap
                        del self.collectives[n:]
                        for d, st in zip(self._recorders, states):
                            d.restore(st)
                        self.gathered[str(func)] = repr(e)[:300]
                        continue
                    finally:
                        if keep is not None:
                            self._gathering -= 1
                    return tree_map(
                        lambda x: self._gathered(x, plain_shard, str(func))
                        if isinstance(x, DTensor) and any(
                            _is_strided(p) for p in x.placements) else x,
                        out)
        finally:
            self._in_global -= 1

    def _gathered(self, x, keep, op: str):
        """A DTensor of ``x``'s global shape and dtype, on a new local
        tensor, whose placements are ``x``'s where ``keep(x, placement,
        mesh dim size)`` and replicated elsewhere, with the collective that
        redistribution costs recorded: an all-gather into the new local shape where a shard
        goes, an all-reduce where a partial sum goes.  Only under fake
        tensors: the new tensor's values are not ``x``'s, which a trace
        never reads (autograd recorded the op above this mode, so its
        backward is the op's own).  ``op``: the op it is gathered for, in
        the collective's record (``source='gathered'``)."""
        from torch.distributed.tensor import DTensor, Replicate

        mesh = x.device_mesh
        placements = [p if keep(x, p, n) else Replicate()
                      for p, n in zip(x.placements, mesh.shape)]
        if list(placements) == list(x.placements):
            return x
        shape = list(x.shape)
        for p, n in zip(placements, mesh.shape):
            if p.is_shard():
                shape[p.dim] = -(-shape[p.dim] // n)
        local = torch.empty(shape, dtype=x.dtype,
                            device=x._local_tensor.device)
        self._alloc(local, gathered=True)
        self._mark_gathered()
        rec = dict(shape=tuple(shape), dtype=str(x.dtype).split(".")[-1],
                   source="gathered", op=op)
        dropped = [p for p, q, n in zip(x.placements, placements, mesh.shape)
                   if p != q and n > 1]
        if any(p.is_shard() or _is_strided(p) for p in dropped):
            self._collective(dict(kind="all-gather", **rec))
        if any(p.is_partial() for p in dropped):
            self._collective(dict(kind="all-reduce", **rec))
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=x.shape, stride=x.stride())

    @contextlib.contextmanager
    def replaying(self, module, name: str):
        """While open, ``module.name`` (a function of tensors, pure but
        for its ops) is replayed like an op: once two calls on arguments
        of the same metadata counted the same, a further such call adds
        those counts and returns new fake outputs, without running.  Only
        where autograd does not record (a replayed output would cut the
        backward graph); the chunked attention's block step of a prefill
        is the use: a 32,768-token prefill runs it 1,024 times a layer."""
        fn = getattr(module, name)

        def wrapper(*args, **kwargs):
            flat, spec = tree_flatten((args, kwargs))
            if torch.is_grad_enabled() and any(
                    isinstance(x, torch.Tensor) and x.requires_grad
                    for x in flat):
                return fn(*args, **kwargs)
            key = _replay_key(fn, flat, spec)
            if key is None:
                return fn(*args, **kwargs)
            entry = self._fn_replays.get(key)
            if entry is not None:
                return self._replay(entry)
            delta = _Delta()
            self._recorders.append(delta)
            try:
                out = fn(*args, **kwargs)
            finally:
                self._recorders.pop()
            if self._fn_seen.get(key) == delta:
                entry = _entry(out, delta, view=False)
                if entry is not None:
                    self._fn_replays[key] = entry
            else:
                self._fn_seen[key] = delta
            return out

        setattr(module, name, wrapper)
        try:
            yield
        finally:
            setattr(module, name, fn)

    @contextlib.contextmanager
    def watching(self):
        """Enter the tracer, with DTensor's output-shape propagation left
        out (on its first sight of an op's shardings DTensor runs the op
        once more on global-shaped fake tensors to learn the output's
        shape, work no device does), and with a shard moved from one dim
        to another by an all-to-all on every device type: on a CPU mesh
        DTensor would gather the whole tensor and chunk it instead (Gloo
        has no all-to-all), so a trace on fake CPU tensors counts what one
        on the card's would."""
        from torch.distributed.tensor import _collective_utils, placement_types
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        name = "_propagate_tensor_meta_non_cached"
        original = getattr(ShardingPropagator, name)
        # the function, and the name placement_types may have imported it as
        a2a_homes = [m for m in (_collective_utils, placement_types)
                     if hasattr(m, "shard_dim_alltoall")]
        original_a2a = [m.shard_dim_alltoall for m in a2a_homes]

        def unwatched(prop, *args, **kwargs):
            self._paused += 1
            try:
                return original(prop, *args, **kwargs)
            finally:
                self._paused -= 1

        def alltoall(x, gather_dim, shard_dim, mesh, mesh_dim):
            return torch.ops._dtensor.shard_dim_alltoall(
                x, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

        setattr(ShardingPropagator, name, unwatched)
        for m in a2a_homes:
            m.shard_dim_alltoall = alltoall
        try:
            with self:
                yield self
        finally:
            setattr(ShardingPropagator, name, original)
            for m, fn in zip(a2a_homes, original_a2a):
                m.shard_dim_alltoall = fn

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        flat_in, in_spec = tree_flatten((args, kwargs))
        if any(isinstance(x, DTensor) for x in flat_in):
            if self._in_global:
                return NotImplemented      # to DTensor's own dispatch
            key = _replay_key(func, flat_in, in_spec)
            if key is None:
                return self._global_op(func, args, kwargs)
            entry = self._replays.get(key)
            if entry is not None:
                return self._replay(entry)
            # the first runs may hold DTensor's one-time work (its caches'
            # misses): an op is replayed once two runs in a row counted
            # the same
            delta = _Delta()
            self._recorders.append(delta)
            try:
                out = self._global_op(func, args, kwargs)
            finally:
                self._recorders.pop()
            if self._seen.get(key) == delta:
                entry = _entry(out, delta, view=_is_view_op(func))
                if entry is not None:
                    self._replays[key] = entry
            else:
                self._seen[key] = delta
            return out
        out = func(*args, **kwargs)
        if self._paused:
            return out
        for d in self._recorders:
            d.n_ops += 1
        name = func._schema.name.split("::")[-1]
        outs = [x for x in tree_flatten(out)[0]
                if isinstance(x, torch.Tensor)]
        ns = func.namespace
        kind = (_FUNCTIONAL_KINDS.get(name) if ns == "_c10d_functional"
                else "all-to-all" if (ns, name) == ("_dtensor",
                                                    "shard_dim_alltoall")
                else None)
        if kind is not None:
            if _group_size(flat_in) == 1:
                return out              # one rank: nothing crosses a link
            for o in outs:
                self._collective(dict(
                    kind=kind, shape=tuple(o.shape),
                    dtype=str(o.dtype).split(".")[-1], source="dtensor"))
        elif name not in _FREE_OPS:
            packet = func._overloadpacket
            if packet in self._flop_registry:
                f = int(self._flop_registry[packet](*args, **kwargs,
                                                    out_val=out))
                self._add_flops(str(packet), f)
            schema = func._schema
            is_view = (not schema.is_mutable and any(
                r.alias_info is not None for r in schema.returns))
            if not is_view:
                ins = _distinct_tensors(flat_in)
                if name in _GATHERS:    # reads the rows it takes, not all
                    n = sum(_read_bytes(x) for x in ins[1:])
                    n += 2 * sum(_nbytes(o) for o in outs)
                else:
                    n = sum(_read_bytes(x) for x in ins)
                    n += sum(_nbytes(o) for o in outs)
                self._add_bytes(n)
        for o in outs:
            self._alloc(o)
        return out


def analyze_trace(trace: StepTracer, chips: int, *,
                  model_flops: float | None = None,
                  argument_bytes: int = 0, output_bytes: int = 0) -> dict:
    """Roofline record of one traced step (keys: the module docstring).
    ``argument_bytes`` / ``output_bytes``: the step's local input and
    output bytes on one device."""
    flops = float(trace.flops)
    byts = float(trace.bytes)
    coll = collective_bytes(trace.collectives)
    t_comp = flops / HW.peak_flops_bf16
    t_mem = byts / HW.hbm_bw
    t_coll = coll["total"] / HW.coll_bw
    terms = dict(compute=t_comp, memory=t_mem, collective=t_coll)
    bottleneck = max(terms, key=terms.get)
    step_time = max(terms.values())
    rec: dict[str, Any] = dict(
        chips=chips,
        hlo_flops=flops,
        hlo_bytes=byts,
        collective_bytes=coll["total"],
        collective_breakdown={k: v for k, v in coll.items()
                              if k in _COLLECTIVES and v},
        collective_ops=coll.get("n_ops", {}),
        t_compute=t_comp,
        t_memory=t_mem,
        t_collective=t_coll,
        bottleneck=bottleneck,
        step_time_bound=step_time,
    )
    if model_flops:
        mf_dev = float(model_flops) / chips
        rec["model_flops"] = float(model_flops)
        rec["useful_flops_ratio"] = mf_dev / max(flops, 1.0)
        rec["roofline_fraction"] = (
            mf_dev / HW.peak_flops_bf16
        ) / max(step_time, 1e-12)
    rec["flops_by_op"] = dict(trace.flops_by_op)
    gathered = [r for r in trace.collectives
                if r.get("source") == "gathered"]
    rec["gathered_fallbacks"] = bool(trace.gathered or gathered)
    if rec["gathered_fallbacks"]:
        rec["gathered_ops"] = dict(trace.gathered)
        by_op: dict = {}
        for r in gathered:
            by_op[r["op"]] = by_op.get(r["op"], 0) + collective_bytes(
                [r])["total"]
        rec["gathered_bytes"] = dict(
            collective=collective_bytes(gathered)["total"],
            collective_by_op=by_op, peak=int(trace.peak_gathered))
    rec["bytes_per_device"] = dict(
        argument=int(argument_bytes),
        output=int(output_bytes),
        temp=int(max(trace.peak - argument_bytes, 0)),
        peak=int(trace.peak),
    )
    return rec
