"""Build the CUDA sources under ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library, loaded with :mod:`ctypes`.  Libraries go to
``build/repro_torch_kernels/<hash>/`` at the root of the checkout, keyed by
a hash of the source, the shared headers (``csrc/*.cuh``) and the flags, so
a fresh checkout builds everything it runs and a changed source is never
served stale.  Nothing prebuilt is
shipped or fetched.  Sources build in parallel: one ``nvcc`` per source,
all started together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("segreduce", "cumsum", "onehot_segsum", "spmm", "flash_attn",
           "dense_sweep")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# dtype codes of the kernels' float inputs and outputs (csrc/dtypes.cuh)
FLOAT_CODES = {"float32": 0, "float16": 1, "bfloat16": 2}

_loaded: dict[str, ctypes.CDLL] = {}
_bound: dict[tuple[str, str], object] = {}


def nvcc_path() -> str:
    """The CUDA compiler that ``torch.utils.cpp_extension`` would use."""
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = []
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    candidates.append(shutil.which("nvcc"))
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of repro_torch are built from "
        "source at first use and need the CUDA toolkit")


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16] / f"lib{name}.so"


def build(names=SOURCES) -> dict[str, str]:
    """Compile every source whose library is missing, all in parallel.

    Returns ``{name: ptxas report}`` for the sources compiled by this call
    (register and shared-memory use per kernel).  Raises on any failure.
    """
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        out = library_path(name)
        out.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reports, failed = {}, []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, library_path(name))  # atomic: readers never see half a file
        reports[name] = log
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib


def bind(name: str, symbol: str, argtypes, restype=ctypes.c_int):
    """``symbol`` of ``csrc/<name>.cu`` as a ctypes function, built at first
    use; it returns ``restype``, by default int (0, or the ``cudaError_t``
    of a refused launch)."""
    fn = _bound.get((name, symbol))
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = restype
        _bound[(name, symbol)] = fn
    return fn


def float_code(dtype) -> int:
    """The kernels' code for a float32/float16/bfloat16 torch dtype."""
    code = FLOAT_CODES.get(str(dtype).removeprefix("torch."))
    if code is None:
        raise TypeError(f"the kernel takes float32, float16 or bfloat16, "
                        f"got {dtype}")
    return code


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")
