"""Time variants of the port's spmm and cumsum kernels side by side on one card.

Usage, from the root of the repo, on a machine with a CUDA card and nvcc:

    python3 scripts/torch_kernel_variants.py \
        [--spmm NAME=PATH ...] [--cumsum NAME=PATH ...] [--out DIR]

Variants of ``csrc/spmm.cu``: the repo's source (``repo``), the same with
no grouping of gathers (``group1``: one gather a lane before its FMA) and
with 8 channels a lane (``lane8``), and any source given by ``--spmm`` (for
example an earlier commit's ``csrc/spmm.cu`` beside its ``dtypes.cuh``; one
whose C entry takes an ``int evict_first`` gets 0 there).  Each is held bit
for bit to ``repo`` on phase 5's two spmm inputs of ``chip_smoke.py`` (the
envelope, N=262144 K=16 x 16384x128, and the Reddit layer, N=15360 K=10 x
232965x602), then timed in four interleaved rounds, each the median of 20
event-timed launches.

Variants of ``csrc/cumsum.cu``: the repo's source and any given by
``--cumsum``, on 63,541,806 float32 rows (phase 5's ``cumsum f32 [M]``):
the host time of the C launch alone (a ctypes call, the card idle before
it), the device time of status zeroing plus launch, and for the repo's
source the host time of the whole wrapper (``ops.cumsum``) and the
library call ``torch.cumsum`` the same way.

Every line printed names its variant; the card's name and power limit come
first.  Builds go under ``--out`` (default ``build/variants``).
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
SPMM_EDITS = {"group1": ("kGroup = 8;", "kGroup = 1;"),
              "lane8": ("kLaneElems = 4;", "kLaneElems = 8;")}


def build(name: str, src: Path, out: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build

    lib = out / f"lib{name}.so"
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(src)], check=True, capture_output=True)
    return ctypes.CDLL(str(lib))


def copy_with(src: Path, dst: Path, edit=None) -> Path:
    """``src`` (and the ``dtypes.cuh`` beside it) copied into ``dst``, with
    one exact replacement ``edit = (old, new)`` made in the source."""
    dst.mkdir(parents=True, exist_ok=True)
    shutil.copy(src.parent / "dtypes.cuh", dst / "dtypes.cuh")
    text = src.read_text()
    if edit:
        assert text.count(edit[0]) == 1, edit
        text = text.replace(*edit)
    (dst / src.name).write_text(text)
    return dst / src.name


def event_ms(fn, reps: int = 20) -> float:
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def host_us(fn, reps: int = 50) -> float:
    """Median host time of ``fn()`` in microseconds, the card idle before
    each call."""
    import torch

    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(times) * 1e6


def spmm_variants(srcs: dict[str, Path], out: Path) -> None:
    import torch

    libs, evict = {}, {}
    for name, src in srcs.items():
        libs[name] = lib = build(f"spmm_{name}", src, out)
        evict[name] = "int evict_first" in src.read_text()
        v, ll, i = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        lib.bucket_spmm.argtypes = [v, v, v, v, ll, ll, i, i, i] + \
            [i] * evict[name] + [v]
    gen = torch.Generator(device="cuda").manual_seed(7)
    w_pad = torch.randn(262_144, 16, generator=gen, device="cuda")
    w_pad[torch.rand((262_144, 16), generator=gen, device="cuda") < 0.1] = 0
    cases = {
        "envelope": (torch.randint(0, 16_384, (262_144, 16), generator=gen,
                                   device="cuda", dtype=torch.int32), w_pad,
                     torch.randn(16_384, 128, generator=gen, device="cuda")),
        "reddit": (torch.randint(0, 232_965, (15_360, 10), generator=gen,
                                 device="cuda", dtype=torch.int32),
                   torch.randn(15_360, 10, generator=gen, device="cuda"),
                   torch.randn(232_965, 602, generator=gen, device="cuda")),
    }
    names = list(srcs)
    for case, (nbr, w, x) in cases.items():
        outs = {n: torch.empty(nbr.shape[0], x.shape[1], device="cuda")
                for n in names}

        def launch(n):
            err = libs[n].bucket_spmm(
                nbr.data_ptr(), w.data_ptr(), x.data_ptr(), outs[n].data_ptr(),
                nbr.shape[0], x.shape[0], nbr.shape[1], x.shape[1], 0,
                *[0] * evict[n], torch.cuda.current_stream().cuda_stream)
            assert err == 0, (n, err)

        for n in names:
            launch(n)
        torch.cuda.synchronize()
        for n in names:
            if not torch.equal(outs[n], outs["repo"]):
                raise AssertionError(f"spmm {case}: {n} differs from repo")
        times = {n: [] for n in names}
        for r in range(4):
            for n in names if r % 2 == 0 else names[::-1]:
                times[n].append(event_ms(lambda: launch(n)))
        print(f"spmm {case}: every variant bit-identical to repo")
        for n in names:
            print(f"spmm {case} {n}: median ms {statistics.median(times[n])} "
                  f"rounds {times[n]}; host us a launch "
                  f"{host_us(lambda: launch(n))}", flush=True)


def cumsum_variants(srcs: dict[str, Path], out: Path) -> None:
    import torch

    from repro_torch.kernels import ops

    m = 63_541_806
    gen = torch.Generator(device="cuda").manual_seed(11)
    x = torch.rand(m, generator=gen, device="cuda")
    y = torch.empty_like(x)
    want = torch.cumsum(x.double(), 0)
    libs = {}
    for name, src in srcs.items():
        libs[name] = lib = build(f"cumsum_{name}", src, out)
        lib.cumsum_scratch_bytes.argtypes = [ctypes.c_longlong, ctypes.c_int]
        lib.cumsum_scratch_bytes.restype = ctypes.c_longlong
        v = ctypes.c_void_p
        lib.cumsum_f32.argtypes = [v, v, v, ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_int, v]
    status = torch.zeros(-(-libs["repo"].cumsum_scratch_bytes(m, 1) // 8),
                         dtype=torch.int64, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(n):
        assert libs[n].cumsum_f32(x.data_ptr(), y.data_ptr(),
                                  status.data_ptr(), m, 1, 0, stream) == 0

    def zeroed_launch(n):
        status.zero_()
        launch(n)

    names = list(srcs)
    host, dev = {n: [] for n in names}, {n: [] for n in names}
    for r in range(6):
        for n in names if r % 2 == 0 else names[::-1]:
            ts = []
            for _ in range(50):
                status.zero_()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                launch(n)
                ts.append(time.perf_counter() - t0)
            host[n].append(statistics.median(ts) * 1e6)
            dev[n].append(event_ms(lambda: zeroed_launch(n)))
    for n in names:
        zeroed_launch(n)
        torch.cuda.synchronize()
        err = float((y.double() - want).abs().max())
        print(f"cumsum {n}: host us of the C launch (six rounds) {host[n]}; "
              f"event ms of zeroing + launch {dev[n]}; max abs err {err}",
              flush=True)
    print(f"cumsum ops.cumsum: host us a call "
          f"{host_us(lambda: ops.cumsum(x))}; event ms "
          f"{event_ms(lambda: ops.cumsum(x))}")
    print(f"cumsum torch.cumsum: host us a call "
          f"{host_us(lambda: torch.cumsum(x, 0))}; event ms "
          f"{event_ms(lambda: torch.cumsum(x, 0))}")


def named_paths(items) -> dict[str, Path]:
    out = {}
    for item in items:
        name, _, path = item.partition("=")
        out[name] = Path(path).resolve()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--spmm", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--cumsum", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--out", default=str(ROOT / "build" / "variants"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    spmm = {"repo": CSRC / "spmm.cu"}
    for name, edit in SPMM_EDITS.items():
        spmm[name] = copy_with(CSRC / "spmm.cu", out / f"spmm_{name}", edit)
    spmm_variants({**spmm, **named_paths(args.spmm)}, out)
    cumsum_variants({"repo": CSRC / "cumsum.cu", **named_paths(args.cumsum)},
                    out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
