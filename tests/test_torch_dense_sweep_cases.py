"""The dense scan's plain half-sweep and realized modularity on the stress
cases of ``tests/_torch_dense_cases.py``, against the JAX package, and the
host-side launch plans of their kernels (``kernels/dense_sweep.py``).

The plain versions (``_half_sweep_dense_plain``, ``realized_modularity``)
are what the CPU runs and what the card's kernels are held to bit for bit,
so they are held here to the reference's ``_half_sweep_dense`` (C, Sigma,
moved and want bit for bit; ``gain``, a flat float32 sum that decides
nothing, within 1e-6) and its realized modularity (within 1e-6: the port
sums in a fixed tree of in-order folds, the reference with ``jnp.sum``),
and the port's Q bit for bit to a numpy tree of left folds.  Both packages
are handed the same numpy inputs, 2m included.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_dense_cases import CASE_NAMES, dense_cases, tree_sum
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

from repro.core.local_move import _half_sweep_dense as j_half_sweep_dense
from repro.core.local_move import realized_modularity as j_realized
from repro_torch.core.local_move import _half_sweep_dense as t_half_sweep_dense
from repro_torch.core.local_move import realized_modularity as t_realized
from repro_torch.kernels import _build, dense_sweep

CASES = {c["name"]: c for c in dense_cases()}
VARIANTS = {"handshake": (True, True), "parity": (False, True),
            "all": (False, False)}


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("name", CASE_NAMES)
def test_plain_half_sweep_equals_reference(name, variant):
    c = CASES[name]
    target, anchored = VARIANTS[variant]
    two_m = np.float32(c["two_m"])
    want = j_half_sweep_dense(
        jnp.asarray(c["src"]), jnp.asarray(c["dst"]), jnp.asarray(c["w"]),
        jnp.asarray(c["C"]), jnp.asarray(c["K"]), jnp.asarray(c["Sigma"]),
        jnp.float32(two_m), None, jnp.asarray(c["movable"]), None,
        target_ok=jnp.asarray(c["target_ok"]) if target else None,
        anchored=anchored)
    got = t_half_sweep_dense(
        _t(c["src"]), _t(c["dst"]), _t(c["w"]), _t(c["C"]), _t(c["K"]),
        _t(c["Sigma"]), torch.tensor(two_m), _t(c["movable"]),
        target_ok=_t(c["target_ok"]) if target else None, anchored=anchored)
    for what, a, b in zip(("C", "Sigma", "moved", "gain", "want"), got,
                          want):
        b = np.asarray(b)
        if what == "gain":
            assert abs(float(a) - float(b)) <= 1e-6 * max(1.0, abs(float(b)))
            continue
        a = a.numpy()
        if a.dtype == np.float32:
            a, b = a.view(np.int32), b.view(np.int32)
        np.testing.assert_array_equal(a, b, err_msg=f"{name}: {what}")


def test_the_cases_reach_their_shapes():
    """Each case has the shape it is named for, and the sweeps move."""
    hub = CASES["hub"]
    assert int((hub["src"] == 0).sum()) == hub["nv"] - 1
    assert hub["movable"][0]
    assert CASES["m-ragged"]["src"].shape[0] % 1024 != 0
    assert CASES["m-large"]["src"].shape[0] > 65_536
    assert CASES["nv2"]["nv"] == 2
    assert set(CASES["one-community"]["C"][:-1].tolist()) == {0}
    assert (CASES["singletons"]["C"] == np.arange(200)).all()
    w = CASES["masked"]["w"]
    assert (w == 0).sum() > 0 and (w > 0).sum() > 0
    moved = t_half_sweep_dense(*(_t(CASES["hub"][k]) for k in (
        "src", "dst", "w", "C", "K", "Sigma")), torch.tensor(
        CASES["hub"]["two_m"]), _t(CASES["hub"]["movable"]))[2]
    assert bool(moved.any())


@pytest.mark.parametrize("name", CASE_NAMES)
def test_realized_modularity_equals_tree_and_reference(name):
    c = CASES[name]
    two_m = np.float32(c["two_m"])
    got = t_realized(_t(c["src"]), _t(c["dst"]), _t(c["w"]), _t(c["C"]),
                     _t(c["Sigma"]), torch.tensor(two_m))
    w_in = np.where(c["C"][c["src"]] == c["C"][c["dst"]], c["w"],
                    np.float32(0.0)).astype(np.float32)
    internal = tree_sum(w_in)
    sig2 = tree_sum((c["Sigma"] * c["Sigma"]).astype(np.float32))
    tree = np.float32(np.float32(internal / two_m)
                      - np.float32(sig2 / np.float32(two_m * two_m)))
    assert got.numpy().view(np.int32) == np.array(tree).view(np.int32)
    ref = float(j_realized(jnp.asarray(c["src"]), jnp.asarray(c["dst"]),
                           jnp.asarray(c["w"]), jnp.asarray(c["C"]),
                           jnp.asarray(c["Sigma"]), jnp.float32(two_m),
                           None, None))
    assert abs(float(got) - ref) <= 1e-6 * max(1.0, abs(ref))


# --- the kernels' host-side plans ----------------------------------------

SMEM_PER_BLOCK = 232_448      # an H100 block's shared memory, bytes
STATIC_ROWS_SMEM = 2 * 4 * 32 * dense_sweep.WARPS   # s_a, s_f


@pytest.mark.parametrize("nv", [1, 2, 65, 1025, dense_sweep.MAX_NV])
def test_sweep_plan_in_shared_memory(nv):
    p = dense_sweep.sweep_plan(nv)
    assert p["grid"] * dense_sweep.WARPS >= nv        # a warp a row
    assert p["rows_smem"] == 12 * nv * dense_sweep.WARPS
    assert p["rows_smem"] + STATIC_ROWS_SMEM <= SMEM_PER_BLOCK
    assert p["sigma_smem"] == 16 * nv <= 48 * 1024
    assert p["scratch_floats"] == 0
    assert p["out_bytes"] == 14 * nv


@pytest.mark.parametrize("nv", [dense_sweep.MAX_NV + 1, 24_577, 100_000])
def test_sweep_plan_past_shared_memory(nv):
    p = dense_sweep.sweep_plan(nv)
    assert p["rows_smem"] == p["sigma_smem"] == 0
    assert p["grid"] * dense_sweep.WARPS == dense_sweep.SCRATCH_WARPS
    assert p["scratch_floats"] == 3 * nv * dense_sweep.SCRATCH_WARPS + 2 * nv


@pytest.mark.parametrize("m,nv", [(0, 1), (1, 2), (1023, 65), (1024, 65),
                                  (1025, 65), (16_384, 1025),
                                  (70_001, 513), (1_100_000, 1025),
                                  (3, 5000)])
def test_modularity_plan(m, nv):
    """A block a leaf chunk of either tree; each tree's scratch holds its
    level-0 partials and the next level beside them (the kernel folds the
    levels in ping-pong), then a word for the launch's ticket and one
    float for the result."""
    p = dense_sweep.modularity_plan(m, nv)
    assert p["n_int"] == max(-(-m // 1024), 1)
    assert p["n_sig"] == max(-(-nv // 1024), 1)
    assert p["blocks"] == p["n_int"] + p["n_sig"]
    for n in (p["n_int"], p["n_sig"]):
        while n > 1:
            nxt = -(-n // 1024)
            assert n + nxt <= p["half"]
            n = nxt
    assert p["scratch_floats"] == 2 * p["half"] + 2


def test_plan_constants_match_the_source():
    src = (_build.CSRC / "dense_sweep.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert int(consts["kWarps"]) == dense_sweep.WARPS
    assert int(consts["kFlat"]) == dense_sweep.FLAT_CHUNK
    # no float atomics: each atomic lands on an integer tag or on a
    # graph's ticket
    targets = set(re.findall(r"atomic(?:Add|CAS)\((&?[\w\[\]]+),", src))
    assert targets == {"&tickets[g]", "&tag[cl]"}, targets
    assert "unsigned int* tickets" in src
    # the tickets lie in the launch's own scratch, zeroed on its stream
    assert "__device__ unsigned" not in src
    assert "cudaMemsetAsync(tickets, 0" in src
    assert "atomicOr" not in src and "atomicMax" not in src
    assert "__fmaf" not in src and "fmaf(" not in src
