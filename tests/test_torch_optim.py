"""The port's optimiser (``repro_torch.optim``) against the JAX package on
the CPU: one AdamW step on the same parameters and gradients, clipping,
the schedule's values, and the int8 codes with error feedback, bit for
bit; with the reference's own property checks (``tests/test_optim.py``)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

import repro.optim as jopt
from repro.optim.adamw import global_norm as j_global_norm
from repro.optim.compress import init_error as j_init_error
from repro_torch.models import params_from_numpy
from repro_torch.optim import (
    AdamWConfig, adamw_init, adamw_update, compress_int8, decompress_int8,
    global_norm, init_error, warmup_cosine,
)

# float32 elementwise update: the two packages round the same formula
# (python-float constants, pow of the step) at a few different places
STEP_RTOL, STEP_ATOL = 1e-6, 1e-7


def _tree(seed):
    rng = np.random.default_rng(seed)
    return dict(
        w=rng.normal(size=(8, 5)).astype(np.float32),
        layers=[dict(a=rng.normal(size=(3,)).astype(np.float32)),
                dict(a=rng.normal(size=(3,)).astype(np.float32))],
        b=rng.normal(size=(5,)).astype(np.float32) * 1e-3,
    )


def _t(tree):
    return params_from_numpy(tree, device="cpu")


def _close(got, want, rtol=STEP_RTOL, atol=STEP_ATOL):
    g = jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), got))
    w = jax.tree.leaves(jax.tree.map(np.asarray, want))
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol)


@pytest.mark.parametrize("clip_norm", [1.0, 1e3], ids=["clipped", "free"])
@pytest.mark.parametrize("n_steps", [1, 3])
def test_adamw_steps_match_reference(clip_norm, n_steps):
    """The same parameters and gradients through ``n_steps`` AdamW steps
    (weight decay on, the warmup-cosine scale as ``lr_scale``): new
    parameters, both moments, the step and the metrics."""
    cfg = AdamWConfig(lr=1e-2, weight_decay=0.1, clip_norm=clip_norm)
    p_np = _tree(0)
    jp, tp = jax.tree.map(jnp.asarray, p_np), _t(p_np)
    jo, to = jopt.adamw_init(jp), adamw_init(tp)
    for s in range(n_steps):
        g_np = jax.tree.map(lambda x: x * 3.0, _tree(10 + s))
        jl = jopt.warmup_cosine(jo["step"], warmup=2, total=10)
        tl = warmup_cosine(to["step"], warmup=2, total=10)
        jp, jo, jm = jopt.adamw_update(jp, jax.tree.map(jnp.asarray, g_np),
                                       jo, cfg, jl)
        tp, to, tm = adamw_update(tp, _t(g_np), to, cfg, tl)
    _close(tp, jp)
    _close(to["m"], jo["m"])
    _close(to["v"], jo["v"])
    assert int(to["step"]) == int(jo["step"]) == n_steps
    assert to["step"].dtype == torch.int32
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)


def test_adamw_state_layout_matches_reference():
    """``dict(m, v, step)`` with the parameters' keys, nesting and shapes,
    m and v float32, step an int32 scalar: one checkpoint format."""
    p_np = _tree(1)
    js = jopt.adamw_init(jax.tree.map(jnp.asarray, p_np))
    ts = adamw_init(_t(p_np))
    assert jax.tree.structure(jax.tree.map(lambda x: 0, js)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, ts))
    for a, b in zip(jax.tree.leaves(ts), jax.tree.leaves(js)):
        assert tuple(a.shape) == tuple(b.shape)
        assert str(a.dtype).split(".")[-1] == str(b.dtype)


def test_adamw_minimizes_quadratic():
    params = dict(w=torch.tensor([5.0, -3.0]))
    opt = adamw_init(params)
    cfg = AdamWConfig(lr=0.1, weight_decay=0.0)
    for _ in range(200):
        params, opt, _ = adamw_update(params, dict(w=2 * params["w"]), opt,
                                      cfg)
    assert float(torch.sum(params["w"] ** 2)) < 1e-3


def test_grad_clipping():
    params = dict(w=torch.ones(4))
    opt = adamw_init(params)
    cfg = AdamWConfig(lr=1.0, clip_norm=1e-6, weight_decay=0.0)
    new, _, m = adamw_update(params, dict(w=torch.full((4,), 1e6)), opt, cfg)
    # with a tiny clip norm, the effective step is bounded by lr
    assert float((new["w"] - params["w"]).abs().max()) < 1.5 * cfg.lr
    assert float(m["grad_norm"]) == pytest.approx(2e6, rel=1e-3)


def test_schedule_matches_reference():
    steps = [0, 5, 10, 50, 99, 100, 500]
    got = np.array([float(warmup_cosine(torch.tensor(t), warmup=10,
                                        total=100)) for t in steps])
    want = np.array([float(jopt.warmup_cosine(jnp.asarray(t), warmup=10,
                                              total=100)) for t in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got[0] == 0.0
    assert got[1] == pytest.approx(0.5)
    assert got[2] == pytest.approx(1.0)
    assert 0.1 <= got[-1] <= 1.0 + 1e-6
    # a Python int step, as the reference also takes
    assert float(warmup_cosine(5, warmup=10, total=100)) == got[1]


def test_global_norm():
    t = dict(a=torch.tensor([3.0]), b=torch.tensor([4.0]))
    assert float(global_norm(t)) == pytest.approx(5.0)
    p_np = _tree(2)
    np.testing.assert_allclose(
        float(global_norm(_t(p_np))),
        float(j_global_norm(jax.tree.map(jnp.asarray, p_np))), rtol=1e-6)


def test_int8_codes_bitwise_equal_reference():
    """Twenty rounds of compression with error feedback: the int8 codes
    equal the reference's bit for bit each round (``torch.round`` and
    ``jnp.round`` both round half to even; values on exact halves are
    included), the scales and residuals within float32 rounding."""
    rng = np.random.default_rng(0)
    g_np = dict(a=rng.normal(size=128).astype(np.float32),
                b=[(np.arange(-6, 7, dtype=np.float32) * 0.5 + 0.25)])
    g_np["b"][0][0] = -3.0    # -127 / 127 * 3 = -3: scale 3/127, exact ends
    je, te = j_init_error(g_np), init_error(_t(g_np))
    for _ in range(20):
        jq, js, je = jopt.compress_int8(jax.tree.map(jnp.asarray, g_np), je)
        tq, ts, te = compress_int8(_t(g_np), te)
        for a, b in zip(jax.tree.leaves(tq), jax.tree.leaves(jq)):
            assert a.dtype == torch.int8
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        _close(ts, js, rtol=0, atol=0)
        _close(te, je, rtol=0, atol=1e-6)


def test_int8_compression_roundtrip_and_error_feedback():
    rng = np.random.default_rng(0)
    g = dict(a=torch.from_numpy(rng.normal(size=128).astype(np.float32)))
    err = init_error(g)
    q, s, err2 = compress_int8(g, err)
    deq = decompress_int8(q, s)
    # quantization error bounded by scale/2 and fed back
    scale = float(s["a"])
    assert float((deq["a"] - g["a"]).abs().max()) <= scale * 0.51
    np.testing.assert_allclose((g["a"] - deq["a"]).numpy(),
                               err2["a"].numpy(), atol=1e-6)
    # error feedback keeps the long-run mean unbiased: accumulate k rounds
    total = torch.zeros(128)
    err = None          # no residual yet, as the reference accepts
    for _ in range(20):
        q, s, err = compress_int8(g, err)
        total = total + decompress_int8(q, s)["a"]
    np.testing.assert_allclose((total / 20).numpy(), g["a"].numpy(),
                               atol=scale / 10)
