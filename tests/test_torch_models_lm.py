"""The port's LM transformer (``repro_torch.models.transformer``) against
the JAX package on the CPU, for the five LM smoke configs in float32: the
reference's parameters carried across with ``params_from_numpy``, then
forward logits (chunked and flash routes) and the semantics the
reference's ``tests/test_models_lm.py`` checks; gradients and decode are in
``test_torch_models_lm_grads.py``.

Tolerances, float32 throughout: logits within ``LOGIT_TOL`` (the two
packages sum the same products in other orders: a few ulp of values of
order 10), gradients within ``GRAD_RTOL``/``GRAD_ATOL``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

import repro.models.transformer as J
import repro_torch.models.transformer as T
from repro.configs import get_spec as j_spec
from repro_torch.configs import get_spec as t_spec
from repro_torch.launch.train import value_and_grad
from repro_torch.models import params_from_numpy

LM_ARCHS = ["mixtral-8x7b", "mixtral-8x22b", "command-r-35b",
            "smollm-360m", "tinyllama-1.1b"]
LOGIT_TOL = 1e-4          # rtol = atol, float32 logits
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5
j_forward = jax.jit(J.forward, static_argnames=("cfg",))


def _pair(arch, seed=0, **replace):
    """(jax cfg, torch cfg, jax params, torch params) of ``arch``'s smoke
    config, the parameters the reference's, drawn from ``seed``."""
    jc = dataclasses.replace(j_spec(arch).smoke, **replace)
    tc = dataclasses.replace(t_spec(arch).smoke, **replace)
    jp = J.init_params(jax.random.PRNGKey(seed), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return jc, tc, jp, tp


def _tokens(vocab, shape, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, shape).astype(
        np.int32)


def _forward(tc, tp, toks):
    with torch.no_grad():
        return T.forward(tp, torch.from_numpy(toks), tc).numpy()


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_smoke_config_matches_reference(arch):
    """Every field of the smoke and published configs equals the
    reference's, ``compute_dtype`` as the torch dtype of the same name."""
    for which in ("smoke", "config"):
        j, t = getattr(j_spec(arch), which), getattr(t_spec(arch), which)
        for f in dataclasses.fields(J.LMConfig):
            a, b = getattr(t, f.name), getattr(j, f.name)
            if f.name == "compute_dtype":
                assert str(a).split(".")[-1] == jnp.dtype(b).name
            else:
                assert a == b, (which, f.name)
        assert t.param_count() == j.param_count()
        assert t.active_param_count() == j.active_param_count()


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_forward_matches_reference(arch):
    """The chunked route's logits at (2, 32) against the reference's."""
    jc, tc, jp, tp = _pair(arch)
    toks = _tokens(tc.vocab, (2, 32))
    want = np.asarray(j_forward(jp, jnp.asarray(toks), jc))
    got = _forward(tc, tp, toks)
    assert got.shape == (2, 32, tc.vocab) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_flash_route_matches_reference_cpu_route(arch):
    """``attn_impl='flash'``: on the CPU the port's plain version of the
    kernel against the reference's own CPU route of
    ``kops.flash_attention``, and against the chunked route."""
    jc, tc, jp, tp = _pair(arch, attn_impl="flash")
    toks = _tokens(tc.vocab, (2, 32), seed=1)
    want = np.asarray(j_forward(jp, jnp.asarray(toks), jc))
    got = _forward(tc, tp, toks)
    np.testing.assert_allclose(got, want, rtol=LOGIT_TOL, atol=LOGIT_TOL)
    chunked = _forward(dataclasses.replace(tc, attn_impl="chunked"), tp, toks)
    np.testing.assert_allclose(got, chunked, rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_flash_route_is_forward_only():
    """As the reference marks it, flash serves prefill only: where
    autograd records, it raises."""
    _, tc, _, tp = _pair("tinyllama-1.1b", attn_impl="flash")
    toks = torch.from_numpy(_tokens(tc.vocab, (1, 16)))
    with pytest.raises(RuntimeError, match="forward only"):
        value_and_grad(lambda p: T.loss_fn(p, toks, toks, tc), tp)


def test_swa_equals_full_when_window_large():
    _, tc, _, tp = _pair("tinyllama-1.1b", seed=2)
    toks = _tokens(tc.vocab, (2, 32), seed=7)
    np.testing.assert_allclose(
        _forward(dataclasses.replace(tc, sliding_window=None), tp, toks),
        _forward(dataclasses.replace(tc, sliding_window=4096), tp, toks),
        rtol=1e-5, atol=1e-5)


def test_swa_restricts_context_and_matches_reference():
    # dense model: MoE capacity routing would leak global influence
    jc, tc, jp, tp = _pair("tinyllama-1.1b", seed=3, sliding_window=4)
    toks = _tokens(tc.vocab, (1, 32), seed=8)
    out1 = _forward(tc, tp, toks)
    np.testing.assert_allclose(
        out1, np.asarray(j_forward(jp, jnp.asarray(toks), jc)),
        rtol=LOGIT_TOL, atol=LOGIT_TOL)
    # perturbing a token outside the receptive field (n_layers * window)
    # must not change the last position's output
    toks2 = toks.copy()
    toks2[0, 0] = (toks2[0, 0] + 1) % tc.vocab
    out2 = _forward(tc, tp, toks2)
    np.testing.assert_allclose(out1[0, -1], out2[0, -1], rtol=1e-4, atol=1e-4)


def test_chunked_attention_matches_unchunked():
    _, base, _, tp = _pair("command-r-35b", seed=4, attn_chunk=8)
    big = dataclasses.replace(base, attn_chunk=64)
    toks = _tokens(base.vocab, (2, 64), seed=9)
    np.testing.assert_allclose(_forward(base, tp, toks),
                               _forward(big, tp, toks), rtol=2e-4, atol=2e-4)


def test_scan_matches_unrolled():
    """Both ``scan_layers`` settings run one loop: equal logits."""
    _, tc, _, tp = _pair("tinyllama-1.1b", seed=5)
    toks = _tokens(tc.vocab, (2, 16), seed=10)
    np.testing.assert_array_equal(
        _forward(tc, tp, toks),
        _forward(dataclasses.replace(tc, scan_layers=False), tp, toks))


def test_rolling_cache_bounded_by_window():
    cfg = t_spec("mixtral-8x7b").smoke   # sliding_window=32
    cache = T.init_cache(cfg, 4, 524288, device="cpu")
    assert cache["k"].shape[2] == cfg.sliding_window


@pytest.mark.parametrize("dropless", [False, True], ids=["capacity",
                                                        "dropless"])
@pytest.mark.parametrize("arch", ["mixtral-8x7b", "mixtral-8x22b"])
def test_moe_capacity_drops_and_dropless_match_reference(arch, dropless):
    """MoE with capacity drops (the smoke configs' default: 16 tokens, 4
    experts, top-2, capacity 10) and dropless, against the reference."""
    jc, tc, jp, tp = _pair(arch, seed=6, moe_dropless=dropless)
    toks = _tokens(tc.vocab, (2, 16), seed=11)
    got = _forward(tc, tp, toks)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(
        got, np.asarray(j_forward(jp, jnp.asarray(toks), jc)),
        rtol=LOGIT_TOL, atol=LOGIT_TOL)


def test_moe_drops_change_the_output():
    """At capacity 10 some of the 32 routed slots of a 16-token row are
    dropped, so the capacity and dropless outputs differ."""
    _, tc, _, tp = _pair("mixtral-8x7b", seed=6)
    toks = _tokens(tc.vocab, (2, 16), seed=11)
    drop = _forward(tc, tp, toks)
    full = _forward(dataclasses.replace(tc, moe_dropless=True), tp, toks)
    assert drop.shape == full.shape
    assert not np.allclose(drop, full)


def test_param_count_configs():
    # published ballparks: mixtral-8x7b ~47B total / ~13B active
    cfg = t_spec("mixtral-8x7b").config
    assert 4.4e10 < cfg.param_count() < 5.0e10
    assert 1.1e10 < cfg.active_param_count() < 1.5e10
    cfg = t_spec("tinyllama-1.1b").config
    assert 0.9e9 < cfg.param_count() < 1.3e9
    cfg = t_spec("smollm-360m").config
    assert 3.0e8 < cfg.param_count() < 4.5e8
    cfg = t_spec("mixtral-8x22b").config
    assert 1.3e11 < cfg.param_count() < 1.5e11
    cfg = t_spec("command-r-35b").config
    assert 3.0e10 < cfg.param_count() < 4.1e10


def test_init_params_tree_matches_reference():
    """``init_params`` draws the reference's tree: keys, nesting, shapes
    and float32, layers stacked on axis 0; the smoke weights' scales."""
    for arch in LM_ARCHS:
        jc, tc = j_spec(arch).smoke, t_spec(arch).smoke
        jp = jax.eval_shape(lambda: J.init_params(jax.random.PRNGKey(0), jc))
        tp = T.init_params(torch.Generator().manual_seed(0), tc, device="cpu")
        assert jax.tree.structure(jax.tree.map(lambda x: 0, jp)) == \
            jax.tree.structure(jax.tree.map(lambda x: 0, tp))
        for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
            assert tuple(a.shape) == tuple(b.shape)
            assert a.dtype == torch.float32
    std = float(tp["layers"]["wq"].std())
    assert abs(std - tc.d_model ** -0.5) < 0.2 * tc.d_model ** -0.5
