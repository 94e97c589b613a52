"""The port's LM transformer against the JAX package on the CPU, second
half (the first is ``test_torch_models_lm.py``, whose helpers this file
shares): gradients against ``jax.grad``, remat, and decode against the
reference's ``decode_step`` and the port's forward, for the smoke configs
in float32."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_models_lm import (GRAD_ATOL, GRAD_RTOL, LM_ARCHS, LOGIT_TOL,
                                  _forward, _pair, _tokens, j_spec)

import repro.models.transformer as J
import repro_torch.models.transformer as T
from repro_torch.launch.train import value_and_grad

j_value_and_grad = jax.jit(jax.value_and_grad(J.loss_fn),
                           static_argnames=("cfg",))


@pytest.mark.parametrize("arch", LM_ARCHS)
def test_grads_match_reference(arch):
    """``jax.grad`` of the loss against autograd, every leaf."""
    jc, tc, jp, tp = _pair(arch, seed=1)
    toks = _tokens(tc.vocab, (2, 16), seed=2)
    tgt = _tokens(tc.vocab, (2, 16), seed=3)
    jl, jg = j_value_and_grad(jp, jnp.asarray(toks), jnp.asarray(tgt), jc)
    tl, tg = value_and_grad(lambda p: T.loss_fn(
        p, torch.from_numpy(toks), torch.from_numpy(tgt), tc), tp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), tg)),
                    jax.tree.leaves(jg)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)

def test_remat_gives_the_same_grads():
    """``remat`` (each layer under ``torch.utils.checkpoint``, full or
    'dots') changes memory, not values."""
    _, tc, _, tp = _pair("command-r-35b", seed=4)
    toks = torch.from_numpy(_tokens(tc.vocab, (2, 16), seed=4))
    out = {}
    for name, kw in (("plain", dict(remat=False)),
                     ("full", dict(remat=True)),
                     ("dots", dict(remat=True, remat_policy="dots"))):
        c = dataclasses.replace(tc, **kw)
        out[name] = value_and_grad(lambda p: T.loss_fn(p, toks, toks, c), tp)
    for name in ("full", "dots"):
        assert float(out[name][0]) == float(out["plain"][0])
        for a, b in zip(jax.tree.leaves(jax.tree.map(lambda x: x.numpy(),
                                                     out[name][1])),
                        jax.tree.leaves(jax.tree.map(lambda x: x.numpy(),
                                                     out["plain"][1]))):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mixtral-8x7b"])
@pytest.mark.parametrize("n", [16, 48], ids=["within-window", "rolling"])
def test_decode_matches_forward_and_reference(arch, n):
    """Sequential decode of ``n`` tokens against the port's forward at the
    last position (the reference test's 2e-2), and each step's logits
    against the reference's ``decode_step`` (``LOGIT_TOL``).  At 48
    tokens Mixtral-smoke's cache is its 32-slot rolling window."""
    jc, tc, jp, tp = _pair(arch, seed=1, moe_dropless=j_spec(arch).smoke.is_moe)
    toks = _tokens(tc.vocab, (2, n), seed=5)
    jcache = dict(J.init_cache(jc, 2, n), t=jnp.int32(0))
    tcache = T.init_cache(tc, 2, n, device="cpu")
    tcache["t"].fill_(0)
    assert tcache["k"].shape == tuple(jcache["k"].shape)
    step = jax.jit(J.decode_step, static_argnames=("cfg",))
    with torch.no_grad():
        for i in range(n):
            jl, jcache = step(jp, jcache, jnp.asarray(toks[:, i]), jc)
            tl, tcache = T.decode_step(tp, tcache, torch.from_numpy(
                toks[:, i]), tc)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                       rtol=LOGIT_TOL, atol=LOGIT_TOL)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    assert int(tcache["t"]) == int(jcache["t"]) == n
    full = _forward(tc, tp, toks)
    np.testing.assert_allclose(tl.numpy(), full[:, -1], rtol=2e-2, atol=2e-2)

@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "mixtral-8x7b"])
def test_prefill_then_decode_matches_sequential_decode(arch):
    """The port's :func:`prefill` (forward, then the prompt's keys and
    values into their rolling slots) leaves the cache that sequential
    decode leaves: the next step's logits agree."""
    _, tc, _, tp = _pair(arch, seed=2, moe_dropless=True)
    toks = torch.from_numpy(_tokens(tc.vocab, (2, 48), seed=6))
    with torch.no_grad():
        _, cache = T.prefill(tp, toks[:, :32], tc, 48)
        for i in range(32, 48):
            got, cache = T.decode_step(tp, cache, toks[:, i], tc)
        seq = T.init_cache(tc, 2, 48, device="cpu")
        seq["t"].fill_(0)
        for i in range(48):
            want, seq = T.decode_step(tp, seq, toks[:, i], tc)
    np.testing.assert_array_equal(cache["pos"].numpy(), seq["pos"].numpy())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
