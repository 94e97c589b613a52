"""The port's BST (``repro_torch.models.recsys``) against the JAX package
on the CPU: ``embedding_bag`` against its oracle and the reference, the
forward, loss and gradients on the reference's parameters and batch, and
retrieval against forward (the reference's ``tests/test_recsys.py``).

Tolerances, float32: logits and loss within ``OUT_TOL`` (rtol = atol),
gradients within ``GRAD_RTOL``/``GRAD_ATOL``; the retrieval check keeps
the reference's 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

import repro.models.recsys as JR
import repro_torch.models.recsys as TR
from repro.configs import get_spec as j_spec
from repro.models.recsys.bst import embedding_bag as j_embedding_bag
from repro_torch.configs import get_spec as t_spec
from repro_torch.launch.train import value_and_grad
from repro_torch.models import params_from_numpy
from repro_torch.models.recsys import embedding_bag

OUT_TOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-7


@pytest.fixture(scope="module")
def setup():
    jc, tc = j_spec("bst").smoke, t_spec("bst").smoke
    jp = JR.init_bst(jax.random.PRNGKey(0), jc)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    rng = np.random.default_rng(0)
    B = 6

    def ints(lo, hi, *shape):
        return rng.integers(lo, hi, shape).astype(np.int32)

    batch = dict(
        user=ints(0, jc.user_vocab, B),
        behavior=ints(0, jc.item_vocab, B, jc.seq_len),
        target=ints(0, jc.item_vocab, B),
        fields=ints(-1, jc.user_field_vocab, B, jc.n_user_fields, 3),
        label=ints(0, 2, B),
    )
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    return jc, tc, jp, tp, jb, tb


def test_config_matches_reference():
    for which in ("smoke", "config"):
        assert getattr(t_spec("bst"), which).__dict__ == \
            getattr(j_spec("bst"), which).__dict__


def test_embedding_bag_oracle():
    rng = np.random.default_rng(0)
    t = rng.normal(size=(20, 4)).astype(np.float32)
    table = torch.from_numpy(t)
    idx = torch.tensor([[0, 3, -1], [5, -1, -1]], dtype=torch.int32)
    out = embedding_bag(table, idx).numpy()
    np.testing.assert_allclose(out[0], t[0] + t[3], rtol=1e-6)
    np.testing.assert_allclose(out[1], t[5], rtol=1e-6)
    mean = embedding_bag(table, idx, mode="mean").numpy()
    np.testing.assert_allclose(mean[0], (t[0] + t[3]) / 2, rtol=1e-6)
    np.testing.assert_allclose(mean[1], t[5], rtol=1e-6)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_reference(mode):
    """Multi-field bags ``[B, F, K]`` with -1 padding, an all-padding bag
    included (it sums to zero); a bag's five float32 rows may be added in
    another order."""
    rng = np.random.default_rng(1)
    t = rng.normal(size=(50, 8)).astype(np.float32)
    idx = rng.integers(-1, 50, (4, 3, 5)).astype(np.int32)
    idx[0, 0] = -1
    got = embedding_bag(torch.from_numpy(t), torch.from_numpy(idx),
                        mode=mode).numpy()
    want = np.asarray(j_embedding_bag(jnp.asarray(t), jnp.asarray(idx),
                                      mode=mode))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert not got[0, 0].any()


def test_forward_loss_and_grads_match_reference(setup):
    jc, tc, jp, tp, jb, tb = setup
    want = np.asarray(JR.bst_forward(jp, jb, jc))
    with torch.no_grad():
        got = TR.bst_forward(tp, tb, tc).numpy()
    assert got.shape == (6,)
    np.testing.assert_allclose(got, want, rtol=OUT_TOL, atol=OUT_TOL)
    jl, jg = jax.jit(jax.value_and_grad(JR.bst_loss),
                     static_argnames=("cfg",))(jp, jb, jc)
    tl, tg = value_and_grad(lambda p: TR.bst_loss(p, tb, tc), tp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=OUT_TOL)
    tleaves = jax.tree.leaves(jax.tree.map(lambda x: x.numpy(), tg))
    jleaves = jax.tree.leaves(jg)
    assert len(tleaves) == len(jleaves)
    for a, b in zip(tleaves, jleaves):
        assert np.isfinite(a).all()
        np.testing.assert_allclose(a, np.asarray(b), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


def test_retrieval_matches_forward_and_reference(setup):
    jc, tc, jp, tp, jb, tb = setup
    cands = torch.arange(10, dtype=torch.int32)
    query = dict(user=tb["user"][0], behavior=tb["behavior"][0],
                 fields=tb["fields"][0])
    with torch.no_grad():
        scores = TR.bst_score_candidates(tp, query, cands, tc)
        # score of candidate c must equal a plain forward with target=c
        for c in [0, 5, 9]:
            b1 = dict(user=tb["user"][:1], behavior=tb["behavior"][:1],
                      target=torch.tensor([c], dtype=torch.int32),
                      fields=tb["fields"][:1])
            want = TR.bst_forward(tp, b1, tc)[0]
            assert float((scores[c] - want).abs()) < 1e-4
    jq = dict(user=jb["user"][0], behavior=jb["behavior"][0],
              fields=jb["fields"][0])
    jscores = JR.bst_score_candidates(jp, jq, jnp.arange(10, dtype=jnp.int32),
                                      jc)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscores),
                               rtol=OUT_TOL, atol=OUT_TOL)


def test_init_tree_matches_reference():
    jc, tc = j_spec("bst").smoke, t_spec("bst").smoke
    jp = JR.init_bst(jax.random.PRNGKey(0), jc)
    tp = TR.init_bst(torch.Generator().manual_seed(0), tc)
    assert jax.tree.structure(jax.tree.map(lambda x: 0, jp)) == \
        jax.tree.structure(jax.tree.map(lambda x: 0, tp))
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(jp)):
        assert tuple(a.shape) == tuple(b.shape) and a.dtype == torch.float32

