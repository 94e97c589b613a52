"""The port's trainers and streams (``repro_torch.launch.train``,
``repro_torch.data``) on the CPU: the train-step smokes of every arch,
``test_lm_training_learns`` with the reference's thresholds, the streams
against the reference's, and a checkpoint that ``train_lm`` writes in one
package and restores in the other, both ways, bit for bit (the reference's
``tests/test_system.py``)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

import repro.checkpoint as jck
import repro.launch.train as JT
import repro.models.transformer as J
import repro.optim as jopt
import repro_torch.checkpoint as tck
import repro_torch.models.transformer as T
from repro.configs import get_spec as j_spec
from repro.data import streams as jstreams
from repro_torch.configs import ARCH_IDS, get_spec
from repro_torch.data import streams as tstreams
from repro_torch.graph import graph_from_arrays
from repro_torch.launch.train import (
    main, train_gnn, train_lm, train_recsys, value_and_grad,
)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update

LM = ["mixtral-8x7b", "mixtral-8x22b", "command-r-35b", "smollm-360m",
      "tinyllama-1.1b"]
GNN = ["gcn-cora", "gat-cora", "gatedgcn", "nequip"]


@pytest.mark.parametrize("arch", LM)
def test_lm_smoke_train_step(arch):
    cfg = get_spec(arch).smoke
    gen = torch.Generator().manual_seed(0)
    params = T.init_params(gen, cfg, device="cpu")
    opt = adamw_init(params)
    toks = torch.randint(0, cfg.vocab, (2, 16), generator=gen)
    loss, g = value_and_grad(lambda p: T.loss_fn(p, toks, toks, cfg), params)
    params, opt, m = adamw_update(params, g, opt, AdamWConfig(lr=1e-3))
    assert np.isfinite(float(loss)) and np.isfinite(float(m["grad_norm"]))
    with torch.no_grad():
        logits = T.forward(params, toks, cfg)
    assert logits.shape == (2, 16, cfg.vocab)
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", GNN)
def test_gnn_smoke_train_step(arch):
    seen = []
    losses = train_gnn(get_spec(arch), steps=3, ckpt=None, resume=False,
                       device="cpu", on_step=lambda i, m: seen.append(m))
    assert len(losses) == 3
    assert all(np.isfinite(l) for l in losses)
    assert [m["loss"] for m in seen] == losses
    assert all(np.isfinite(m["grad_norm"]) for m in seen)


def test_recsys_smoke_train_step():
    losses = train_recsys(get_spec("bst").smoke, steps=3, batch=16,
                          ckpt=None, resume=False, device="cpu")
    assert len(losses) == 3 and all(np.isfinite(l) for l in losses)


def test_louvain_arch_selectable():
    from repro_torch.core import louvain
    from repro_torch.graph import sbm_graph

    spec = get_spec("louvain")
    assert spec.smoke == dataclasses.replace(spec.config, max_passes=3,
                                             max_iters=8)
    g = sbm_graph(80, 4, seed=0, device="cpu")[0]
    C, stats = louvain(g, spec.smoke, device="cpu")
    assert int(stats["n_communities"]) >= 1


def test_all_assigned_archs_have_specs():
    from repro.configs import ARCH_IDS as J_IDS, all_cells as j_cells
    from repro_torch.configs import all_cells

    assert ARCH_IDS == J_IDS
    assert all_cells() == j_cells() and all_cells(True) == j_cells(True)
    for arch in ARCH_IDS:
        spec, jspec = get_spec(arch), j_spec(arch)
        assert spec.shapes == jspec.shapes and spec.shapes, arch
        assert spec.family == jspec.family and spec.smoke is not None
        assert spec.skip_shapes == jspec.skip_shapes
        if spec.family != "lm" and spec.family != "graph":
            assert spec.config.__dict__ == jspec.config.__dict__
            assert spec.smoke.__dict__ == jspec.smoke.__dict__


def test_lm_training_learns():
    """A few hundred steps on the Markov stream beat the unigram bound."""
    cfg = dataclasses.replace(get_spec("tinyllama-1.1b").smoke, vocab=64)
    losses = train_lm(cfg, steps=120, batch=16, seq_len=32, ckpt=None,
                      resume=False, log_every=1000, device="cpu")
    # Markov chain with 8 successors: achievable loss ~ log(8) = 2.08;
    # random vocab-64 baseline is log(64) = 4.16
    assert np.mean(losses[-10:]) < 3.4
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.5


# ---------------------------------------------------------------------------
# the streams
# ---------------------------------------------------------------------------

def test_token_stream_walks_the_reference_chain():
    """The successor table is the reference's (the same numpy draws), so
    every transition of the port's stream is one the reference's chain
    allows, and targets are the tokens shifted by one."""
    vocab = 50
    toks, tgt = next(tstreams.token_stream(vocab, 4, 24, seed=3,
                                           device="cpu"))
    succ = np.random.default_rng(3).integers(0, vocab, size=(vocab, 8))
    jt, _ = next(jstreams.token_stream(vocab, 2, 4, seed=3))
    assert toks.shape == tgt.shape == (4, 24) and toks.dtype == torch.int32
    assert np.asarray(jt).dtype == np.int32
    t, y = toks.numpy(), tgt.numpy()
    np.testing.assert_array_equal(t[:, 1:], y[:, :-1])
    for a, b in zip(t.reshape(-1), y.reshape(-1)):
        assert b in succ[a]


def test_recsys_stream_labels_are_the_reference_hash():
    cfg = get_spec("bst").smoke
    b = next(tstreams.recsys_stream(cfg, 256, seed=1, device="cpu"))
    u = b["user"].numpy().astype(np.uint32)
    t = b["target"].numpy().astype(np.uint32)
    h = u * np.uint32(2654435761) + t * np.uint32(97)
    np.testing.assert_array_equal(b["label"].numpy(),
                                  ((h % 7) < 3).astype(np.int32))
    f = b["fields"].numpy()
    assert f.shape == (256, cfg.n_user_fields, 3)
    assert f.min() >= -1 and f.max() < cfg.user_field_vocab
    # the hash in int64 holds for ids up to int32's top too
    big = torch.tensor([2**31 - 1, 123456789], dtype=torch.int32)
    h64 = ((big.long() * 2654435761 & 0xFFFFFFFF)
           + (big.long() * 97 & 0xFFFFFFFF)) & 0xFFFFFFFF
    hb = (big.numpy().astype(np.uint32) * np.uint32(2654435761)
          + big.numpy().astype(np.uint32) * np.uint32(97))
    np.testing.assert_array_equal(h64.numpy(), hb.astype(np.int64))


def test_gnn_node_labels_match_reference():
    from repro.graph import sbm_graph

    gj = sbm_graph(120, 4, p_in=0.2, p_out=0.01, seed=2)[0]
    g = graph_from_arrays(np.asarray(gj.src), np.asarray(gj.dst),
                          np.asarray(gj.w), int(gj.n_nodes), gj.n_cap,
                          device="cpu")
    np.testing.assert_array_equal(tstreams.gnn_node_labels(g, 5),
                                  jstreams.gnn_node_labels(gj, 5))


# ---------------------------------------------------------------------------
# one checkpoint format, both ways
# ---------------------------------------------------------------------------

CK_CFG = dataclasses.replace(get_spec("tinyllama-1.1b").smoke, vocab=64)
J_CK_CFG = dataclasses.replace(j_spec("tinyllama-1.1b").smoke, vocab=64)


def _np_tree(tree):
    return jax.tree.map(lambda x: x.numpy() if isinstance(x, torch.Tensor)
                        else np.asarray(x), tree)


def _bit_equal(a, b):
    la, lb = jax.tree.leaves(_np_tree(a)), jax.tree.leaves(_np_tree(b))
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _j_like():
    p = J.init_params(jax.random.PRNGKey(0), J_CK_CFG)
    return dict(params=p, opt=jopt.adamw_init(p))


def _t_like():
    p = T.init_params(torch.Generator().manual_seed(0), CK_CFG, device="cpu")
    return dict(params=p, opt=adamw_init(p))


def test_reference_train_lm_checkpoint_restores_in_the_port(tmp_path,
                                                            capsys):
    """``repro.launch.train.train_lm`` writes step 3; the port restores it
    bit for bit, and the port's ``train_lm`` resumes from it."""
    d = str(tmp_path / "ck")
    JT.train_lm(J_CK_CFG, 3, 4, 16, jck.CheckpointManager(d), False,
                log_every=1000)
    want, wstep = jck.restore_checkpoint(d, _j_like())
    got, step = tck.restore_checkpoint(d, _t_like(), device="cpu")
    assert step == wstep == 3
    _bit_equal(got, want)
    assert got["opt"]["step"].dtype == torch.int32
    losses = train_lm(CK_CFG, 5, 4, 16, tck.CheckpointManager(d), True,
                      log_every=1000, device="cpu")
    assert "resumed from step 3" in capsys.readouterr().out
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_port_train_lm_checkpoint_restores_in_the_reference(tmp_path,
                                                            capsys):
    """The port's ``train_lm`` writes step 3; the reference restores it
    bit for bit, and the reference's ``train_lm`` resumes from it."""
    d = str(tmp_path / "ck")
    train_lm(CK_CFG, 3, 4, 16, tck.CheckpointManager(d), False,
             log_every=1000, device="cpu")
    want, wstep = tck.restore_checkpoint(d, _t_like(), device="cpu")
    got, step = jck.restore_checkpoint(d, _j_like())
    assert step == wstep == 3
    _bit_equal(got, want)
    losses = JT.train_lm(J_CK_CFG, 5, 4, 16, jck.CheckpointManager(d), True,
                         log_every=1000)
    assert "resumed from step 3" in capsys.readouterr().out
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_train_lm_rolls_back_a_non_finite_step(tmp_path, monkeypatch,
                                               capsys):
    """A non-finite loss restores the last checkpoint and goes on; with
    no checkpoint it raises."""
    d = str(tmp_path / "ck")
    train_lm(CK_CFG, 2, 4, 16, tck.CheckpointManager(d), False,
             log_every=1000, device="cpu")
    real = T.loss_fn
    calls = []

    def flaky(*a, **k):
        calls.append(1)
        out = real(*a, **k)
        return out * float("nan") if len(calls) == 2 else out

    monkeypatch.setattr(T, "loss_fn", flaky)
    losses = train_lm(CK_CFG, 5, 4, 16, tck.CheckpointManager(d), True,
                      log_every=1000, device="cpu")
    assert "non-finite loss — rolling back" in capsys.readouterr().out
    assert len(losses) == 2 and all(np.isfinite(losses))
    calls.clear()
    with pytest.raises(FloatingPointError):
        train_lm(CK_CFG, 3, 4, 16, None, False, log_every=1000,
                 device="cpu")


def test_main_smoke_cli(capsys):
    """``python -m repro_torch.launch.train --smoke --device cpu``."""
    losses = main(["--arch", "smollm-360m", "--smoke", "--steps", "3",
                   "--batch", "2", "--seq-len", "16", "--device", "cpu"])
    assert len(losses) == 3
    assert "first-10 mean" in capsys.readouterr().out
