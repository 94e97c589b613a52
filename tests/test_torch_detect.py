"""GSP-Louvain phases and detect() of the PyTorch port held against the JAX
package, on the CPU.

Labels, memberships, community weights and integer stats are compared
exactly.  Modularity is compared within 1e-6 absolute: 2m and its last
step are flat float32 sums, which the port folds in one fixed order
(``ops.sum_inorder``) and XLA in another (every segment sum before them
folds in index order in both packages).
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
import repro.core as jcore
import repro.graph as rg
import repro_torch.core as tcore
from repro.core import _segments as jseg
from repro.core.local_move import _half_sweep as j_half_sweep
from repro.core.local_move import local_move as j_local_move
from repro.core.aggregate import aggregate as j_aggregate
from repro.core.detect import disconnected_communities as j_disconnected
from repro.core.modularity import modularity as j_modularity
from repro.core.split import split_labels as j_split
from repro_torch.core.local_move import _half_sweep as t_half_sweep
from repro_torch.core.local_move import local_move as t_local_move
from repro_torch.core import _segments as tseg
from repro_torch.core.aggregate import aggregate as t_aggregate
from repro_torch.core.detect import disconnected_communities as t_disconnected
from repro_torch.core.modularity import modularity as t_modularity
from repro_torch.core.split import split_labels as t_split
from repro_torch.graph import graph_from_arrays

ROOT = Path(__file__).resolve().parents[1]
Q_ATOL = 1e-6   # flat float32 sum in another order (see module docstring)

GRAPHS = {
    "sbm": lambda: rg.sbm_graph(n_nodes=96, n_blocks=5, p_in=0.4,
                                p_out=0.02, seed=2)[0],
    "rmat": lambda: rg.rmat_graph(scale=9, edge_factor=8, seed=11),
    "ring_of_cliques": lambda: rg.ring_of_cliques(12, 5),
    "bridge": lambda: rg.bridge_graph()[0],
    "grid": lambda: rg.grid_graph(10, 10),
    "random_regular": lambda: rg.random_regular_graph(128, 6, seed=0),
}


def _port(gj):
    return graph_from_arrays(np.asarray(gj.src), np.asarray(gj.dst),
                             np.asarray(gj.w), int(gj.n_nodes), gj.n_cap,
                             device="cpu")


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


def _eq(a, b, what):
    np.testing.assert_array_equal(
        a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a),
        np.asarray(b), err_msg=f"{what} diverged")


def _sweep_inputs(seed=5):
    """The inputs of tests/test_seg_backend.py's fused-sweep parity test."""
    g = rg.rmat_graph(scale=8, edge_factor=6, seed=4)
    nv = g.nv
    rng = np.random.default_rng(seed)
    C = rng.integers(0, nv - 1, nv).astype(np.int32)
    C[nv - 1] = nv - 1
    K = np.asarray(jax.ops.segment_sum(g.w, g.src, num_segments=nv))
    Sigma = np.asarray(jax.ops.segment_sum(jnp.asarray(K), jnp.asarray(C),
                                           num_segments=nv))
    movable = rng.random(nv) < 0.5
    target_ok = rng.random(nv) < 0.5
    return g, C, K, Sigma, movable, target_ok


@pytest.mark.parametrize("target,anchored", [(True, True), (False, True),
                                             (False, False)])
def test_half_sweep_bitwise_equals_reference(target, anchored):
    g, C, K, Sigma, movable, target_ok = _sweep_inputs()
    two_m = jnp.sum(g.w)
    jt = jnp.asarray(target_ok) if target else None
    want = j_half_sweep(g.src, g.dst, g.w, jnp.asarray(C), jnp.asarray(K),
                        jnp.asarray(Sigma), two_m, jnp.ones(g.nv, bool),
                        jnp.asarray(movable), None, target_ok=jt,
                        anchored=anchored, seg_impl="xla")
    tg = _port(g)
    got = t_half_sweep(tg.src, tg.dst, tg.w, _t(C), _t(K), _t(Sigma),
                       tg.total_weight_2m(), _t(movable),
                       target_ok=_t(target_ok) if target else None,
                       anchored=anchored)
    for name, a, b in zip(("C", "Sigma", "moved", "gain", "want"), got, want):
        if name == "gain":   # a flat float32 sum: order-dependent last bits
            assert abs(float(a) - float(b)) <= 1e-6 * max(1.0, abs(float(b)))
        else:
            _eq(a, b, name)


@pytest.mark.parametrize("sync", ["handshake", "parity", "all"])
def test_local_move_equals_reference(sync):
    gj = GRAPHS["rmat"]()
    tg = _port(gj)
    K = jax.ops.segment_sum(gj.w, gj.src, num_segments=gj.nv)
    C0 = jnp.arange(gj.nv, dtype=jnp.int32)
    Cj, Sj, lij = j_local_move(gj.src, gj.dst, gj.w, C0, K, K,
                                jnp.sum(gj.w), tau=jnp.float32(1e-2),
                                sync=sync, seg_impl="xla")
    Kt = tg.vertex_weights()
    Ct, St, lit = t_local_move(tg.src, tg.dst, tg.w, _t(C0), Kt, Kt,
                                tg.total_weight_2m(), tau=np.float32(1e-2),
                                sync=sync)
    _eq(Kt, K, "K")
    _eq(Ct, Cj, "C")
    _eq(St, Sj, "Sigma")
    assert lit == int(lij)


def _louvain_membership(gj):
    C, _ = jcore.louvain(gj, jcore.LouvainConfig(max_passes=1, split="none"))
    return np.asarray(C)


@pytest.mark.parametrize("mode", ["pj", "lp", "lpp"])
def test_split_labels_equal(mode):
    gj = GRAPHS["rmat"]()
    C = _louvain_membership(gj)
    Lj, itj = j_split(gj.src, gj.dst, gj.w, jnp.asarray(C), mode=mode,
                      seg_impl="xla")
    tg = _port(gj)
    Lt, itt = t_split(tg.src, tg.dst, tg.w, _t(C), mode=mode)
    _eq(Lt, Lj, f"labels ({mode})")
    assert itt == int(itj)


def test_aggregate_equal():
    gj = GRAPHS["sbm"]()
    C = _louvain_membership(gj)
    nv = gj.nv
    valid = np.arange(nv) < int(gj.n_nodes)
    Cd_j, _ = jseg.renumber(jnp.asarray(C), jnp.asarray(valid), nv)
    Cd_t, _ = tseg.renumber(_t(C), _t(valid), nv)
    _eq(Cd_t, Cd_j, "dense labels")
    want = j_aggregate(gj.src, gj.dst, gj.w, Cd_j, seg_impl="xla")
    tg = _port(gj)
    got = t_aggregate(tg.src, tg.dst, tg.w, Cd_t)
    for name, a, b in zip(("src", "dst", "w"), got, want):
        _eq(a, b, f"super-edge {name}")


@pytest.mark.parametrize("family", ["rmat", "bridge"])
def test_modularity_equal(family):
    gj = GRAPHS[family]()
    C = _louvain_membership(gj)
    qj = float(j_modularity(gj.src, gj.dst, gj.w, jnp.asarray(C),
                            seg_impl="xla"))
    tg = _port(gj)
    qt = t_modularity(tg.src, tg.dst, tg.w, _t(C))
    assert qt.dtype == torch.float32
    assert abs(float(qt) - qj) <= Q_ATOL


def test_disconnected_communities_equal_on_split_needing_partition():
    """A membership with internally-disconnected communities (two far
    ends of the grid share ids) is flagged identically."""
    gj = rg.grid_graph(8, 8)
    nv = gj.nv
    C = (np.arange(nv) % 5).astype(np.int32)   # stripes: disconnected
    C[nv - 1] = nv - 1
    want = j_disconnected(gj.src, gj.dst, gj.w, jnp.asarray(C), gj.n_nodes,
                          seg_impl="xla")
    tg = _port(gj)
    got = t_disconnected(tg.src, tg.dst, tg.w, _t(C), tg.n_nodes)
    assert int(got["n_disconnected"]) == int(want["n_disconnected"]) > 0
    for k in ("disconnected", "n_communities"):
        _eq(got[k], want[k], k)
    assert float(got["fraction"]) == float(want["fraction"])


@pytest.mark.parametrize("family", sorted(GRAPHS))
def test_detect_labels_equal_reference(family):
    """detect() equals the direct counterpart (scan='sort') and the default
    reference detect(), which may take the bit-equivalent dense twin."""
    gj = GRAPHS[family]()
    res = tcore.detect(_port(gj), device="cpu")
    for opts in (jcore.DetectOptions(scan="sort"), None):
        ref = jcore.detect(gj, options=opts)
        _eq(res.labels, ref.labels, f"{family} labels (options={opts})")
        assert res.n_disconnected == int(ref.n_disconnected) == 0
        assert res.n_communities == int(ref.n_communities)
        assert abs(res.modularity - float(ref.modularity)) <= Q_ATOL
        assert res.stats == {k: int(v) for k, v in ref.stats.items()}
    assert res.contract == tcore.contract_for("standard")
    assert res.contract.zero_disconnected


@pytest.mark.parametrize("make", [
    lambda: rg.rmat_graph(scale=8, edge_factor=6, seed=2, n_cap=300,
                          m_cap=4000),
    lambda: rg.from_coo(5, np.array([], np.int32), np.array([], np.int32),
                        n_cap=8, m_cap=10),
], ids=["padded_rmat", "edgeless"])
def test_detect_padded_graphs_equal_reference(make):
    """The port strips the ghost padding the reference keeps for static
    shapes; labels and stats must not notice."""
    gj = make()
    res = tcore.detect(_port(gj), device="cpu")
    ref = jcore.detect(gj, options=jcore.DetectOptions(scan="sort"))
    _eq(res.labels, ref.labels, "labels")
    assert res.stats == {k: int(v) for k, v in ref.stats.items()}
    assert res.n_disconnected == int(ref.n_disconnected) == 0


@pytest.mark.parametrize("split", ["none", "sp-lp", "sp-lpp"])
def test_louvain_split_modes_equal(split):
    gj = GRAPHS["rmat"]()
    cfg_j = jcore.LouvainConfig(split=split)
    Cj, sj = jcore.louvain(gj, cfg_j)
    Ct, st = tcore.louvain(_port(gj), tcore.LouvainConfig(split=split),
                           device="cpu")
    _eq(Ct, Cj, f"labels ({split})")
    assert st == {k: int(v) for k, v in sj.items()}


def test_unported_options_raise():
    """Every option of the reference's detect() that the port has runs:
    the dense scan gives the sort scan's result, every tier and split
    policy runs, and unknown names raise ValueError."""
    g = _port(GRAPHS["grid"]())
    dense, sort = (tcore.detect(g, options=tcore.DetectOptions(scan=scan),
                                device="cpu") for scan in ("dense", "sort"))
    assert torch.equal(dense.labels, sort.labels)
    assert dense.stats == sort.stats and dense.modularity == sort.modularity
    with pytest.raises(ValueError):
        tcore.DetectOptions(scan="hash")
    with pytest.raises(ValueError):
        tcore.DetectOptions(algorithm="best")
    with pytest.raises(ValueError):
        tcore.louvain(g, tcore.LouvainConfig(split="sp-bfs"), device="cpu")
    for algorithm in tcore.ALGORITHMS:
        res = tcore.detect(g, options=tcore.DetectOptions(
            algorithm=algorithm), device="cpu")
        assert res.n_communities > 1


def test_phase_seconds_collects_every_phase():
    phases = {}
    res = tcore.detect(_port(GRAPHS["grid"]()), device="cpu",
                       phase_seconds=phases)
    assert res.n_disconnected == 0
    assert set(phases) == {"local_move", "split", "aggregate", "other",
                           "detector", "modularity"}
    assert all(v >= 0.0 for v in phases.values())


def test_entry_points_raise_without_cuda(monkeypatch):
    """No device given means CUDA; without it the entry point raises
    instead of running on the CPU."""
    g = _port(GRAPHS["grid"]())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.detect(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.louvain(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.louvain_staged(g)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcore.lpa(g)
    # the model scaffold's entry points (ROADMAP A.14a)
    from repro_torch.configs import get_spec
    from repro_torch.graph.sampler import neighbor_sample
    from repro_torch.launch.serve import generate
    from repro_torch.launch.train import train_lm
    from repro_torch.models import transformer as T

    cfg = get_spec("tinyllama-1.1b").smoke
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_lm(cfg, 1, 2, 16, None, False)
    params = T.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        generate(cfg, params, torch.zeros((1, 4), dtype=torch.int32), 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        neighbor_sample(torch.Generator(), torch.arange(2), g.row_offsets(),
                        g.dst, (2,))


def test_port_imports_neither_jax_nor_repro():
    """Every repro_torch module (the CLI ``launch.serve_communities``
    among them, the optimiser, the models, the configs, the LM
    trainers and server, the sharding rules, the step builder, the dry
    run and the roofline, and the engine's tile: ``stack_graphs``, the
    union, ``run_detection_tile``, ``louvain_tile``, ``local_move_tile``
    and the per-graph ``sum_inorder``) and the nine
    ``examples/torch_*.py`` import with jax made unimportable, and no
    module of the JAX package gets loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None\n"
        "       and (m == 'repro' or m.startswith(('repro.', 'jax')))]\n"
        "assert not bad, bad\n"
        "for n in ('lpa', 'dynamic'):\n"
        "    assert 'repro_torch.core.' + n in names, names\n"
        "for n in ('buckets', 'engine', 'store', 'admission', 'metrics',\n"
        "          'frontend', 'service', 'replay'):\n"
        "    assert 'repro_torch.service.' + n in names, names\n"
        "assert 'repro_torch.data.streams' in names, names\n"
        "for n in ('core.distributed', 'graph.partition',\n"
        "          'distributed.collectives', 'launch.mesh'):\n"
        "    assert 'repro_torch.' + n in names, names\n"
        "from repro_torch.service import (AsyncCommunityService,\n"
        "    CommunityService, ServiceConfig, ServiceFrontend)\n"
        "for n in ('histogram', 'spans', 'sinks', 'prometheus'):\n"
        "    assert 'repro_torch.telemetry.' + n in names, names\n"
        "assert 'repro_torch.launch.serve_communities' in names, names\n"
        "for n in ('optim', 'optim.adamw', 'optim.compress',\n"
        "          'optim.schedules', 'models', 'models.transformer',\n"
        "          'models.gnn', 'models.gnn.nequip', 'models.recsys',\n"
        "          'models.recsys.bst', 'configs', 'configs.base',\n"
        "          'configs.tinyllama_1_1b', 'configs.louvain',\n"
        "          'graph.sampler', 'launch.train', 'launch.serve'):\n"
        "    assert 'repro_torch.' + n in names, names\n"
        "for n in ('distributed.sharding', 'distributed.dtensor_rules',\n"
        "          'launch.steps', 'launch.dryrun', 'roofline',\n"
        "          'roofline.hw', 'roofline.analyze'):\n"
        "    assert 'repro_torch.' + n in names, names\n"
        "from repro_torch.configs import ARCH_IDS, get_spec\n"
        "for a in ARCH_IDS:\n"
        "    get_spec(a)\n"
        "from repro_torch.graph.container import (GraphUnion,\n"
        "    stack_graphs, union_of)\n"
        "from repro_torch.core.portfolio import (run_detection_tile,\n"
        "    tile_route)\n"
        "from repro_torch.core.louvain import louvain_tile\n"
        "from repro_torch.core.local_move import local_move_tile\n"
        "from repro_torch.kernels.ops import sum_inorder_per_graph\n"
        "import importlib.util, pathlib\n"
        f"ex = pathlib.Path({str(ROOT / 'examples')!r})\n"
        "paths = sorted(ex.glob('torch_*.py'))\n"
        "assert len(paths) == 9, paths\n"
        "for p in paths:\n"
        "    spec = importlib.util.spec_from_file_location(p.stem, p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m, mod in sys.modules.items() if mod is not None\n"
        "       and (m == 'repro' or m.startswith(('repro.', 'jax')))]\n"
        "assert not bad, bad\n"
        "assert len(names) >= 30, names\n"
        "print(len(names))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
