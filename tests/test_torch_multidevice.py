"""The port's approximate multi-device harness (``core/distributed.py``:
``community_pass``, ``build_community_step``, ``run_louvain_multidevice``)
on 2- and 4-rank CPU meshes over gloo.

* ``build_community_step``'s outputs (labels, community count, ``l_i``
  and the stacked ``[S, m_shard]`` super-edges) equal the reference's
  ``shard_map`` step on the same shard arrays, array for array.  The
  reference runs in one JAX subprocess with four forced host devices, as
  ``tests/test_torch_sharded.py`` runs it.
* ``run_louvain_multidevice``'s labels equal the reference's step composed
  with the reference's ``louvain`` on the super-graph gathered in numpy,
  which is what the reference's ``run_louvain_multidevice`` computes where
  jax does not raise (ROADMAP C.4: on jax 0.9 its host gather raises
  ``ShardingTypeError``).  The harness is approximate: the test prints
  C.4's two quantities for the port and asserts what the port gives, never
  the single-device partition.
"""
import os
import subprocess
import sys
import tempfile
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_detect import _port

import repro.core as jcore
import repro.graph as rg
from repro.graph.container import Graph as JGraph
import repro_torch.core as tcore
from repro_torch.core import LouvainConfig
from repro_torch.core.detect import disconnected_communities
from repro_torch.core.distributed import (build_community_step,
                                          run_louvain_multidevice)
from repro_torch.core.modularity import modularity
from repro_torch.graph.container import strip_padding
from repro_torch.graph.partition import partition_edges_by_src
from repro_torch.launch import make_host_mesh

ROOT = Path(__file__).resolve().parents[1]
OUT_KEYS = ("C", "n_comms", "li", "nsrc", "ndst", "nw")

GRAPHS = {
    "grid": lambda: rg.grid_graph(16, 16),
    # the graph of the reference's failing test (ROADMAP C.4)
    "sbm_c4": lambda: rg.sbm_graph(n_nodes=240, n_blocks=6, p_in=0.4,
                                   p_out=0.01, seed=0)[0],
}
# (move_iters, split_iters): build_community_step's defaults, and what
# run_louvain_multidevice passes with the default LouvainConfig
SETTINGS = {"defaults": (4, 8), "harness": (20, 0)}

_REFERENCE_STEP = """
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh
import repro.graph as rg
from repro.core.distributed import build_community_step
from repro.graph.partition import partition_edges_by_src

assert len(jax.devices()) == 4
graphs = {GRAPHS}
settings = {SETTINGS}
out = {{}}
for name, make in graphs.items():
    g = make()
    for S in (2, 4):
        mesh = Mesh(np.array(jax.devices()[:S]), ("data",))
        parts = partition_edges_by_src(g, S)
        for sname, (move_iters, split_iters) in settings.items():
            plan = build_community_step(
                mesh, n_cap=g.n_cap, m_shard=parts["src"].shape[1],
                move_iters=move_iters, split_iters=split_iters)
            fn = jax.jit(plan["fn"], in_shardings=plan["in_shardings"],
                         out_shardings=plan["out_shardings"])
            res = fn(*(jnp.asarray(parts[k])
                       for k in ("src", "dst", "w", "v_lo", "v_hi")),
                     jnp.float32(g.total_weight_2m()),
                     g.n_nodes.astype(jnp.int32))
            for k, v in zip({KEYS}, res):
                out[f"{{name}}/{{S}}/{{sname}}/{{k}}"] = np.asarray(v)
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def meshes():
    ms = {n: make_host_mesh(n, device="cpu") for n in (2, 4)}
    yield ms
    for m in ms.values():
        m.close()


@pytest.fixture(scope="module")
def reference_steps():
    """The reference's step outputs for every graph, shard count and
    setting, from one JAX subprocess with four host devices."""
    code = _REFERENCE_STEP.format(
        GRAPHS='{"grid": lambda: rg.grid_graph(16, 16), '
               '"sbm_c4": lambda: rg.sbm_graph(n_nodes=240, n_blocks=6, '
               'p_in=0.4, p_out=0.01, seed=0)[0]}',
        SETTINGS=repr(SETTINGS), KEYS=repr(OUT_KEYS))
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "steps.npz")
        proc = subprocess.run([sys.executable, "-c", textwrap.dedent(code),
                               path], env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr[-4000:]
        with np.load(path) as f:
            return {k: f[k] for k in f.files}


def _port_step(g, mesh, settings):
    parts = partition_edges_by_src(g, mesh.size)
    move_iters, split_iters = SETTINGS[settings]
    plan = build_community_step(mesh, n_cap=g.n_cap,
                                m_shard=parts["src"].shape[1],
                                move_iters=move_iters,
                                split_iters=split_iters)
    assert plan["nv"] == g.nv and plan["n_shards"] == mesh.size
    return plan["fn"](*(torch.from_numpy(parts[k]) for k in
                        ("src", "dst", "w", "v_lo", "v_hi")),
                      g.total_weight_2m(), int(g.n_nodes))


@pytest.mark.parametrize("settings", sorted(SETTINGS))
@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_community_step_equals_reference(meshes, reference_steps, graph,
                                         n_shards, settings):
    g = _port(GRAPHS[graph]())
    mesh = meshes[n_shards]
    mesh.reports.clear()
    got = _port_step(g, mesh, settings)
    for k, a in zip(OUT_KEYS, got):
        want = reference_steps[f"{graph}/{n_shards}/{settings}/{k}"]
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        assert a.shape == want.shape, k
        assert a.tobytes() == want.astype(a.dtype).tobytes(), f"{k} differs"
    # the super-edges keep the weight: shard-local aggregation drops none
    assert float(got[5].double().sum()) == float(g.w.double().sum())
    (reports,) = list(mesh.reports)
    assert [r["rank"] for r in reports] == list(range(n_shards))
    assert all(r["all_reduce_calls"] > 0 for r in reports)


def _composed_reference(gj, steps, n_shards):
    """The reference's step (harness settings) composed with its
    ``louvain`` on the super-graph gathered in numpy: what its
    ``run_louvain_multidevice`` computes (``distributed.py:187-208``)."""
    pre = f"{n_shards}/harness"
    C1 = steps[f"{pre}/C"]
    flat = [steps[f"{pre}/{k}"].reshape(-1) for k in ("nsrc", "ndst", "nw")]
    order = np.argsort(flat[0], kind="stable")
    g2 = JGraph(src=jnp.asarray(flat[0][order]),
                dst=jnp.asarray(flat[1][order]),
                w=jnp.asarray(flat[2][order]),
                n_nodes=jnp.int32(int(steps[f"{pre}/n_comms"])),
                n_cap=gj.n_cap, m_cap=flat[0].shape[0])
    C2, stats = jcore.louvain(g2, jcore.LouvainConfig())
    return np.asarray(C2)[C1], stats


@pytest.mark.parametrize("n_shards", [2, 4])
@pytest.mark.parametrize("graph", sorted(GRAPHS))
def test_run_louvain_multidevice_equals_composed_reference(
        meshes, reference_steps, graph, n_shards):
    gj = GRAPHS[graph]()
    g = _port(gj)
    steps = {k.split("/", 1)[1]: v for k, v in reference_steps.items()
             if k.startswith(graph + "/")}
    want, jstats = _composed_reference(gj, steps, n_shards)
    C, stats = run_louvain_multidevice(g, meshes[n_shards])
    np.testing.assert_array_equal(C.numpy(), want)
    assert stats["first_pass_li"] == int(steps[f"{n_shards}/harness/li"])
    assert stats["first_pass_comms"] == int(
        steps[f"{n_shards}/harness/n_comms"])
    for k in ("passes", "li_total", "n_communities"):
        assert stats[k] == int(jstats[k]), k

    # ROADMAP C.4's two quantities, for the port: the harness is
    # approximate, so they are printed and held to the reference's own
    # detector on the same labels, never to the single-device partition
    live = strip_padding(g.src, g.dst, g.w, g.ghost)
    C1, _ = tcore.louvain(g, LouvainConfig(), device="cpu")
    q1, qd = float(modularity(*live, C1)), float(modularity(*live, C))
    n_dis = int(disconnected_communities(*live, C, g.n_nodes)[
        "n_disconnected"])
    j_dis = int(jcore.disconnected_communities(
        gj.src, gj.dst, gj.w, jnp.asarray(want), gj.n_nodes)[
        "n_disconnected"])
    print(f"C.4 {graph} {n_shards} ranks: |q1 - qd| = {abs(q1 - qd)!r}  "
          f"n_disconnected = {n_dis}  communities = {stats['n_communities']}")
    assert n_dis == j_dis
    assert 0.0 < qd < 1.0


def test_harness_accepts_a_rank_count_and_rejects_wrong_shards(meshes):
    """``mesh`` may be an int (CPU ranks for a CPU graph, as in
    ``louvain_sharded``); shards of another shape raise."""
    g = _port(GRAPHS["grid"]())
    C, _ = run_louvain_multidevice(g, meshes[2])
    C_int, _ = run_louvain_multidevice(g, 2)
    assert torch.equal(C, C_int)
    plan = build_community_step(meshes[2], n_cap=g.n_cap, m_shard=8)
    parts = partition_edges_by_src(g, 2)
    with pytest.raises(ValueError, match=r"shards must be \[2, 8\]"):
        plan["fn"](*(torch.from_numpy(parts[k]) for k in
                     ("src", "dst", "w", "v_lo", "v_hi")),
                   g.total_weight_2m(), int(g.n_nodes))
