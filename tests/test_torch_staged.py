"""The staged GSP-Louvain loop (``louvain_staged``, the paper's Figure 5
phase and pass times) of the PyTorch port, held against the JAX package's
``louvain_staged`` on the CPU: labels and integer stats exactly, and the
timing keys.  The staged reference divides ``tau`` and makes the shrink
test in float64 on the host, where ``louvain_impl`` uses float32; the
port mirrors each.
"""
import pytest
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)
from test_torch_detect import GRAPHS, _eq, _port

import repro.core as jcore
import repro_torch.core as tcore

PHASES = {"local_move", "split", "aggregate", "other"}
INT_STATS = ("passes", "li_last", "li_total", "split_moved", "n_communities")


@pytest.mark.parametrize("split", ["sp-pj", "refine", "sl-lpp", "none"])
@pytest.mark.parametrize("family", sorted(GRAPHS))
def test_louvain_staged_equals_reference(family, split):
    gj = GRAPHS[family]()
    Cj, sj = jcore.louvain_staged(gj, jcore.LouvainConfig(split=split),
                                  seg_impl="xla")
    Ct, st = tcore.louvain_staged(_port(gj), tcore.LouvainConfig(split=split),
                                  device="cpu")
    _eq(Ct, Cj, f"{family} {split} staged labels")
    assert {k: st[k] for k in INT_STATS} == {k: int(sj[k]) for k in INT_STATS}
    assert set(st["phase_seconds"]) == set(sj["phase_seconds"]) == PHASES
    assert all(v >= 0.0 for v in st["phase_seconds"].values())
    assert len(st["pass_seconds"]) == st["passes"] == len(sj["pass_seconds"])


def test_louvain_staged_labels_equal_louvain_on_the_families():
    """On these graphs float64 and float32 host arithmetic agree, so the
    staged labels are ``louvain``'s."""
    for family, make in sorted(GRAPHS.items()):
        g = _port(make())
        Cs, ss = tcore.louvain_staged(g, device="cpu")
        Cl, sl = tcore.louvain(g, device="cpu")
        _eq(Cs, Cl.numpy(), f"{family} staged vs louvain")
        assert {k: ss[k] for k in INT_STATS} == sl
