"""The port's CLI drivers that need more than one service a run, at smoke
size on the CPU: ``--stream`` (the planted lifecycle script and the
removal-heavy churn stream with its live scrape), ``--sharded`` (two CPU
ranks over gloo, bit for bit the single-device partitions, the halo
counters scraped; the mesh's workers closed after) and ``--chaos`` (the
fault plan against a fault-free run, breaker recovery, kill-and-restore).
Each passes the reference's own smoke assertions.
"""
import pytest
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

import repro_torch.launch.serve_communities as tsc


@pytest.mark.parametrize("mode", ["--stream", "--sharded", "--chaos"])
def test_smoke_modes_pass_on_the_cpu(mode, capsys):
    rep = tsc.main([mode, "--smoke", "--device", "cpu"])
    assert rep is not None
    assert "SMOKE OK" in capsys.readouterr().out


def test_sharded_driver_closes_its_mesh():
    mesh = tsc.sharded_mesh("cpu")
    assert mesh.size == 2 and mesh.backend == "gloo"
    tsc.main(["--sharded", "--device", "cpu"])
    assert not mesh.alive and mesh.pids() == []
