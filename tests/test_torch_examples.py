"""The port's six community examples (``examples/torch_*.py``) run on the
CPU with ``--device cpu`` and pass their own assertions; each is the
reference example's walk-through (same steps, sizes and asserts) on the
port."""
import importlib.util
from pathlib import Path

import pytest
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NAMES = ("torch_quickstart", "torch_community_service",
         "torch_dynamic_updates", "torch_telemetry_sinks",
         "torch_community_timeline", "torch_chaos_replay")


def load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", NAMES)
def test_example_runs_on_the_cpu(name, capsys):
    load(name).main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert out.strip()
    if name == "torch_quickstart":       # the paper's result, in print
        gsp = out.split("GSP-Louvain (split-pass):")[1]
        assert "disconnected            0" in gsp


def test_examples_default_to_the_card(monkeypatch):
    """Without ``--device`` an example asks for CUDA and raises where
    there is none, rather than run on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError)):
        load("torch_quickstart").main([])
