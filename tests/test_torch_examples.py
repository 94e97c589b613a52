"""The port's examples (``examples/torch_*.py``: the six community
examples, LM training and serving, and the community pipeline) run on the
CPU with ``--device cpu`` and pass their own assertions; each is the
reference example's walk-through (same steps, sizes and asserts) on the
port, LM training cut to 40 steps here (``ARGS``)."""
import importlib.util
from pathlib import Path

import pytest
from _torch_threads import one_torch_thread  # noqa: F401  (autouse)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
NAMES = ("torch_quickstart", "torch_community_service",
         "torch_dynamic_updates", "torch_telemetry_sinks",
         "torch_community_timeline", "torch_chaos_replay",
         "torch_train_lm", "torch_serve_lm", "torch_community_pipeline")
ARGS = {"torch_train_lm": ["--steps", "40"]}   # 300 by default


def load(name):
    spec = importlib.util.spec_from_file_location(name,
                                                  EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", NAMES)
def test_example_runs_on_the_cpu(name, capsys):
    load(name).main(["--device", "cpu", *ARGS.get(name, [])])
    out = capsys.readouterr().out
    assert out.strip()
    if name == "torch_quickstart":       # the paper's result, in print
        gsp = out.split("GSP-Louvain (split-pass):")[1]
        assert "disconnected            0" in gsp
    if name == "torch_community_pipeline":
        assert "(disconnected: 0)" in out


def test_examples_default_to_the_card(monkeypatch):
    """Without ``--device`` an example asks for CUDA and raises where
    there is none, rather than run on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError)):
        load("torch_quickstart").main([])
