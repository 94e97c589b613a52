"""Scenario: train a language model end to end with the full substrate of
the PyTorch port (config registry -> data stream -> AdamW ->
checkpoint/restore), on the card (``--device cuda``, the default) or the
CPU.

Default is a CPU-friendly ~1M-param TinyLlama-family model for 300 steps on
the Markov token stream; loss falls from ~ln(vocab) toward the ~ln(8)
entropy floor.  ``--preset 100m`` selects a ~100M-param config (same code
path; sized for the card).  Checkpoints go to ``--ckpt-dir`` (default: a
temporary directory removed at the end), and a second run with the same
directory resumes.

  PYTHONPATH=src python examples/torch_train_lm.py --steps 300 [--device cpu]
"""
import argparse
import dataclasses
import tempfile

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_spec
from repro_torch.launch.train import train_lm


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--preset", choices=["smoke", "100m"], default="smoke")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    base = get_spec("tinyllama-1.1b").smoke
    if args.preset == "100m":
        cfg = dataclasses.replace(
            base, n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
            d_head=64, d_ff=2048, vocab=32000, remat=True,
            compute_dtype=torch.bfloat16,
        )
    else:
        cfg = dataclasses.replace(base, vocab=256)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = CheckpointManager(args.ckpt_dir or tmp, keep=2)
        losses = train_lm(cfg, args.steps, args.batch, args.seq_len, ckpt,
                          resume=True, device=args.device)
    if losses:
        print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f} "
              f"(entropy floor ~{2.08:.2f})")
        assert losses[-1] < losses[0], "the loss did not fall"
    return losses


if __name__ == "__main__":
    main()
