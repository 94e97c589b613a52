"""Scenario: batched LM serving with a rolling KV cache, on the PyTorch port.

Generates continuations for a batch of prompts through ``decode_step``
(SWA rolling cache => O(window) memory at any context), on the card
(``--device cuda``, the default) or the CPU.

  PYTHONPATH=src python examples/torch_serve_lm.py --batch 4 \
      --new-tokens 48 [--device cpu]
"""
import argparse

from repro_torch.launch import serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args, rest = ap.parse_known_args(argv)
    return serve.main([*rest, "--device", args.device])


if __name__ == "__main__":
    main()
