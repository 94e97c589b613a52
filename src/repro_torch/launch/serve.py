"""Batched LM serving loop (prefill + decode with KV cache), port of
``repro/launch/serve.py``.

Runs a smoke-scale model end to end, on CUDA unless ``--device cpu`` is
given:

  python -m repro_torch.launch.serve --arch mixtral-8x7b --batch 4 \\
      --new-tokens 32 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_spec
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T


@torch.no_grad()
def generate(cfg, params, prompts, new_tokens: int, temperature: float = 0.0,
             *, device=None, gen: torch.Generator | None = None):
    """prompts: int32[B, S0] -> int32[B, S0 + new_tokens], on ``device``
    (``None`` = CUDA; ``params`` must lie there).

    The prompt is prefilled by sequential decode, as in the reference; the
    new tokens are greedy (``temperature == 0``) or drawn from
    ``softmax(logits / temperature)`` with ``gen`` (default: a generator
    on ``device`` seeded with 0)."""
    dev = resolve_device(device)
    prompts = prompts.to(dev)
    b, s0 = prompts.shape
    cache = T.init_cache(cfg, b, s0 + new_tokens, device=dev)
    cache["t"].fill_(0)
    logits = None
    for i in range(s0):
        logits, cache = T.decode_step(params, cache, prompts[:, i], cfg)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(0)
    out = [prompts]
    tok = None
    for _ in range(new_tokens):
        if tok is not None:
            logits, cache = T.decode_step(params, cache, tok, cfg)
        if temperature > 0:
            tok = torch.multinomial(torch.softmax(logits / temperature, -1),
                                    1, generator=gen)[:, 0]
        else:
            tok = torch.argmax(logits, dim=-1)
        tok = tok.to(torch.int32)
        out.append(tok[:, None])
    return torch.cat(out, dim=1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_spec(args.arch).smoke
    gen = torch.Generator(device=dev).manual_seed(0)
    params = T.init_params(gen, cfg, device=dev)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=dev, dtype=torch.int32)
    t0 = time.perf_counter()
    out = generate(cfg, params, prompts, args.new_tokens, args.temperature,
                   device=dev)
    if out.is_cuda:
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = args.batch * (args.prompt_len + args.new_tokens)
    print(f"generated {tuple(out.shape)} in {dt:.2f}s ({toks / dt:.1f} tok/s "
          f"on {dev})")
    print("sample:", out[0, :24].tolist())
    return out


if __name__ == "__main__":
    main()
