"""Serving launcher: batched prefill + greedy decode on the card
(``--device cpu`` for the host). The port of ``repro.launch.serve``: the
audio arch (whisper-tiny) gets seeded frame embeddings, the vlm one
(qwen2-vl-72b) 8 seeded patch embeddings at the prompt's start, drawn
as the reference's launcher draws them.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch tinyllama-1.1b \\
      --reduced --batch 4 --prompt-len 32 --max-new 16 [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.models import build_model
from repro_torch.serve import greedy_generate
from repro_torch.utils.device import full_f32_matmul, resolve_device


PATCHES = 8     # the reference launcher's patch embeddings a row


def batch_extras(cfg, B: int, rng: np.random.Generator, device) -> dict:
    """The reference launcher's inputs beyond the tokens, drawn from
    ``rng`` after the prompts in its order: whisper's frame embeddings
    (B, source_len, d_model) x 0.02 in bf16; a vlm's ``PATCHES`` patch
    embeddings x 0.02 in bf16 at zero (t, h, w) positions."""
    extras = {}
    if cfg.family == "audio":
        extras["frame_embeds"] = torch.tensor(
            rng.standard_normal((B, cfg.encdec.source_len, cfg.d_model))
            * 0.02).to(device, torch.bfloat16)
    if cfg.family == "vlm":
        extras["patch_embeds"] = torch.tensor(
            rng.standard_normal((B, PATCHES, cfg.d_model)) * 0.02).to(
                device, torch.bfloat16)
        extras["patch_positions"] = torch.zeros(
            (B, PATCHES, 3), dtype=torch.int32, device=device)
    return extras


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=list(ARCHS),
                    default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    full_f32_matmul()
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    prompts = torch.tensor(rng.integers(0, min(100, cfg.vocab_size),
                                        (args.batch, args.prompt_len)),
                           dtype=torch.int32, device=dev)
    extras = batch_extras(cfg, args.batch, rng, dev)
    t0 = time.time()
    out = greedy_generate(model, params, prompts, max_new=args.max_new,
                          batch_extras=extras)
    out = out.cpu().numpy()
    dt = time.time() - t0
    print(f"generated {out.shape} in {dt:.2f}s "
          f"({args.batch * args.max_new / dt:.1f} tok/s) on {dev}")
    print(out)


if __name__ == "__main__":
    main()
