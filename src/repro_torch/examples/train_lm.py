"""End-to-end driver: train a ~100M-param LM for a few hundred steps on
the card (``--device cpu`` for the host).

This instantiates tinyllama at ~100M scale (trimmed layers/width, real
vocab), runs the full training substrate (AdamW + cosine schedule +
per-layer remat + checkpointing), and reports the loss curve. It exits
non-zero unless the loss falls.

  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 300]
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.data.tokens import TokenStream
from repro_torch.models import build_model
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import batch_to, make_train_step
from repro_torch.utils.device import full_f32_matmul, resolve_device
from repro_torch.utils.trees import tree_params

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--ckpt", default=os.path.join(ROOT, "build",
                                                   "train_lm_ckpt.npz"))
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    full_f32_matmul()

    # ~100M-param member of the tinyllama family
    cfg = dataclasses.replace(get_config("tinyllama-1.1b"),
                              num_layers=8, d_model=640, num_heads=10,
                              num_kv_heads=2, head_dim=64, d_ff=1792)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    print(f"model: {cfg.name} trimmed to {tree_params(params)/1e6:.1f}M "
          f"params on {dev}")

    opt_cfg = AdamWConfig(lr=6e-4)
    opt = adamw_init(params, opt_cfg)
    step = make_train_step(model, opt_cfg, remat=True)
    ts = TokenStream(cfg.vocab_size, args.seq, args.batch, seed=0)

    t0 = time.time()
    first = None
    for i in range(args.steps):
        params, opt, m = step(params, opt, batch_to(ts.next_batch(), dev))
        if first is None:
            first = float(m["loss"])
        if i % 20 == 0 or i == args.steps - 1:
            toks = (i + 1) * args.batch * args.seq
            print(f"step {i:4d} loss={float(m['loss']):.4f} "
                  f"acc={float(m['accuracy']):.3f} "
                  f"({toks / max(time.time() - t0, 1e-9):.0f} tok/s)")
    save_checkpoint(args.ckpt, {"params": params}, step=args.steps)
    last = float(m["loss"])
    print(f"loss {first:.3f} -> {last:.3f}; checkpoint at {args.ckpt}")
    if not last < first:
        raise SystemExit("train_lm: the loss must decrease")


if __name__ == "__main__":
    main()
