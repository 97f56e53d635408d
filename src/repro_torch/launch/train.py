"""Training launcher: real training on the card (``--device cpu`` for the
plain PyTorch versions on the host). The port of ``repro.launch.train``
without its deprecated ``--codec`` spelling and its ``--dry-run``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --reduced --steps 200 --batch 8 --seq 256 [--local-H 4] \\
      [--exchange compressed:int8] [--device cpu]

--local-H enables the paper's communication-avoiding local-update
rounds (H optimizer steps per parameter sync), with the roofline-driven
default when set to 0. --exchange takes a driver-layer exchange spec
(e.g. ``compressed:int4``) and uses its wire codec for the delta
exchange. As in the reference, the rounds run with no data axis
(``local_updates_round``); the exchange's bytes are modelled over K
shards, K the number of devices the run has (CUDA devices on the card,
1 on the host). K virtual shards on one card are
``optim.local_updates.virtual_round`` (``chip_smoke.py`` phase 10).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import ARCHS, PENDING, get_config
from repro_torch.core.distributed import ExchangeConfig
from repro_torch.data.tokens import TokenStream
from repro_torch.models import build_model
from repro_torch.optim import (AdamWConfig, LocalUpdatesConfig, adamw_init,
                               delta_wire_bytes, local_updates_round,
                               suggest_H)
from repro_torch.train import batch_to, make_train_step
from repro_torch.utils.device import full_f32_matmul, resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", choices=list(ARCHS + PENDING),
                    default="tinyllama-1.1b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--local-H", type=int, default=None,
                    help="local steps per sync (paper's knob); 0=auto")
    ap.add_argument("--exchange", default=None, metavar="SPEC",
                    help="driver-layer exchange spec (e.g. "
                         "'compressed:int8'); its wire codec drives the "
                         "delta exchange")
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    full_f32_matmul()
    codec = ("f32" if args.exchange is None
             else ExchangeConfig.parse(args.exchange).scheme.codec.name)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = model.init(gen)
    opt_cfg = AdamWConfig(lr=args.lr)
    opt = adamw_init(params, opt_cfg)
    ts = TokenStream(cfg.vocab_size, args.seq, args.batch, seed=0)

    H = args.local_H
    if H == 0:
        H = suggest_H(t_compute_per_step=1.0, t_collective_per_sync=0.5)
        print(f"auto-selected local H = {H}")
    if H and H > 1:
        step_local = make_train_step(model, opt_cfg)
        lu_cfg = LocalUpdatesConfig(H=H, codec=codec)
        if codec != "f32":
            K = torch.cuda.device_count() if dev.type == "cuda" else 1
            f32_bytes = delta_wire_bytes(params, LocalUpdatesConfig(H=H), K)
            print(f"delta exchange codec={codec}: "
                  f"~{delta_wire_bytes(params, lu_cfg, K) / 1e6:.2f} MB "
                  f"modelled per sync across {K} shard(s) "
                  f"(vs {f32_bytes / 1e6:.2f} MB f32)")
        n_rounds = args.steps // H
        t0 = time.time()
        for r in range(n_rounds):
            bs = [batch_to(ts.next_batch(), dev) for _ in range(H)]
            batches = {k: torch.stack([b[k] for b in bs]) for k in bs[0]}
            params, opt, ms = local_updates_round(step_local, params, opt,
                                                  batches, lu_cfg)
            print(f"round {r} (H={H}) loss={float(ms['loss'][-1]):.4f} "
                  f"({time.time() - t0:.1f}s)")
    else:
        step = make_train_step(model, opt_cfg)
        t0 = time.time()
        for i in range(args.steps):
            params, opt, m = step(params, opt, batch_to(ts.next_batch(), dev))
            if i % args.log_every == 0 or i == args.steps - 1:
                print(f"step {i:5d} loss={float(m['loss']):.4f} "
                      f"acc={float(m['accuracy']):.3f} "
                      f"gnorm={float(m['grad_norm']):.2f} "
                      f"({time.time() - t0:.1f}s)")
    if args.ckpt:
        save_checkpoint(args.ckpt, {"params": params, "opt": opt},
                        step=args.steps)
        print("saved", args.ckpt)


if __name__ == "__main__":
    main()
