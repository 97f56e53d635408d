"""Serving example: batched prefill + greedy decode across families at
``.reduced()`` — dense (KV cache), SSM (recurrent state), hybrid (ring
buffer + LRU) — on the card (``--device cpu`` for the host).

  PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve import greedy_generate
from repro_torch.utils.device import full_f32_matmul, resolve_device


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    full_f32_matmul()
    for arch in ("tinyllama-1.1b", "mamba2-2.7b", "recurrentgemma-9b"):
        cfg = get_config(arch).reduced()
        model = build_model(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        rng = np.random.default_rng(1)
        prompts = torch.tensor(rng.integers(0, 100, (4, 24)),
                               dtype=torch.int32, device=dev)
        t0 = time.time()
        out = greedy_generate(model, params, prompts, max_new=12).cpu()
        dt = time.time() - t0
        print(f"{arch:22s} generated {out.shape[0]}x{out.shape[1]} tokens "
              f"in {dt:5.1f}s on {dev}; sample: {out[0].numpy()[:8]}")
    print("all three state families (KV cache / SSM state / LRU+ring) "
          "decode OK")


if __name__ == "__main__":
    main()
