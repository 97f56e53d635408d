"""Times tinyllama-1.1b on the card with the ``repro_torch`` of another
checkout, for comparing two trees in one call: a bf16 train step at
full width (remat, batch 4 x 512, 2 warm-up steps, 6 timed) and 33
greedy tokens at B 8 after a prompt of 512. Prints one JSON line. Run it
as a file, so that the tree's package is the one imported:

  python src/repro_torch/bench/step_pair.py <checkout>   # e.g. . or a parent

and alternate the trees (parent, change, change, parent).
"""
import json
import os
import sys
import time


def main(tree: str) -> None:
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    sys.path.insert(0, os.path.join(tree, "src"))
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.serve import greedy_generate
    from repro_torch.train import make_train_step
    from repro_torch.utils.device import full_f32_matmul

    full_f32_matmul()
    cfg = get_config("tinyllama-1.1b")
    m = build_model(cfg)
    params = m.init(torch.Generator(device="cuda").manual_seed(0))
    opt_cfg = AdamWConfig(lr=1e-4)
    step = make_train_step(m, opt_cfg, remat=True)
    opt = adamw_init(params, opt_cfg)
    rng = np.random.default_rng(0)
    batch = {k: torch.tensor(rng.integers(0, cfg.vocab_size, (4, 512)),
                             dtype=torch.int32, device="cuda")
             for k in ("tokens", "labels")}
    for _ in range(2):
        params, opt, _ = step(params, opt, batch)
    torch.cuda.synchronize()
    ts = []
    for _ in range(6):
        t0 = time.perf_counter()
        params, opt, _ = step(params, opt, batch)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    del opt
    prompts = torch.tensor(rng.integers(0, cfg.vocab_size, (8, 512)),
                           dtype=torch.int32, device="cuda")
    greedy_generate(m, params, prompts, max_new=4)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    greedy_generate(m, params, prompts, max_new=33)
    torch.cuda.synchronize()
    gen = (time.perf_counter() - t0) * 1e3
    print(json.dumps({"tree": tree, "step_ms": ts,
                      "step_ms_median": float(np.median(ts)),
                      "generate_33_ms": gen}), flush=True)


if __name__ == "__main__":
    main(sys.argv[1])
