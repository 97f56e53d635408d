"""Times the MoE family's serving on the card under three spellings of
silu, for the choice of the MLPs' activation: the experts' and shared
expert's ``layers._MOE_ACTS`` (the sigmoid op by op) beside the dense
MLPs' ``layers._ACTS`` (``torch.sigmoid``), as shipped; ``torch.sigmoid``
in every MLP; the sigmoid op by op in every MLP.
llama4-maverick-400b-a17b at 2 of its 48 layers and deepseek-v3-671b at
5 of its 61, at full width in bf16, B 8 and a prompt of 512 at the
configured capacity factor: a prefill (median of 3, CUDA events around
``Model.prefill``) and a decode step (median of 16 greedy steps). The
spellings are taken in the order A B C C B A. Prints one JSON line per
arch and the card's name and power limit. Run it from the repo root:

  python src/repro_torch/bench/moe_silu.py
"""
import json
import os
import subprocess
import sys

PATHS = (("llama4-maverick-400b-a17b", 2), ("deepseek-v3-671b", 5))
B, S, STEPS, PREFILLS = 8, 512, 16, 3


def main() -> None:
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models import layers as L

    moe_silu, dense_silu = L._MOE_ACTS["silu"], L._ACTS["silu"]
    spellings = {"shipped": (moe_silu, dense_silu),
                 "torch.sigmoid everywhere": (dense_silu, dense_silu),
                 "op by op everywhere": (moe_silu, moe_silu)}
    order = ["shipped", "torch.sigmoid everywhere", "op by op everywhere"]
    order = order + order[::-1]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()[0]
    print(card, flush=True)

    def ms(fn):
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b), out

    for arch, layers in PATHS:
        cfg = dataclasses.replace(get_config(arch), num_layers=layers)
        model = build_model(cfg)
        params = model.init(torch.Generator(device="cuda").manual_seed(0))
        prompts = torch.tensor(np.random.default_rng(0).integers(
            0, cfg.vocab_size, (B, S)), dtype=torch.int32, device="cuda")
        states = model.init_states(params, B, S + STEPS + 1)
        runs = {k: {"prefill_ms": [], "decode_ms": []} for k in spellings}
        with torch.inference_mode():
            for name in order:
                L._MOE_ACTS["silu"], L._ACTS["silu"] = spellings[name]
                pre = []
                for _ in range(PREFILLS + 1):
                    t, (logits, states) = ms(lambda: model.prefill(
                        params, {"tokens": prompts}, states,
                        last_logits_only=True))
                    pre.append(t)
                tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
                dec = []
                for i in range(STEPS):
                    pos = torch.full((B, 1), S + i, dtype=torch.int32,
                                     device="cuda")
                    t, (logits, states) = ms(lambda: model.decode_step(
                        params, {"tokens": tok, "positions": pos}, states))
                    tok = logits[:, -1].argmax(-1).to(torch.int32)[:, None]
                    dec.append(t)
                runs[name]["prefill_ms"].append(float(np.median(pre[1:])))
                runs[name]["decode_ms"].append(float(np.median(dec[1:])))
        L._MOE_ACTS["silu"], L._ACTS["silu"] = moe_silu, dense_silu
        print(json.dumps({"arch": arch, "layers": layers, "card": card,
                          "batch": B, "prompt": S, "order": order,
                          "runs": runs}), flush=True)
        del params, states, logits
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
