"""Roofline of every (arch x shape) pair on the single-pod (16 x 16) mesh
of H100s, from the dry-run's per-device counts. The port of
``repro.launch.roofline``.

Terms (the card's data-sheet figures, ``launch.mesh``)::

    compute    = FLOPs_per_device / 989e12
    memory     = bytes_accessed_per_device / 3.35e12
    collective = collective_operand_bytes_per_device / 450e9

The memory term counts every op's operands and results (no fusion: an
upper bound); ``memory_products_s`` counts the products' alone (a fully
fused step's floor), and ``dominant_fused`` is the dominant term with it
in place of ``memory_s``.

The counts are the dry-run's (``dryrun.run_pair``), the MTP head
included: a decode step and whisper are counted at full depth, a train or
prefill step at one and two layer cycles extrapolated to the full depth
(``depth`` says which). The reference forces dense attention for its L1/L2
runs because XLA's cost analysis counts a flash scan's body once; the
port's counters see every op of the flash kernel's plain version, so it
needs no such switch. ``model_flops`` is the reference's analytic count:
6*N_active*D (train) / 2*N_active*D (inference) plus the attention
scores.

Usage::

  PYTHONPATH=src python -m repro_torch.launch.roofline \
      --arch tinyllama-1.1b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.roofline --all \
      [--out build/roofline]
"""
from __future__ import annotations

import argparse
import json
import os
import traceback

from repro_torch.configs import ARCHS, SHAPES, get_config
from repro_torch.configs.base import padded_vocab
from repro_torch.launch import build
from repro_torch.launch.dryrun import run_pair
from repro_torch.launch.mesh import (HBM_BW, LINK_BW, PEAK_FLOPS_BF16,
                                     kernel_roofline)
from repro_torch.models.transformer import layer_plan


def model_flops(cfg, shape) -> float:
    """Analytic MODEL_FLOPS for the full config + shape (global):
    6*N_active*D (train) / 2*N_active*D (inference) for the parametric
    part, plus the analytic attention-score term (which dominates at
    32k+): 4*S_kv*H*Dh per query token per attention layer (halved for
    causal prefill/train, windowed for SWA)."""
    v = padded_vocab(cfg)
    d = cfg.d_model
    n_embed = v * d * (1 if cfg.tie_embeddings else 2)
    plan = layer_plan(cfg)

    # ---- attention-score FLOPs ----
    B, S = shape.global_batch, shape.seq_len
    mult = 3.0 if shape.kind == "train" else 1.0
    attn_fl = 0.0
    for mixer, _ in plan:
        if mixer == "attn":
            hd = cfg.num_heads * cfg.head_dim
            win = cfg.sliding_window
        elif mixer == "attn_local":
            hd = cfg.num_heads * cfg.head_dim
            win = (cfg.rglru.local_window if cfg.rglru
                   else cfg.sliding_window)
        elif mixer == "mla":
            m = cfg.mla
            hd = cfg.num_heads * (m.qk_nope_dim + m.qk_rope_dim
                                  + m.v_head_dim) / 2.0
            win = None
        else:
            continue
        if shape.kind == "decode":
            kv = min(win, S) if win else S
            attn_fl += mult * B * 1 * 4 * kv * hd
        else:
            kv_eff = (min(win, S) if win else S / 2.0)  # causal half
            attn_fl += mult * B * S * 4 * kv_eff * hd

    n_active = 0
    for mixer, channel in plan:
        if mixer in ("attn", "attn_local"):
            kvd = cfg.num_kv_heads * cfg.head_dim
            n_active += d * cfg.num_heads * cfg.head_dim * 2 + 2 * d * kvd
        elif mixer == "mla":
            m = cfg.mla
            n_active += (d * m.q_lora_rank
                         + m.q_lora_rank * cfg.num_heads
                         * (m.qk_nope_dim + m.qk_rope_dim)
                         + d * (m.kv_lora_rank + m.qk_rope_dim)
                         + m.kv_lora_rank * cfg.num_heads
                         * (m.qk_nope_dim + m.v_head_dim)
                         + cfg.num_heads * m.v_head_dim * d)
        elif mixer == "rglru":
            w = cfg.rglru.lru_width or d
            n_active += 2 * d * w + 2 * w * w + w * d
        elif mixer == "ssd":
            s = cfg.ssm
            din = s.d_inner(d)
            n_active += d * (2 * din + 2 * s.n_groups * s.d_state
                             + s.n_heads(d)) + din * d
        if channel == "mlp":
            n_active += d * cfg.d_ff * (3 if cfg.mlp_gated else 2)
        elif channel == "moe":
            mo = cfg.moe
            n_active += (mo.top_k + mo.num_shared) * d * mo.d_expert * 3
    if cfg.family == "audio":
        n_active *= 1.6  # cross-attention + encoder stack, rough
    n_total = n_active + n_embed
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    par_mult = 6 if shape.kind == "train" else 2
    return par_mult * n_total * tokens + attn_fl


def roofline_pair(arch: str, shape_name: str, *, chips: int = 256,
                  dry: dict | None = None) -> dict:
    """One pair's roofline from a single-pod dry-run record of the pair:
    ``dry`` where the caller has one, else a new ``dryrun.run_pair``."""
    if dry is None:
        dry = run_pair(arch, shape_name, multi_pod=False, verbose=False)
    if dry["status"] == "skipped":
        return {"arch": arch, "shape": shape_name, "status": "skipped"}
    shape = SHAPES[shape_name]
    cfg_v = build.shape_variant(get_config(arch), shape)
    cost = {"flops": float(dry["flops"]),
            "bytes": float(dry["bytes_accessed"]),
            "bytes_products": float(dry["bytes_products"]),
            "coll_bytes": float(dry["collective_operand_bytes"])}
    return _terms(arch, shape_name, shape, cfg_v, chips, dry["depth"], cost)


def _terms(arch, shape_name, shape, cfg_v, chips, depth, cost):
    terms = {"compute_s": cost["flops"] / PEAK_FLOPS_BF16,
             "memory_s": cost["bytes"] / HBM_BW,
             "collective_s": cost["coll_bytes"] / LINK_BW}
    dominant = max(terms, key=terms.get)
    fused = dict(terms, memory_s=cost["bytes_products"] / HBM_BW)
    mf = model_flops(cfg_v, shape)
    return {
        "arch": arch, "shape": shape_name, "status": "ok",
        "kind": shape.kind, "chips": chips, "depth": depth,
        "flops_per_dev": cost["flops"],
        "bytes_per_dev": cost["bytes"],
        "coll_bytes_per_dev": cost["coll_bytes"],
        **{k: round(v, 6) for k, v in terms.items()},
        "dominant": dominant.replace("_s", ""),
        "memory_products_s": round(fused["memory_s"], 6),
        "dominant_fused": max(fused, key=fused.get).replace("_s", ""),
        "model_flops_global": mf,
        "useful_flops_ratio": mf / max(cost["flops"] * chips, 1.0),
        "bound_step_time_s": round(max(terms.values()), 6),
    }


def kernel_roofline_summary(bench: dict) -> dict:
    """Per-kernel roofline fractions from a kernels benchmark dict: every
    ``model_flops_<cell>`` counter paired with its ``model_bytes_<cell>``
    twin and the cell's measured time, as achieved FLOP/s and bytes/s
    against the card's peaks."""
    counters = bench.get("counters", {})
    timings = bench.get("timings_s", {})
    cells = {}
    for name, fl in sorted(counters.items()):
        if not name.startswith("model_flops_"):
            continue
        cell = name[len("model_flops_"):]
        nbytes = counters.get(f"model_bytes_{cell}")
        t = timings.get(cell)
        if nbytes is None or not t:
            continue
        cells[cell] = {
            "time_s": t,
            "model_flops": float(fl),
            "model_bytes": float(nbytes),
            **kernel_roofline(float(fl), float(nbytes), float(t)),
        }
    return {"peaks": {"flops_bf16_per_s": PEAK_FLOPS_BF16,
                      "hbm_bytes_per_s": HBM_BW},
            "cells": cells}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list(ARCHS))
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="build/roofline")
    ap.add_argument("--kernels", metavar="BENCH_KERNELS_JSON",
                    help="write a per-kernel roofline-fraction summary of "
                         "a kernels benchmark JSON instead")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    if args.kernels:
        with open(args.kernels) as f:
            summary = kernel_roofline_summary(json.load(f))
        out = os.path.join(args.out, "ROOFLINE_kernels.json")
        with open(out, "w") as f:
            json.dump(summary, f, indent=1, sort_keys=True)
        print(f"# -> {out}")
        return
    pairs = ([(a, s) for a in ARCHS for s in SHAPES] if args.all
             else [(args.arch, args.shape)])
    failures = []
    for arch, shape in pairs:
        try:
            rec = roofline_pair(arch, shape)
        except Exception as e:  # noqa: BLE001 -- listed, CLI exits 1
            traceback.print_exc()
            rec = {"arch": arch, "shape": shape, "status": "fail",
                   "error": f"{type(e).__name__}: {e}"}
            failures.append(f"{arch}_{shape}")
        with open(os.path.join(args.out, f"{arch}_{shape}.json"), "w") as f:
            json.dump(rec, f, indent=1)
        if rec["status"] == "ok":
            print(f"{arch:28s} {shape:12s} comp {rec['compute_s']:9.4f}s "
                  f"mem {rec['memory_s']:9.4f}s coll "
                  f"{rec['collective_s']:9.4f}s -> {rec['dominant']:10s} "
                  f"[{rec['depth']}] useful={rec['useful_flops_ratio']:.2f}")
        else:
            print(f"{arch:28s} {shape:12s} {rec['status']}")
    if failures:
        print("FAILURES:", failures)
        raise SystemExit(1)


if __name__ == "__main__":
    main()
