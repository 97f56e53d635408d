#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card.

    python3 chip_smoke.py [--m 16384] [--n 32768] [--density 0.15]
                          [--K 8] [--rounds 30] [--eps 1e-3] [--seed 42]

Phases, each ending in ``torch.cuda.synchronize()`` and printing one
JSON line:

  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc``;
  2. hold each kernel against its plain PyTorch version on the card, at
     the main path's shapes: K1 (SCD) allclose at rtol 1e-4, atol 1e-5;
     K2 (int8 quantize) and K3 (int8 decode+sum/mean) bit-identical,
     also on edge cases;
  3. the main path: CoCoA ridge with ``solver="scd_kernel"`` and
     ``exchange="compressed:int8"`` on the virtual driver, K workers
     batched into each launch, with every launch counter set to 0 just
     before and read just after; each kernel must have launched exactly
     once per round;
  4. the whole-path check: the first 3 rounds again with the plain SCD
     on the same index stream must give the same primal at rtol 1e-4,
     and a small problem run on the card and on the CPU (plain versions
     throughout) must agree round by round;
  5. timing: each kernel and its plain version by CUDA events at the
     main path's shapes, beside the least time the card could take.

The last line is ``{"ok": true, "device": {...}}``. Any failure raises
and exits non-zero; without a CUDA device the script exits 1 before
printing any result.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# f32 operations/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def emit(**kw) -> None:
    print(json.dumps(kw), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def phase_done(torch, name: str, t0: float, **kw) -> None:
    torch.cuda.synchronize()
    emit(phase=name, seconds=time.perf_counter() - t0, **kw)


def bits_equal(torch, a, b) -> bool:
    """Bit-for-bit equality (tells -0.0 from 0.0)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and bool(torch.equal(a, b))


def time_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean milliseconds per call from CUDA events around ``reps`` warm
    calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, default=16384)
    ap.add_argument("--n", type=int, default=32768)
    ap.add_argument("--density", type=float, default=0.15)
    ap.add_argument("--K", type=int, default=8)
    ap.add_argument("--lam", type=float, default=1.0)
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--eps", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--reps", type=int, default=50,
                    help="timed launches per kernel")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.core import CoCoAConfig, CoCoATrainer
    from repro_torch.core.solvers import scd_steps
    from repro_torch.carry import ReplayIndices
    from repro_torch.data import make_glm_data
    from repro_torch.kernels import _build
    from repro_torch.kernels.dequant import (decode_reduce_int8,
                                             decode_reduce_int8_ref)
    from repro_torch.kernels.quant import (quantize_pack_int8,
                                           quantize_pack_int8_ref)
    from repro_torch.kernels.scd import scd_solve

    card = nvidia_smi()
    print(card, flush=True)
    emit(device=torch.cuda.get_device_name(0), torch=torch.__version__,
         cuda=torch.version.cuda, count=torch.cuda.device_count())

    # -- 1. build -------------------------------------------------------
    t0 = time.perf_counter()
    info = _build.build()
    _build.library()
    ptxas = [ln.strip() for ln in info.log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    phase_done(torch, "build", t0, build_seconds=info.seconds,
               library=os.path.relpath(info.path, ROOT), ptxas=ptxas)

    # -- data and trainer at the slice's size --------------------------
    t0 = time.perf_counter()
    A, b, _ = make_glm_data(m=args.m, n=args.n, density=args.density,
                            zipf_a=1.1, seed=args.seed)
    H = -(-args.n // args.K)                     # H = n_local
    cfg = CoCoAConfig(K=args.K, H=H, lam=args.lam, eta=1.0,
                      solver="scd_kernel", exchange="compressed:int8",
                      seed=args.seed)
    tr = CoCoATrainer(cfg, A, b)
    dev = tr.A.device
    K, n_pad, m = tr.A_T.shape
    phase_done(torch, "setup", t0, m=m, n=args.n, K=K, n_pad=n_pad, H=H,
               density=args.density,
               A_T_bytes=tr.A_T.numel() * tr.A_T.element_size())
    t0 = time.perf_counter()
    p_star = tr.p_star
    phase_done(torch, "p_star", t0, p_star=p_star, p_zero=tr.p_zero)

    # -- 2. each kernel against its plain version on the card ----------
    t0 = time.perf_counter()
    kw = dict(sigma=cfg.sigma_val, lam=cfg.lam, eta=cfg.eta)
    alpha0, w0 = tr.init_state()
    idx1 = tr.index_source(1)
    dv_k, al_k = scd_solve(tr.A_T, tr.col_sq, alpha0, w0, idx1, **kw)
    dv_p, al_p = scd_steps(tr.A_T, tr.col_sq, alpha0, w0, idx1, **kw)
    torch.cuda.synchronize()
    err_scd = max(float((dv_k - dv_p).abs().max()),
                  float((al_k - al_p).abs().max()))
    ok_scd = (torch.allclose(dv_k, dv_p, rtol=1e-4, atol=1e-5)
              and torch.allclose(al_k, al_p, rtol=1e-4, atol=1e-5))

    g = torch.Generator(device=dev).manual_seed(args.seed)
    single = torch.zeros((3, 1001), device=dev)
    single[1, 500] = -2.5
    cases = [dv_k,                                         # the main path's
             torch.zeros((K, m), device=dev),              # all zeros
             torch.randn((K, 1), generator=g, device=dev),  # L = 1
             torch.randn((5, 1001), generator=g, device=dev) * 1e-3,  # odd L
             single,                                       # one nonzero
             torch.randn((m,), generator=g, device=dev)]   # one 1-D update
    ok_quant, err_quant = True, 0.0
    for x in cases:
        qk, sk = quantize_pack_int8(x)
        qp, sp = quantize_pack_int8_ref(x)
        ok_quant &= bits_equal(torch, qk, qp) and bits_equal(torch, sk, sp)
        err_quant = max(err_quant, float((qk.int() - qp.int()).abs().max()),
                        float((sk - sp).abs().max()))
    q_main, s_main = quantize_pack_int8(dv_k)
    ok_dequant, err_dequant = True, 0.0
    dq_cases = [(q_main, s_main)]
    for Kc, L in ((1, 1001), (3, 1), (5, 1001), (8, 4097)):
        dq_cases.append(quantize_pack_int8(
            torch.randn((Kc, L), generator=g, device=dev)))
    for q, s in dq_cases:
        for mean in (False, True):
            ok_ = decode_reduce_int8(q, s, q.shape[1], mean=mean)
            op_ = decode_reduce_int8_ref(q, s, q.shape[1], mean=mean)
            ok_dequant &= bits_equal(torch, ok_, op_)
            err_dequant = max(err_dequant, float((ok_ - op_).abs().max()))
    phase_done(torch, "kernels_vs_plain", t0,
               scd={"ok": ok_scd, "max_abs_err": err_scd,
                    "tolerance": "rtol 1e-4, atol 1e-5"},
               quant_int8={"ok": ok_quant, "max_abs_err": err_quant,
                           "tolerance": "bit-identical",
                           "cases": [list(x.shape) for x in cases]},
               decode_reduce_int8={"ok": ok_dequant,
                                   "max_abs_err": err_dequant,
                                   "tolerance": "bit-identical",
                                   "cases": [list(q.shape)
                                             for q, _ in dq_cases]})
    if not (ok_scd and ok_quant and ok_dequant):
        raise SystemExit("chip_smoke: a kernel disagrees with its plain "
                         "version (see the kernels_vs_plain line)")

    # -- 3. the main path -----------------------------------------------
    counters = (scd_solve, quantize_pack_int8, decode_reduce_int8)
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    hist = tr.run(args.rounds, target_eps=args.eps)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in counters}
    for r, p, s, sec in zip(hist.rounds, hist.primal, hist.subopt,
                            hist.seconds):
        emit(round=r, primal=p, subopt=s, ms=sec * 1e3)
    n_rounds = len(hist.rounds)
    r2e = hist.rounds_to(args.eps)
    phase_done(torch, "main_path", t0, rounds=n_rounds,
               rounds_to_eps=r2e if r2e is not None else "not reached",
               eps=args.eps, final_subopt=hist.subopt[-1],
               round_ms_median=float(np.median(hist.seconds)) * 1e3,
               comm_bytes_per_round=tr.comm_bytes_per_round(),
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               launches=launches)
    if any(v != n_rounds for v in launches.values()):
        raise SystemExit(f"chip_smoke: each kernel must launch once per "
                         f"round ({n_rounds} rounds), got {launches}")
    if not (np.all(np.isfinite(hist.primal))
            and np.all(np.isfinite(tr.alpha_final))
            and tr.alpha_final.shape == (args.n,)
            and hist.subopt[-1] < 1.0):
        raise SystemExit("chip_smoke: the main path's output is not finite, "
                         "not of shape (n,), or made no progress")

    # -- 4. whole-path check --------------------------------------------
    t0 = time.perf_counter()
    # The plain SCD sums each dot in another order than K1, which can
    # move an int8 code at a rounding edge; hence rtol 1e-4, not equality.
    tr_plain = CoCoATrainer(dataclasses.replace(cfg, solver="scd_ref"), A, b)
    n_chk = min(3, n_rounds)
    hist_plain = tr_plain.run(n_chk)
    rel = np.abs(np.array(hist_plain.primal)
                 - np.array(hist.primal[:n_chk])) / np.abs(hist.primal[:n_chk])
    del tr_plain
    # a small problem on the card (kernels) and on the CPU (plain
    # versions) with one replayed index stream
    As, bs, _ = make_glm_data(m=96, n=256, density=0.2, zipf_a=1.1,
                              seed=args.seed)
    cfg_s = CoCoAConfig(K=4, H=64, lam=1.0, solver="scd_kernel",
                        exchange="compressed:int8", seed=args.seed)
    probe = CoCoATrainer(cfg_s, As, bs, device="cpu")
    stream = [probe.index_source(t).numpy() for t in range(1, 11)]
    small = {}
    for where in ("cuda", "cpu"):
        trs = CoCoATrainer(cfg_s, As, bs, device=where,
                           index_source=ReplayIndices(stream, device=where))
        small[where] = trs.run(10).primal
    rel_small = np.abs(np.array(small["cuda"]) - np.array(small["cpu"])) \
        / np.abs(small["cpu"])
    phase_done(torch, "whole_path", t0,
               plain_vs_kernel_primal_rel=rel.tolist(),
               card_vs_cpu_small_primal_rel_max=float(rel_small.max()),
               tolerance="rtol 1e-4")
    if rel.max() > 1e-4 or rel_small.max() > 1e-4:
        raise SystemExit("chip_smoke: the whole-path check failed")

    # -- 5. timing at the main path's shapes ----------------------------
    t0 = time.perf_counter()
    L = m
    ms_scd = time_ms(torch, lambda: scd_solve(tr.A_T, tr.col_sq, alpha0, w0,
                                              idx1, **kw), args.reps)
    plain_scd = time_ms(torch, lambda: scd_steps(tr.A_T, tr.col_sq, alpha0,
                                                 w0, idx1, **kw), 3, warmup=1)
    ms_q = time_ms(torch, lambda: quantize_pack_int8(dv_k), 4 * args.reps)
    plain_q = time_ms(torch, lambda: quantize_pack_int8_ref(dv_k),
                      4 * args.reps)
    ms_d = time_ms(torch, lambda: decode_reduce_int8(q_main, s_main, L,
                                                     mean=False),
                   4 * args.reps)
    plain_d = time_ms(torch, lambda: decode_reduce_int8_ref(
        q_main, s_main, L, mean=False), 4 * args.reps)
    # K1 reads each distinct visited column once (this run's idx), its
    # norm, the index stream, alpha in and out, w, and writes Delta v;
    # a step is a dot and an axpy, 4m operations, plus ~10 scalar ones
    distinct = int(torch.unique(idx1.long()
                                + torch.arange(K, device=dev)[:, None]
                                * n_pad).numel())
    scd_bytes = 4 * (distinct * (m + 1) + K * H + 2 * K * n_pad + m + K * m)
    scd_bound = bound_ms(scd_bytes, K * H * (4 * m + 10))
    q_bound = bound_ms(K * (5 * L + 4), 6 * K * L)
    d_bound = bound_ms(K * (L + 4) + 4 * L, 2 * K * L)
    rows = [
        ("scd_solve", "src/repro_torch/kernels/csrc/scd.cu",
         "src/repro/kernels/scd.py:137", launches["scd_solve"], err_scd,
         ms_scd, plain_scd, scd_bound, ok_scd),
        ("quantize_pack_int8", "src/repro_torch/kernels/csrc/quant.cu",
         "src/repro/kernels/quant.py:90", launches["quantize_pack_int8"],
         err_quant, ms_q, plain_q, q_bound, ok_quant),
        ("decode_reduce_int8", "src/repro_torch/kernels/csrc/dequant.cu",
         "src/repro/kernels/dequant.py:123", launches["decode_reduce_int8"],
         err_dequant, ms_d, plain_d, d_bound, ok_dequant),
    ]
    phase_done(torch, "timing", t0, reps=args.reps,
               distinct_columns=distinct, scd_bytes=scd_bytes)
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": n_l, "max_abs_err": err,
                "ms": ms, "plain_ms": pms, "bound_ms": bnd[0],
                "bound_by": bnd[1], "library_ms": None, "ok": ok,
                "launches_per_round": n_l / n_rounds}
               for (name, src, rep, n_l, err, ms, pms, bnd, ok) in rows]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
