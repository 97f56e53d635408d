#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py [--m 16384] [--n 32768] [--density 0.15]
                          [--K 8] [--rounds 100] [--eps 1e-3] [--seed 42]

Phases, each ending in ``torch.cuda.synchronize()`` and printing one
JSON line:

  1. build the CUDA kernels from ``src/repro_torch/kernels/csrc``, and,
     once the data are on the card, print K1's layout and
     ``cudaOccupancyMaxActiveClusters`` for each cluster size C in
     {1, 2, 4, 8, 16} at the main path's shapes, and the C it plans;
     beside it the plans of K2 (each width) and K4 at the main path's
     (K, m) stack (C, slab, shared bytes) and the C's that fit;
  2. hold each kernel against its plain PyTorch version on the card, at
     the main path's shapes: K1 (SCD) allclose at rtol 1e-4, atol 1e-5
     for the planned C and for every other C that fits;
     K2 (int8 / int4 / int2 quantize), K3 (int8 / int4 / int2
     decode+sum/mean) and K4 (top-k select) bit-identical, also at
     ragged lengths and on edge cases (all zeros, one nonzero, scales
     1e-6 and 1e6; for K4 k in {1, ceil(L/8), L}, heavy ties, +x/-x
     pairs and -0.0 entries), K2 and K4 at the planned C and at every
     C that fits each case;
  3. the main paths: CoCoA ridge with ``solver="scd_kernel"`` on the
     virtual driver, K workers batched into each launch, under
     ``compressed:int8``, ``compressed:ef:int4`` (the error-feedback
     int4 exchange), ``compressed:ef:int2``,
     ``compressed:ef:topk(r=0.125)`` and the same with ``stale:k=2`` and
     worker 1 dropped in rounds 5-9, each on its own trainer (freed
     before the next) for up to ``--rounds`` rounds or until the
     suboptimality reaches ``--eps``. Every launch counter is set to 0
     just before each path and read just after: K1 and the path's own
     codec kernels (K2 and K3, or K4) must have launched exactly once
     per round, the other codecs' kernels never;
  4. the whole-path checks, under ``compressed:int8``,
     ``compressed:ef:int4`` and ``compressed:ef:topk(r=0.125)``: the
     first 3 rounds again with the plain SCD on the same index stream
     must give the same primal at rtol 1e-4, and a small problem run on
     the card and on the CPU (plain versions throughout) on one replayed
     index stream must agree round by round at rtol 1e-4; the codes (for
     topk, the selected indices) that differ between the two runs are
     counted and printed;
  5. timing at the main path's shapes, for every kernel two times: the
     wrapper's time per call by CUDA events around back-to-back calls
     (host work included when the host launches slower than the device
     runs), and the kernel's device time per launch from a
     ``torch.profiler`` trace of the same calls; beside them the least
     time the card could take, the plain version's time by events and,
     for K4, ``torch.topk`` of the magnitudes (the library call that
     computes the same selection; the port never calls it). K1, K2 and
     K4 also for every C that fits, K4 also at k = L;
  6. device traces: ``torch.profiler`` over 5 rounds of
     ``compressed:int8`` and of ``compressed:ef:topk(r=0.125)`` (after 2
     untraced ones each), each kernel's device time by name and the
     device's busy share of the window (a trace without device time is
     reported, not failed).

The last line is ``{"ok": true, "device": {...}}``. Any failure raises
and exits non-zero; without a CUDA device the script exits 1 before
printing any result.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
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

# the paths phase 3 drives, and the codec whose kernels each launches
TOPK_R = 0.125
TOPK = f"compressed:ef:topk(r={TOPK_R:g})"
PATHS = (("compressed:int8", "int8"), ("compressed:ef:int4", "int4"),
         ("compressed:ef:int2", "int2"), (TOPK, "topk"),
         (f"{TOPK}/stale:k=2/drop:1@5-9", "topk"))
CHECKED = ("compressed:int8", "compressed:ef:int4", TOPK)     # phase 4
CODECS = ("int8", "int4", "int2")
BITS = {"int8": 8, "int4": 4, "int2": 2}
# K2 and K4 run at the planned C (None) and at every C forced
CLUSTER_RUNS = (None, 16, 8, 4, 2, 1)
# the name of each timed kernel's __global__ function, as the profiler
# reports it (a substring of the demangled name)
KERNEL_NAMES = {"scd_solve": "scd_kernel", "topk": "topk_kernel",
                "topk_k_eq_L": "topk_kernel",
                "int8": "quant_kernel<1,", "int4": "quant_kernel<2,",
                "int2": "quant_kernel<4,",
                "decode_int8": "dequant_int8_kernel",
                "decode_int4": "dequant_packed_kernel",
                "decode_int2": "dequant_packed_kernel"}


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


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max()) if a.numel() else 0.0


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


def device_ms(torch, fn, reps: int, kernel: str):
    """Mean device milliseconds per launch of the kernel whose name holds
    ``kernel``, from a ``torch.profiler`` trace of ``reps`` warm calls of
    ``fn``; "not measured" when the trace holds no such kernel."""
    fn()
    trace = device_trace(torch, lambda: [fn() for _ in range(reps)])
    hits = [v for name, v in trace.get("kernels", {}).items()
            if kernel in name]
    calls = sum(v["calls"] for v in hits)
    if not calls:
        return "not measured"
    return sum(v["device_ms"] for v in hits) / calls


def quant_fits(L: int, bits: int, cluster) -> bool:
    """Whether K2 takes ``cluster`` CTAs a row of L elements."""
    from repro_torch.kernels.quant import quant_plan
    try:
        quant_plan(1, L, bits, cluster)
    except ValueError:
        return False
    return True


def topk_fits(L: int, k: int, cluster) -> bool:
    """Whether K4 takes ``cluster`` CTAs a row of L elements keeping k."""
    from repro_torch.kernels.topk import topk_plan
    try:
        topk_plan(1, L, k, cluster)
    except ValueError:
        return False
    return True


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def free(torch) -> None:
    """Hand the device memory of a dropped trainer back before the next
    one is built."""
    gc.collect()
    torch.cuda.empty_cache()


@contextlib.contextmanager
def recording(codec):
    """Keep every wire tuple ``codec``'s base encode produces while the
    block runs (an instance attribute shadows the method)."""
    base = getattr(codec, "base", codec)
    seen = []
    encode = base.encode

    def record(dv):
        out = encode(dv)
        seen.append([t.cpu() for t in out])
        return out

    base.encode = record
    try:
        yield seen
    finally:
        del base.encode


def codes_differ(torch, a, b, bits: int) -> int:
    """How many of the packed codes differ between two payloads."""
    if bits == 8:
        return int((a != b).sum())
    mask = (1 << bits) - 1
    a, b = a.to(torch.int32), b.to(torch.int32)
    return sum(int((((a >> s) & mask) != ((b >> s) & mask)).sum())
               for s in range(0, 8, bits))


def indices_differ(torch, a, b) -> int:
    """How many selected indices of a row the other run did not select
    (``a`` and ``b`` are two (K, k) top-k index tensors)."""
    return sum(int((~torch.isin(ra, rb)).sum()) for ra, rb in zip(a, b))


def device_trace(torch, fn) -> dict:
    """Run ``fn`` under ``torch.profiler`` (CPU and CUDA activities) and
    sum the device time of each kernel by name, with the device's busy
    share of the host window. A trace that holds no device time says so
    instead of failing."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_us = (time.perf_counter() - t0) * 1e6
    by_name, spans = {}, []
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        if end <= start:
            continue
        spans.append((start, end))
        name = ev.name if len(ev.name) <= 80 else ev.name[:77] + "..."
        n, us = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, us + (end - start))
    if not spans:
        return dict(device_time="none in the trace", window_ms=window_us / 1e3)
    spans.sort()
    busy, cur_s, cur_e = 0.0, *spans[0]
    for s_, e_ in spans[1:]:             # the union of the device spans
        if s_ > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s_, e_
        else:
            cur_e = max(cur_e, e_)
    busy += cur_e - cur_s
    device_span = spans[-1][1] - spans[0][0]
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    return dict(
        window_ms=window_us / 1e3, device_busy_ms=busy / 1e3,
        device_span_ms=device_span / 1e3,
        busy_share_of_window=busy / window_us,
        busy_share_of_device_span=busy / device_span,
        kernels={name: {"calls": n, "device_ms": us / 1e3}
                 for name, (n, us) in top})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, default=16384)
    ap.add_argument("--n", type=int, default=32768)
    ap.add_argument("--density", type=float, default=0.15)
    ap.add_argument("--K", type=int, default=8)
    ap.add_argument("--lam", type=float, default=1.0)
    ap.add_argument("--rounds", type=int, default=100)
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

    from repro_torch.carry import ReplayIndices
    from repro_torch.comm.codec import get_codec
    from repro_torch.core import CoCoAConfig, CoCoATrainer
    from repro_torch.core.solvers import scd_steps
    from repro_torch.data import make_glm_data
    from repro_torch.kernels import _build, dequant, quant, scd
    from repro_torch.kernels.scd import scd_solve
    from repro_torch.kernels.topk import (topk_plan, topk_select,
                                          topk_select_ref)

    enc = {c: getattr(quant, f"quantize_pack_{c}") for c in CODECS}
    enc_ref = {c: getattr(quant, f"quantize_pack_{c}_ref") for c in CODECS}
    dec = {c: getattr(dequant, f"decode_reduce_{c}") for c in CODECS}
    dec_ref = {c: getattr(dequant, f"decode_reduce_{c}_ref") for c in CODECS}

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

    # -- data and the first trainer at the slice's size -----------------
    t0 = time.perf_counter()
    A, b, _ = make_glm_data(m=args.m, n=args.n, density=args.density,
                            zipf_a=1.1, seed=args.seed)
    H = -(-args.n // args.K)                     # H = n_local
    cfg = CoCoAConfig(K=args.K, H=H, lam=args.lam, eta=1.0,
                      solver="scd_kernel", exchange=PATHS[0][0],
                      seed=args.seed)
    tr = CoCoATrainer(cfg, A, b)
    dev = tr.A.device
    K, n_pad, m = tr.A_T.shape
    phase_done(torch, "setup", t0, m=m, n=args.n, K=K, n_pad=n_pad, H=H,
               density=args.density,
               A_T_bytes=tr.A_T.numel() * tr.A_T.element_size())
    t0 = time.perf_counter()
    def resident(p):
        return scd.max_active_clusters(dev, p)

    occupancy, fits = {}, []
    for c in sorted(scd.CLUSTERS):
        lay = scd.scd_layout(m, n_pad, c)
        if lay is None:
            occupancy[str(c)] = "over 227 KB of shared memory"
            continue
        occupancy[str(c)] = dict(max_active_clusters=resident(lay),
                                 **dataclasses.asdict(lay))
        try:
            scd.scd_plan(K, m, n_pad, resident, cluster=c)
            fits.append(c)
        except ValueError:
            pass
    plan = scd.scd_plan(K, m, n_pad, resident)
    # K2 and K4 at the main path's (K, m) stack, K4 at the path's k
    k_main = get_codec(f"topk(r={TOPK_R:g})")._k(m)
    codec_plans = {c: dataclasses.asdict(quant.quant_plan(K, m, BITS[c]))
                   for c in CODECS}
    codec_plans["topk"] = dict(k=k_main, **dataclasses.asdict(
        topk_plan(K, m, k_main)))
    codec_fits = {c: [cl for cl in CLUSTER_RUNS[1:]
                      if quant_fits(m, BITS[c], cl)] for c in CODECS}
    codec_fits["topk"] = [cl for cl in CLUSTER_RUNS[1:]
                          if topk_fits(m, k_main, cl)]
    phase_done(torch, "clusters", t0, K=K, occupancy=occupancy,
               fits=fits, plan=dataclasses.asdict(plan),
               codec_plans=codec_plans, codec_fits=codec_fits)
    t0 = time.perf_counter()
    p_star = tr.p_star
    phase_done(torch, "p_star", t0, p_star=p_star, p_zero=tr.p_zero)

    # -- 2. each kernel against its plain version on the card ----------
    t0 = time.perf_counter()
    kw = dict(sigma=cfg.sigma_val, lam=cfg.lam, eta=cfg.eta)
    alpha0, _ = tr.init_state()
    w0 = -tr.b
    idx1 = tr.index_source(1)
    dv_k, al_k = scd_solve(tr.A_T, tr.col_sq, alpha0, w0, idx1, **kw)
    if scd_solve.last_plan != plan:
        raise SystemExit(f"chip_smoke: K1 ran {scd_solve.last_plan}, "
                         f"planned {plan}")
    dv_p, al_p = scd_steps(tr.A_T, tr.col_sq, alpha0, w0, idx1, **kw)
    torch.cuda.synchronize()
    scd_by_c = {}
    for c in [None] + fits:          # the planned C, then every C that fits
        dv_c, al_c = ((dv_k, al_k) if c is None else scd_solve(
            tr.A_T, tr.col_sq, alpha0, w0, idx1, cluster=c, **kw))
        scd_by_c["plan" if c is None else str(c)] = dict(
            max_abs_err=max(max_err(dv_c, dv_p), max_err(al_c, al_p)),
            ok=(torch.allclose(dv_c, dv_p, rtol=1e-4, atol=1e-5)
                and torch.allclose(al_c, al_p, rtol=1e-4, atol=1e-5)))
    err = {"scd_solve": max(v["max_abs_err"] for v in scd_by_c.values())}
    ok = {"scd_solve": all(v["ok"] for v in scd_by_c.values())}

    g = torch.Generator(device=dev).manual_seed(args.seed)
    single = torch.zeros((3, 1001), device=dev)
    single[1, 900] = -2.5                        # last quarter, upper half
    cases = [dv_k,                                         # the main path's
             torch.zeros((K, m), device=dev),              # all zeros
             single,                                       # one nonzero
             torch.randn((5, 1001), generator=g, device=dev) * 1e-6,
             torch.randn((5, 1001), generator=g, device=dev) * 1e6,
             torch.randn((m,), generator=g, device=dev)]   # one 1-D update
    for i, L in enumerate((1, 2, 3, 4, 5, 1001, 4097)):     # ragged lengths
        cases.append(torch.randn((1 + i % 8, L), generator=g, device=dev))
    payloads = {c: [] for c in CODECS}
    by_cluster = {}                  # K2 and K4 cases run at each C
    for c in CODECS:
        ok[c], err[c] = True, 0.0
        for cl in CLUSTER_RUNS:      # the planned C, then every C that fits
            runs_c = 0
            for x in cases:
                if not quant_fits(x.shape[-1], BITS[c], cl):
                    continue
                pk, sk = enc[c](x, cluster=cl)
                pp, sp = enc_ref[c](x)
                ok[c] &= (bits_equal(torch, pk, pp)
                          and bits_equal(torch, sk, sp))
                err[c] = max(err[c], max_err(pk, pp), max_err(sk, sp))
                runs_c += 1
                if x.dim() == 2 and cl is None:
                    payloads[c].append((pk, sk, x.shape[1]))
            by_cluster.setdefault(c, {})[str(cl or "plan")] = runs_c
        name = f"decode_{c}"
        ok[name], err[name] = True, 0.0
        for p, s, L in payloads[c]:
            for mean in (False, True):
                out_k = dec[c](p, s, L, mean=mean)
                out_p = dec_ref[c](p, s, L, mean=mean)
                ok[name] &= bits_equal(torch, out_k, out_p)
                err[name] = max(err[name], max_err(out_k, out_p))
    # K4 on the round-1 stack at the main path's ratios, then on ragged
    # lengths, k in {1, ceil(L/8), L}, and rows of ties and signed zeros
    topk_cases = [(dv_k, get_codec(f"topk(r={r:g})")._k(m))
                  for r in (0.01, TOPK_R, 1.0)]
    ties = torch.randint(-3, 4, (4, 4097), generator=g, device=dev).float()
    negzero = torch.where(torch.rand((4, 4097), generator=g, device=dev)
                          < 0.5, torch.tensor(-0.0, device=dev),
                          torch.tensor(0.0, device=dev))
    negzero[:, ::7] = torch.randn(negzero[:, ::7].shape, generator=g,
                                  device=dev)
    for L in (1, 2, 3, 127, 128, 129, 1001, 4097):
        one = torch.zeros((2, L), device=dev)
        one[1, L // 2] = -2.5
        for kk in sorted({1, -(-L // 8), L}):
            topk_cases += [
                (torch.randn((3, L), generator=g, device=dev), kk),
                (torch.zeros((2, L), device=dev), kk),   # all zeros
                (one, kk),                               # one nonzero
                (ties[:, :L].contiguous(), kk),      # ties and +x/-x pairs
                (negzero[:, :L].contiguous(), kk)]   # -0.0 entries
    ok["topk"], err["topk"] = True, 0.0
    for cl in CLUSTER_RUNS:
        runs_c = 0
        for x, kk in topk_cases:
            if not topk_fits(x.shape[-1], kk, cl):
                continue
            got, want = topk_select(x, kk, cluster=cl), topk_select_ref(x, kk)
            ok["topk"] &= all(bits_equal(torch, a, b_) for a, b_ in
                              zip(got, want))
            err["topk"] = max(err["topk"], max_err(got[0], want[0]),
                              max_err(got[2], want[2]),
                              max_err(got[1].long(), want[1].long()))
            runs_c += 1
        by_cluster.setdefault("topk", {})[str(cl or "plan")] = runs_c
    phase_done(torch, "kernels_vs_plain", t0,
               ok=ok, max_abs_err=err, scd_by_cluster=scd_by_c,
               tolerance={"scd_solve": "rtol 1e-4, atol 1e-5",
                          "quantize, decode and topk": "bit-identical"},
               quantize_cases=[list(x.shape) for x in cases],
               decode_cases=[[list(p.shape), L]
                             for p, _, L in payloads["int4"]],
               topk_cases=len(topk_cases), cases_by_cluster=by_cluster,
               topk_negative_zeros=int(torch.signbit(negzero).sum()
                                       - (negzero < 0).sum()),
               topk_main_k=[kk for _, kk in topk_cases[:3]])
    if not all(ok.values()):
        raise SystemExit("chip_smoke: a kernel disagrees with its plain "
                         "version (see the kernels_vs_plain line)")
    main_payload = {c: payloads[c][0] for c in CODECS}      # from dv_k

    # -- 3. the main paths ----------------------------------------------
    counters = ([scd_solve] + list(enc.values()) + list(dec.values())
                + [topk_select])
    runs = {}
    for ex, c in PATHS:
        if tr is None:
            tr = CoCoATrainer(dataclasses.replace(cfg, exchange=ex), A, b)
        path_p_star = tr.p_star  # solved outside the path's peak memory
        held = torch.cuda.memory_allocated()
        for fn in counters:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        hist = tr.run(args.rounds, target_eps=args.eps)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counters}
        n_rounds = len(hist.rounds)
        r2e = hist.rounds_to(args.eps)
        sec = np.array(hist.seconds)
        phase_done(torch, "main_path", t0, exchange=ex, rounds=n_rounds,
                   rounds_to_eps=r2e if r2e is not None else "not reached",
                   eps=args.eps, p_star=path_p_star,
                   final_subopt=hist.subopt[-1],
                   subopt=hist.subopt,
                   round_ms_median=float(np.median(sec)) * 1e3,
                   round_ms_max=float(sec.max()) * 1e3,
                   round_ms_quartiles=(np.percentile(sec, [25, 75])
                                       * 1e3).tolist(),
                   comm_bytes_per_round=tr.comm_bytes_per_round(),
                   comm_bytes_by_round=(
                       [tr.comm_bytes_per_round(t) for t in hist.rounds]
                       if "drop:" in ex else "every round the same"),
                   memory_allocated_before=held,
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   launches=launches)
        want = {fn.__name__: 0 for fn in counters}
        own = (("topk_select",) if c == "topk"
               else (f"quantize_pack_{c}", f"decode_reduce_{c}"))
        want.update({name: n_rounds for name in ("scd_solve",) + own})
        if launches != want:
            raise SystemExit(f"chip_smoke: under {ex} K1 and the {c} "
                             f"kernels must launch once per round ({n_rounds}"
                             f" rounds) and no other kernel, got {launches}")
        if not (np.all(np.isfinite(hist.primal))
                and np.all(np.isfinite(tr.alpha_final))
                and tr.alpha_final.shape == (args.n,)
                and hist.subopt[-1] < 1.0):
            raise SystemExit(f"chip_smoke: the {ex} path's output is not "
                             f"finite, not of shape (n,), or made no progress")
        runs[ex] = dict(primal=hist.primal, rounds=n_rounds, launches=launches)
        tr = None
        free(torch)

    # -- 4. whole-path checks -------------------------------------------
    t0 = time.perf_counter()
    checks = {}
    n_chk = 3
    # the plain SCD sums each dot in another order than K1, which can
    # move a code at a rounding edge; hence rtol 1e-4, not equality
    for ex in CHECKED:
        trp = CoCoATrainer(dataclasses.replace(cfg, exchange=ex,
                                               solver="scd_ref"), A, b)
        primal = trp.run(n_chk).primal
        del trp
        free(torch)
        want = runs[ex]["primal"][:n_chk]
        checks[f"{ex} plain vs kernel"] = (
            np.abs(np.array(primal) - want) / np.abs(want)).tolist()
    # a small problem on the card (kernels) and on the CPU (plain
    # versions) with one replayed index stream
    As, bs, _ = make_glm_data(m=96, n=256, density=0.2, zipf_a=1.1,
                              seed=args.seed)
    codes = {}
    for ex in CHECKED:
        cfg_s = CoCoAConfig(K=4, H=64, lam=1.0, solver="scd_kernel",
                            exchange=ex, seed=args.seed)
        probe = CoCoATrainer(cfg_s, As, bs, device="cpu")
        stream = [probe.index_source(t).numpy() for t in range(1, 11)]
        small, sent = {}, {}
        codec = get_codec(ex.partition(":")[2])
        for where in ("cuda", "cpu"):
            trs = CoCoATrainer(cfg_s, As, bs, device=where,
                               index_source=ReplayIndices(stream,
                                                          device=where))
            with recording(codec) as seen:
                small[where] = trs.run(10).primal
            sent[where] = seen
        pairs = list(zip(sent["cuda"], sent["cpu"]))
        if ex == TOPK:                   # the selected indices
            codes[ex] = [indices_differ(torch, a[1], b_[1])
                         for a, b_ in pairs]
        else:                            # the packed codes
            bits = getattr(codec, "base", codec).bits
            codes[ex] = [codes_differ(torch, a[0], b_[0], bits)
                         for a, b_ in pairs]
        checks[f"{ex} card vs cpu"] = (
            np.abs(np.array(small["cuda"]) - small["cpu"])
            / np.abs(small["cpu"])).tolist()
    worst = {k: max(v) for k, v in checks.items()}
    phase_done(torch, "whole_path", t0, primal_rel=checks,
               primal_rel_max=worst, codes_differ_card_vs_cpu=codes,
               tolerance="rtol 1e-4")
    if max(worst.values()) > 1e-4:
        raise SystemExit("chip_smoke: the whole-path check failed (see the "
                         "whole_path line: primal_rel and codes_differ)")

    # -- 5. timing at the main path's shapes ----------------------------
    t0 = time.perf_counter()
    tr = CoCoATrainer(cfg, A, b)                 # K1's inputs again
    alpha0, w0 = tr.init_state()
    idx1 = tr.index_source(1)
    L = m
    ms, plain = {}, {}
    ms["scd_solve"] = time_ms(torch, lambda: scd_solve(
        tr.A_T, tr.col_sq, alpha0, w0, idx1, **kw), args.reps)
    plain["scd_solve"] = time_ms(torch, lambda: scd_steps(
        tr.A_T, tr.col_sq, alpha0, w0, idx1, **kw), 3, warmup=1)
    scd_ms = {str(c): time_ms(torch, lambda c=c: scd_solve(
        tr.A_T, tr.col_sq, alpha0, w0, idx1, cluster=c, **kw), args.reps)
        for c in fits}
    ms["topk"] = time_ms(torch, lambda: topk_select(dv_k, k_main),
                         4 * args.reps)
    ms["topk_k_eq_L"] = time_ms(torch, lambda: topk_select(dv_k, L),
                                args.reps)
    plain["topk"] = time_ms(torch, lambda: topk_select_ref(dv_k, k_main),
                            4 * args.reps)
    library = {"topk": time_ms(torch, lambda: torch.topk(
        dv_k.abs(), k_main, dim=1, sorted=True), 4 * args.reps)}
    for c in CODECS:
        p, s, _ = main_payload[c]
        ms[c] = time_ms(torch, lambda: enc[c](dv_k), 4 * args.reps)
        plain[c] = time_ms(torch, lambda: enc_ref[c](dv_k), 4 * args.reps)
        ms[f"decode_{c}"] = time_ms(
            torch, lambda: dec[c](p, s, L, mean=False), 4 * args.reps)
        plain[f"decode_{c}"] = time_ms(
            torch, lambda: dec_ref[c](p, s, L, mean=False), 4 * args.reps)
    # the same calls again under the profiler: each kernel's own device
    # time per launch, without the host's part of the wrapper
    calls = {"scd_solve": (lambda: scd_solve(
        tr.A_T, tr.col_sq, alpha0, w0, idx1, **kw), args.reps),
        "topk": (lambda: topk_select(dv_k, k_main), 4 * args.reps),
        "topk_k_eq_L": (lambda: topk_select(dv_k, L), args.reps)}
    for c in CODECS:
        p, s, _ = main_payload[c]
        calls[c] = (lambda c=c: enc[c](dv_k), 4 * args.reps)
        calls[f"decode_{c}"] = (lambda p=p, s=s, c=c: dec[c](
            p, s, L, mean=False), 4 * args.reps)
    dev_ms = {key: device_ms(torch, fn, n, KERNEL_NAMES[key])
              for key, (fn, n) in calls.items()}
    # K2 and K4 also at every C that fits the main path's stack
    ms_by_c, dev_by_c = {}, {}
    for key in CODECS + ("topk",):
        for cl in codec_fits[key]:
            fn = ((lambda cl=cl: topk_select(dv_k, k_main, cluster=cl))
                  if key == "topk" else
                  (lambda cl=cl, key=key: enc[key](dv_k, cluster=cl)))
            ms_by_c.setdefault(key, {})[str(cl)] = time_ms(
                torch, fn, 4 * args.reps)
            dev_by_c.setdefault(key, {})[str(cl)] = device_ms(
                torch, fn, 4 * args.reps, KERNEL_NAMES[key])
    # K1 reads each distinct visited column once (this run's idx), its
    # norm, the index stream, alpha in and out, w, and writes Delta v;
    # a step is a dot and an axpy, 4m operations, plus ~10 scalar ones
    distinct = int(torch.unique(idx1.long()
                                + torch.arange(K, device=dev)[:, None]
                                * n_pad).numel())
    scd_bytes = 4 * (distinct * (m + 1) + K * H + 2 * K * n_pad + m + K * m)
    bounds = {"scd_solve": bound_ms(scd_bytes, K * H * (4 * m + 10))}
    for c, per in (("int8", 1), ("int4", 2), ("int2", 4)):
        wire = -(-L // per)
        # quantize reads the f32 stack, writes the payload and scales;
        # decode reads the payload and scales, writes the (L,) f32 sum
        bounds[c] = bound_ms(K * (4 * L + wire + 4), 6 * K * L)
        bounds[f"decode_{c}"] = bound_ms(K * (wire + 4) + 4 * L, 2 * K * L)
    # K4 reads the f32 stack and writes k values, k indices and one
    # threshold per row; one magnitude per element
    bounds["topk"] = bound_ms(K * 4 * L + K * (8 * k_main + 4), K * L)
    bounds["topk_k_eq_L"] = bound_ms(K * 4 * L + K * (8 * L + 4), K * L)
    phase_done(torch, "timing", t0, reps=args.reps,
               distinct_columns=distinct, scd_bytes=scd_bytes,
               topk_k=k_main, wrapper_ms=ms, device_ms=dev_ms,
               bound_ms={key: b[0] for key, b in bounds.items()},
               topk_k_eq_L=dict(k=L, wrapper_ms=ms["topk_k_eq_L"],
                                device_ms=dev_ms["topk_k_eq_L"],
                                bound_ms=bounds["topk_k_eq_L"][0]),
               scd_ms_by_cluster=scd_ms, codec_ms_by_cluster=ms_by_c,
               codec_device_ms_by_cluster=dev_by_c,
               scd_bound_ratio_by_cluster={
                   c: t / bounds["scd_solve"][0] for c, t in scd_ms.items()})

    # -- 6. device traces of compressed:int8 and ef:topk rounds ----------
    for ex in (PATHS[0][0], TOPK):
        t0 = time.perf_counter()
        if tr is None:
            tr = CoCoATrainer(dataclasses.replace(cfg, exchange=ex), A, b)
        tr.run(2)                    # p_star and the first rounds, untraced
        trace = device_trace(torch, lambda: tr.run(5))
        tr = None
        free(torch)
        phase_done(torch, "trace", t0, exchange=ex, rounds=5, **trace)

    src = "src/repro_torch/kernels/csrc/"
    rows = [("scd_solve", "scd_solve", src + "scd.cu",
             "src/repro/kernels/scd.py:137", [ex for ex, _ in PATHS])]
    for (ex, c), q_line, d_line in zip(PATHS[:3], (90, 110, 130),
                                       (123, 144, 165)):
        rows.append((c, f"quantize_pack_{c}", src + "quant.cu",
                     f"src/repro/kernels/quant.py:{q_line}", [ex]))
        rows.append((f"decode_{c}", f"decode_reduce_{c}", src + "dequant.cu",
                     f"src/repro/kernels/dequant.py:{d_line}", [ex]))
    rows.append(("topk", "topk_select", src + "topk.cu",
                 "src/repro/kernels/topk.py:83",
                 [ex for ex, c in PATHS if c == "topk"]))
    kernels = []
    for key, name, source, replaces, paths in rows:
        n_l = sum(runs[ex]["launches"][name] for ex in paths)
        n_r = sum(runs[ex]["rounds"] for ex in paths)
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n_l, "max_abs_err": err[key],
            "ms": ms[key], "device_ms": dev_ms[key],
            "bound_ratio": (dev_ms[key] / bounds[key][0]
                            if isinstance(dev_ms[key], float)
                            else "not measured"),
            "plain_ms": plain[key], "bound_ms": bounds[key][0],
            "bound_by": bounds[key][1], "library_ms": library.get(key),
            "ok": ok[key],
            "paths": paths, "launches_per_round": n_l / n_r})
    kernels[0].update(cluster=plan.cluster, ring=plan.ring, slab=plan.slab,
                      ms_by_cluster=scd_ms)
    for entry, key in zip(kernels, [r[0] for r in rows]):
        if key in codec_plans:
            entry.update(cluster=codec_plans[key]["cluster"],
                         ms_by_cluster=ms_by_c[key],
                         device_ms_by_cluster=dev_by_c[key])
    kernels[-1].update(k=k_main, k_eq_L=dict(
        k=L, ms=ms["topk_k_eq_L"], device_ms=dev_ms["topk_k_eq_L"],
        bound_ms=bounds["topk_k_eq_L"][0]))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
