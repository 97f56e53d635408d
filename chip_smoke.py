#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main paths on one NVIDIA card.

    python3 chip_smoke.py [--m 16384] [--n 32768] [--density 0.15]
                          [--K 8] [--rounds 100] [--eps 1e-3] [--seed 42]
                          [--long-m 350000] [--long-n 1024]
                          [--long-rounds 30] [--only-mesh]

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
     C that fits each case; then each kernel at the shapes its first
     designs refused, on random inputs made on the card (K1 at
     (K 8, m 350,000, n_pad 128, H 128), its slab of rho streamed and
     held in shared memory (C = 8), at (K 8, m 262,148, n_pad 128, H 64)
     forced to C = 4, the slab in device memory, and at (K 2, m 4096,
     n_pad 65,536, H 256), alpha in device memory; K2 and K3 at
     (8, 1,048,579), K2 streaming, and at (8, 350,000), K2 in registers
     at C = 16, each width; K4 at (8, 350,000) with k = 43,750,
     (1, 10^6) with k = 1 and (2, 200,003) with k = L, as planned (the
     first in the grid form since PR 28, the others in the
     device-memory forms), and at the main path's stack forced into the
     device-memory form; K4's and K2's grid forms forced at (4,
     1,000,003), rows of ties in [-3, 3], zeros, one nonzero and normal,
     k = 1, ceil(L/100) and L, x aligned and one float off); the
     fixed-order batched products (``bmv.cu``:
     matvec and vecmat) at mini-batch SCD's (K, n_pad, m) stack, SGD's
     (K, m/K, n) row blocks and local SGD's gathered rows, and on ragged,
     misaligned and expanded inputs, within the dot-product bound
     2 gamma_n sum |products| of their plain versions, each worker's
     block alone bit-identical to its rows of the K-worker launch;
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
  4b. the long-row path: webspam's row count (``--long-m`` 350,000
     examples, ``--long-n`` 1024 features, H = n_local = 128) under
     ``compressed:int8`` and ``compressed:ef:topk(r=0.125)`` for up to
     ``--long-rounds`` rounds each, each kernel of the path once a
     round, and the first 3 rounds held against the plain SCD on the
     same index stream at rtol 1e-4;
  4c. the baselines at the main shape (ridge, K = 8), each on its own
     trainer (freed before the next), every round recorded, the launch
     counters set to 0 just before each path and read just after:
     mini-batch SCD (its solve the batched exact fixed-point form, H =
     n_local) under ``compressed:int8`` for up to 300 rounds or until
     the suboptimality reaches 1e-3 (rounds-to-eps at 1e-3 and 4e-3
     beside CoCoA's); mini-batch SGD on the virtual driver, MLlib's H = 1
     at ``batch_frac`` 1 under ``compressed:int8`` and
     ``compressed:ef:topk(r=0.125)``, and local SGD (H = 4, ``batch_frac``
     0.1) under ``compressed:ef:int4/drop:1@5-9``, 100 rounds each, step
     1/L (1/(K L) at H = 4) with L = sigma_max(A)^2 + lam from 30 power
     iterations; the legacy single-device SGD loop (``batch_frac`` 0.1,
     20 rounds). K1 must not launch, the path's codec kernels once a
     round, the batched products as often as the path takes them
     (mini-batch SCD: one matvec and one vecmat; SGD: H + 1 and H), no
     other kernel. Then: mini-batch SCD's first 3 rounds again
     through the step loop (the batched solve's plain version) at rtol
     1e-4; a small problem on the card and on the CPU on one replayed
     stream for mini-batch SCD ``compressed:int8``, SGD H = 1
     ``compressed:int8`` and H = 4 ``compressed:ef:int4/drop:1@3-5`` at
     rtol 1e-4, with the codes that differ; ``torch.profiler`` traces of 5
     mini-batch SCD and 5 SGD H = 1 rounds;
  5. timing at the main path's shapes, for every kernel two times: the
     wrapper's time per call by CUDA events around back-to-back calls
     (host work included when the host launches slower than the device
     runs), and its device time per call from a ``torch.profiler``
     trace of the same calls (every kernel of the form, summed); beside
     them the least
     time the card could take, the plain version's time by events and,
     for K4, ``torch.topk`` of the magnitudes (the library call that
     computes the same selection; the port never calls it). K1, K2 and
     K4 also for every C that fits, K4 also at k = L and in its
     device-memory form; mini-batch SCD's batched solve on K1's inputs
     (events and the device time of all its kernels, beside the bound of
     its two passes over A_T and of reading each input once); K2 and K3
     (int8) and K4 (k = 4096) on the SGD path's round-1 gradient stack
     (K, n), each held bit for bit against its plain version there (K2
     and K3 also int4); the batched products at mini-batch SCD's and
     SGD's shapes, beside their plain versions, ``torch.matmul`` and
     the loop of one ``torch.matmul`` a worker; then every kernel at the
     long-row path's shapes
     (its round-1 inputs and Δv), K4 also at C = 16, 8 and 4, and both
     forms of K4 (k at r = 0.125 and 0.01) and K2 (int8) at (8, 10^6,
     2^21 and 2^22), the lengths on each side of the plans' switch;
  6. device traces: ``torch.profiler`` over 5 rounds of
     ``compressed:int8`` and of ``compressed:ef:topk(r=0.125)`` (after 2
     untraced ones each), each kernel's device time by name and the
     device's busy share of the window (a trace without device time is
     reported, not failed);
  7. the sharded driver (``run_sharded``) on a 1-rank NCCL group in this
     process, K = 1 at one main-path worker's shape (m = 16,384, n = H =
     4096), 5 rounds each of ``persistent``, ``spark_faithful``,
     ``reduce_scatter``, ``compressed:int8``,
     ``compressed:ef:topk(r=0.125)`` and ``compressed:int8/ring``: the
     final state's hashes and every primal equal to the virtual driver's
     at K = 1 (a sum of one addend is exact), no copy staged, K1 and the
     path's codec kernels once a round; the recorded calls are printed.
     Then ``calibrate_link`` on the group for ``persistent`` and
     ``compressed:int8``: one rank moves no bytes, so the bandwidth must
     come back infinite, beside the call's latency. NCCL refuses two
     ranks on one card, so this is the only NCCL group the card can hold;
  8. K ranks, one process per worker, all on the one card in a gloo
     group (each payload copied through the host), at the main shape:
     the parent writes each rank's column block and row block once and
     hands the ranks phase 3's p_star; CoCoA ``compressed:int8`` and
     ``compressed:int8/ring`` and
     ``compressed:ef:topk(r=0.125)/stale:k=2/drop:1@5-9`` up to the
     virtual run's rounds-to-eps, ``persistent`` for 10 rounds,
     mini-batch SCD ``compressed:int8`` and SGD H = 1 ``compressed:int8``
     for 5, each on phase 3's (4c's) index stream. Each path against a
     virtual run: each rank's K1 plan, the final state's hashes (the
     ``compressed`` paths, where the plans agree), the per-round primal
     (rtol 1e-6; 1e-4 for ``persistent``, whose sum order is gloo's),
     rounds-to-eps, the bytes derived from the recorded calls (equal to
     ``comm_bytes_per_round()`` every round), the wire dtypes, the
     launches per rank, each rank's peak memory and median round time
     (K processes time-sharing one card: not a multi-GPU number); then a
     ``torch.profiler`` trace of 5 int8 rounds on rank 0 (kernels,
     staging copies and the host's time inside gloo) and each kernel's
     device time at its sharded shape; last, each rank's
     ``calibrate_link`` fit over the gloo group for ``persistent``,
     ``compressed:int8`` and ``compressed:int8/ring`` (host staging and
     time-slicing on one card, never an NVLink number);
  9. the trade-off path (``repro_torch.core.tradeoff``), at the main
     shape: ``sweep_H`` of CoCoA under ``compressed:int8`` with
     ``solver="scd_kernel"`` over H in (256, 1024, 4096, 16384), up to
     2000 rounds a point, ``measure=True`` (each point's t_solver and
     t_ref at H = n_local by ``measure_solver_time``), the launch
     counters set to 0 just before and read just after: K1, K2 int8 and
     K3 int8 once a round run or timed, no other kernel; the
     least-squares slope and intercept of t_solver(H); then each point
     again on one trainer whose data every H shares (rounds-to-eps must
     be the sweep's, its launches and peak memory), and a
     ``torch.profiler`` trace of 3 of its rounds (K1's device time a
     launch beside t_solver, the host's share of the round); H*,
     time-to-eps and the compute fraction at H* for the seven profiles
     under a ``TimeModel`` on ``synthetic_link(1e9, 1e-4)`` with the
     sweep's bytes, under ``stale:k=2`` and under
     ``straggler:mix(p=0.5,slow=16)`` (model only); ``autotune_H`` over
     [256, 16384] for ``E_mpi`` and ``D_pyspark_c`` on live, cached
     rounds-to-eps, each cost at most twice the grid's best; and a small
     sweep (m 96, n 256, K 4, H in (16, 32, 64)) on the card and on the
     CPU on one replayed stream per H: the same rounds-to-eps and each
     point's per-round primal at rtol 1e-4;
  10. the transformer local-updates path (``repro_torch.optim.
     local_updates.virtual_round``): tinyllama-1.1b at full width
     (d_model 2048, 32 heads, 4 kv heads, d_ff 5632, vocab 32,000; all 22
     layers), bf16 params, f32 AdamW, per-layer remat, a cosine schedule
     warmed up over one round, K = 4 virtual data shards on the card, H =
     2, batch 4 x seq 512 a shard from ``TokenStream(seed=0)``, under
     ``f32`` (the exact mean, no codec kernel) and ``compressed:int8`` (K2
     and K3) for 3 rounds and ``compressed:ef:topk(r=0.01)`` (K4 and the
     topk decode) for 2 rounds, the launch counters set to 0
     just before each path and read just after. Each path must: lower
     the loss from the first step (the shards' mean) to the last round's
     last step; launch its codec kernels once a leaf a round (12 leaves)
     and no other kernel; put on the wire, twice the bytes of the encoded
     parts, exactly ``delta_wire_bytes``; keep every param finite; and, in
     round 1, give at the largest leaf and at ``embed`` the same parts,
     mean (and ``ef:`` residual) through the kernels as through the plain
     versions, bit for bit. Printed: tokens/s, each round split into the
     local steps and the exchange (CUDA events), each codec kernel's
     events and device time at the largest leaf beside its byte bound,
     its plain version and (K4) ``torch.topk``, a ``torch.profiler`` trace
     of one local step (the top kernels, the matrix products' share, the
     busy share), and the peak memory. Then the same for the other
     families (``LM_ROWS``), 2 rounds each, at their published widths cut
     (layers, then experts, then vocab, then d_model, each cut in the
     row's ``reduced`` field) until the row fits: mamba2-2.7b at 24 of
     64 layers under ``int8`` and at 16 under ``ef:int4`` (K2 and K3 in
     their int4 form), recurrentgemma-9b at one (rglru, rglru,
     attn_local) cycle with a vocab of 81,920, chatglm3-6b at 4 of 28
     layers, whisper-tiny whole (its 1,500 frames in every batch) under
     ``int8`` and ``ef:int2``, qwen2-vl-72b at 1 of 80 layers with a
     vocab of 24,576 (256 patch embeddings in every batch),
     llama4-maverick-400b-a17b at 1 of 48 layers with 2 of 128 experts
     and a vocab of 81,920, deepseek-v3-671b at one dense and one MoE
     layer with the MTP head, 16 of 256 experts, a vocab of 16,384 and
     d_model 3584; each at lr 1e-4 scaled by 5632 over its widest
     product input (``lm_lr``). Each row also prints its predicted peak
     beside the measured one, its aux and MTP losses, the plan of its
     encode kernel at its largest leaf (checked before the row runs), and
     holds two bf16 gradients of one more step from the same params bit
     for bit (a traced step for tinyllama's rows and mamba2's ``int8``);
  10b. each of the eight archs trained at ``.reduced()``: one train step's
     loss, its CE, aux and MTP terms (rtol 1e-5) and every gradient leaf
     (within 1e-4 of the leaf's largest |CPU| value, floored at 1e-4) in
     f32 on the card against the CPU on the same params and batch
     (whisper's frames, qwen2-vl's patches), and the bf16 step twice on
     the card with bit-equal gradients;
  11. serving (``repro_torch.serve.greedy_generate``) at full width,
     random bf16 params (seed 0), seeded prompts over the whole vocab:
     tinyllama-1.1b (22 layers, B = 8, prompt 512, 64 new tokens),
     nemotron-4-15b (arXiv:2402.16819: 32 layers, d_model 6144, 48/8
     heads, d_ff 24,576, vocab 256,000), mamba2-2.7b (arXiv:2405.21060:
     64 SSD layers, d_model 2560, 80 heads of 64, state 128),
     recurrentgemma-9b (arXiv:2402.19427: 36 layers, 24 RG-LRU of width
     4096 and 12 local attention, window 2048), chatglm3-6b
     (arXiv:2406.12793: 28 layers, d_model 4096, 32/2 heads, d_ff
     13,696, qkv bias, 2d RoPE), whisper-tiny (arXiv:2212.04356: 4
     encoder and 4 decoder layers, d_model 384, 6 heads, 1,500 encoder
     frames, prompt 224, 64 new), command-r-35b (40 layers, d_model 8192,
     d_ff 22,528; 60.6 GB of weights) and, last, qwen2-vl-72b
     (arXiv:2409.12191: d_model 8192, 64/8 heads, d_ff 29,568, vocab
     152,064, M-RoPE; 32 of its 80 layers, 61.2 GB; its prompt opening
     with 256 patch embeddings on a (t = 0, h, w) 16 x 16 grid), then the
     MoE family: llama4-maverick-400b-a17b (2 of its 48 layers, d_model
     5120, 40/8 heads, 128 experts of 8192, top 1, and a shared expert,
     vocab 202,240 padded; 69.33 GB) and deepseek-v3-671b (5 of its 61
     layers: the 3 dense prologue layers, d_ff 18,432, and 2 MoE layers
     of 256 experts of 2048, top 8, and a shared expert; MLA with q_lora
     1536 and kv_lora 512, its latent cache; the MTP head drawn; 54.62
     GB), both at the capacity factor of 1.25; B = 8,
     prompt 512, 32 new but where named; the launch counters set to 0
     just before each and read just after (none of K1-K4 or ``bmv`` may
     launch). Checks: the prefill's logits equal ``forward_train``'s
     with the same frames or patches; every decoded position's
     log-softmax within 0.15 of the full forward over the prompt and
     the ids before it (teacher forcing), and each id its argmax where
     that forward's top-two gap exceeds 0.15; for mamba2,
     recurrentgemma and command-r (at 16 layers) that pair held on a
     second run in f32 within 1e-3, the bf16 run's drift printed
     (``SERVE_PATHS``); the MoE archs' on the same weights with
     capacity_factor = num_experts (no drops, as in a decode step) at B 1
     and a prompt of 64, in bf16 (llama4) or, printing the bf16 run, on
     f32 weights at 4 layers within 1e-3 (deepseek), with the positions
     whose experts differ between the decode and teacher forcing
     printed, in the prompt and among the decoded, and deepseek's bf16
     run again with its decode steps' MLA in the prefill's form
     (``mla_decode_rebuilt``); qwen2-vl's decode held on the prompt as text only (the
     reference's cache keeps one patch of a patch prompt: every
     patch has t = 0), the patch prompt's error printed; each attention
     cache's ``pos_abs`` the positions 0 ... S + n - 2 at ``pos % T``
     (qwen2-vl: slot 0 holds 0, slots 1 ... 255 -1); whisper's cross k
     and v the prefill's tensors, addresses and values after the decode;
     the state bytes as ``state_bytes`` gives them (a KV cache B T (2 KV
     Dh 2 + 4), ``{h, conv}`` B (h 4 + (d_conv - 1) width 2), whisper's
     cross k and v 2 B source_len KV Dh 2 a layer, an MLA cache B T (2
     (kv_lora + rope) + 4)). Printed beside their
     bounds and the card's name and power limit: prefill ms and decode
     ms a step (median and max after the first; CUDA events), tokens/s,
     parameter and state bytes, peak memory over init, prefill and
     decode, and ``torch.profiler`` traces of 5 decode steps and of one
     prefill (kernels, busy share, matrix products' device time, top
     kernels); then the ported archs at ``.reduced()`` in f32 on the
     same params on the card and on the CPU (qwen2-vl with 9 patches,
     whisper with its frames): equal greedy ids, logits at rtol 1e-4;
     and deepseek-v3's ``lm_loss`` with its MTP term at ``.reduced()``
     in f32, forward only, on both at rtol 1e-4;
  12. the local-update rounds across ranks
     (``local_updates_round(..., axis_name=<Fabric>)``), phase 10's model
     and settings, 2 rounds a path with the opt state synced, the launch
     counters set to 0 just before each path and read just after. 12a: a
     1-rank NCCL group in this process, tinyllama-1.1b at all 22 layers,
     ``int8`` and ``ef:topk(r=0.01)``: ``virtual_round`` at K = 1 twice
     first (the card's step must be deterministic), then every round's
     params SHA-256 equal to it, the delta exchange's logged operands
     equal to the encoded parts' bytes, the opt-state sync's to mu's and
     nu's, no copy staged, the codec's kernels once a leaf a round, and
     in round 1 at ``embed`` and the largest other leaf this rank's
     encoded row, the decode+mean of the gathered parts (and the ``ef:``
     residual) equal to the plain versions' on the same inputs bit for
     bit, as each kernel's output where it is timed; printed: tokens/s, each round split by CUDA events (local steps /
     delta exchange / opt-state sync), the calls into the group (events
     and host seconds), each kernel at the largest leaf's (1, L) row
     beside its bound, its plain version and (K4) ``torch.topk``, the
     peak memory. 12b: 4 gloo ranks on ``cuda:0`` at the deepest depth
     whose ranks fit 64 GB (one rank's peak fitted from one-shard rounds
     at 2 and 4 layers, plus 1 GB of context each), ``f32``, ``int8`` and
     ``ef:topk(r=0.01)``, against ``virtual_round`` at K = 4 run twice
     first: every rank's hash equal each round, round 1 equal to the
     virtual run's under a lossy codec and within one bf16 ulp of it
     under ``f32`` (the all-reduce adds in gloo's order), the bytes
     derived from every rank's delta and opt-sync calls equal to
     ``delta_wire_bytes`` and to 2 K 4 bytes a float of mu and nu, the
     wire dtypes, the launches, the loss falling, and on every rank
     12a's check against the plain versions at round 1's two leaves
     (``embed`` and a layer stack); printed: each round's
     split, the host's seconds inside the group's calls and in the
     staging copies, tokens/s (time-slicing on one card, not a
     multi-GPU number), each rank's peak; then 2 steps of
     ``make_train_step(grad_sync_axis=...)`` on the same ranks, whose
     params must agree;
  13. ``python -m repro_torch.analysis --cells all --inject wire-f32`` on
     4 gloo ranks on ``cuda:0``: every reference cell free of error
     findings, the injected cell tripping wire-dtype and bytes-match;
  14. the partitioned paths (``repro_torch.launch.build`` on DTensors):
     (a) on a (1, 1) ``("data", "model")`` mesh over a 1-rank NCCL
     group, tinyllama-1.1b at full width: one ``lower_train`` step and
     one ``lower_train_local_updates`` round (``int8``, K2 and K3
     launched) bit for bit against the unpartitioned step and round
     (the round also against phase 12a's hash), then a
     ``lower_prefill`` and 8 greedy steps through ``lower_decode``,
     ids and logits bit for bit against ``greedy_generate``'s; each
     step's ms and kernels both ways; (b) llama4-maverick at 2 of 48
     layers on the same mesh: its MoE block on DTensors takes
     ``_moe_sharded`` (the path counter) and equals ``moe_apply`` bit
     for bit, and so does the prefill; (c) 4 gloo ranks on ``cuda:0`` as
     a (2, 2) mesh, one deepseek-v3 MoE layer at d_model 7168, top 8,
     d_expert 2048, 16 of 256 experts, f32, no drops: each rank's rows
     within 1e-5 of the largest of the single-process ``moe_apply``'s,
     the logged all-to-all bytes equal to 2 E C_loc d 4 (tp - 1) / tp;
     (d) the dry-run and roofline of six pairs on a fake 16 x 16 group
     (``--mesh-dry-run``, a child on the host started before phase 12).
     ``--only-mesh`` builds the kernels and runs phase 14 alone;
  15. the bench harness (``repro_torch.bench``): ``BENCH_SPECS``, three
     specs registered here, time K1, K2 and K3 (``int8``) and K4 at the
     main path's shapes by ``bench.trace.device_ms``, with their bounds
     from ``bench.bounds.kernel_bounds`` as counters, through
     ``run.run_benchmarks`` into a temporary directory: each ``ok``, each
     file loaded back by ``schema.load`` with an ``env`` naming the card
     and its power limit as nvidia-smi prints them, ``compare`` of each
     file against itself exiting 0 and of K1's against a copy with its
     time doubled exiting 1 with REGRESSION; a fourth spec sleeping
     past a 1 s budget must come back ``timeout``. Printed: each
     kernel's device time beside phase 5's.

Every bound is ``repro_torch.bench.bounds``'s and every device time
``repro_torch.bench.trace``'s, at the card's peaks in
``repro_torch.launch.mesh``.

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
import math
import os
import shutil
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
# when this process began running this file (a spawned rank of phase 8
# reports it, to split its start-up time)
LOADED_AT = time.time()
# phase 10's ef: path holds ~68 GB at its largest leaf; without
# expandable segments the caching allocator strands ~12 GB there. Set
# before the imports below bring in torch
os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")

from repro_torch.bench import compare, registry, run, schema  # noqa: E402
from repro_torch.bench.bounds import (bound_ms, codec_bounds,  # noqa: E402
                                      dense_products, kernel_bounds,
                                      lm_predicted_peak, state_bytes,
                                      step_weight_bytes)
from repro_torch.bench.trace import device_ms, device_trace, time_ms  # noqa: E402
from repro_torch.launch.mesh import CARD_BYTES, PEAK_FLOPS_BF16  # noqa: E402


# the paths phase 3 drives, and the codec whose kernels each launches
TOPK_R = 0.125
TOPK = f"compressed:ef:topk(r={TOPK_R:g})"
PATHS = (("compressed:int8", "int8"), ("compressed:ef:int4", "int4"),
         ("compressed:ef:int2", "int2"), (TOPK, "topk"),
         (f"{TOPK}/stale:k=2/drop:1@5-9", "topk"))
CHECKED = ("compressed:int8", "compressed:ef:int4", TOPK)     # phase 4
# the long-row path (phase 4b), and the shapes phase 2 adds for each
# kernel, which its first designs refused (and the long-row path's own
# K2 shape, in registers at C = 16): K1 (K, m, n_pad, H, forced C or
# None), K2 and K3 (K, L), K4 ((K, L), k)
LONG_PATHS = (("compressed:int8", "int8"), (TOPK, "topk"))
SCD_LONG = ((8, 350000, 128, 128, None), (8, 262148, 128, 64, 4),
            (2, 4096, 65536, 256, None))
QUANT_LONG = ((8, 1048579), (8, 350000))
TOPK_LONG = (((8, 350000), 43750), ((1, 1000000), 1), ((2, 200003), 200003))
# K4's and K2's grid forms, forced, in phase 2b: rows of integer ties in
# [-3, 3], all zeros, one nonzero and normal; L not a multiple of 4
GRID_LONG = ((4, 1000003),)
# phase 5: both forms at the lengths on each side of the plans' switch to
# the grid form (kernels/topk.py::takes_grid: 2^21 at r = 0.01, webspam's
# 350,000 at r = 0.125, which timing_long's long row times by C;
# kernels/quant.py::takes_grid: 2^22)
GRID_CROSSOVER = ((8, 1000000), (8, 2097152), (8, 4194304))
# the baselines phase (after 4b), at the main shape: mini-batch SCD
# (H = n_local, up to SCD_ROUNDS rounds, rounds-to-eps at each of
# BASELINE_EPS; 4e-3 is the drivers benchmark's int8 multiplier for
# mini-batch SCD, benchmarks/bench_drivers.py), then mini-batch SGD's
# virtual-driver paths (name, exchange, H, batch_frac, rounds, codec)
# and the legacy loop; SMALL_BASELINES run on the card and on the CPU
SCD_ROUNDS = 300
BASELINE_EPS = (1e-3, 4e-3)
SGD_PATHS = (("sgd_h1", "compressed:int8", 1, 1.0, 100, "int8"),
             ("sgd_h1", TOPK, 1, 1.0, 100, "topk"),
             ("local_sgd", "compressed:ef:int4/drop:1@5-9", 4, 0.1, 100,
              "int4"))
LEGACY_FRAC, LEGACY_ROUNDS = 0.1, 20
SMALL_BASELINES = (("minibatch_scd", "compressed:int8", None, None),
                   ("sgd_h1", "compressed:int8", 1, 1.0),
                   ("local_sgd", "compressed:ef:int4/drop:1@3-5", 4, 0.5))
# the sharded phases (7 and 8): a 1-rank NCCL group at one worker's
# shape (n = NCCL_N, K = 1) against the virtual driver at K = 1, then
# one process per worker on the one card in a gloo group at the main
# shape, each path against a virtual run on the same index stream
# ((algorithm, exchange, rounds); None: up to the virtual run's
# rounds-to-eps)
NCCL_N, NCCL_ROUNDS = 4096, 5
NCCL_PATHS = ("persistent", "spark_faithful", "reduce_scatter",
              "compressed:int8", TOPK, "compressed:int8/ring")
GLOO_PATHS = (("cocoa", "compressed:int8", None),
              ("cocoa", "compressed:int8/ring", None),
              ("cocoa", f"{TOPK}/stale:k=2/drop:1@5-9", None),
              ("cocoa", "persistent", 10),
              ("minibatch_scd", "compressed:int8", 5),
              ("sgd_h1", "compressed:int8", 5))
GLOO_TRACE_ROUNDS = 5
# CPU ops of the rank-0 trace whose host time is summed: the process
# group's calls (the host's wait inside gloo) and the staging copies
GLOO_HOST_OPS = ("gloo", "c10d", "aten::copy_", "aten::_to_copy",
                 "cudaMemcpy", "cudaStreamSynchronize")
# the trade-off phase (9): CoCoA's H sweep at the main shape (each point
# run to eps, then timed by measure_solver_time: a warm-up round and 3
# timed ones, at every H and at H = n_local), each point again on a
# trainer that shares the data, SWEEP_TRACE_ROUNDS of it traced, the
# seven profiles under three time models on the reference's
# single-device stand-in link, autotune_H over the grid's span for
# TUNED, and a small sweep on the card and on the CPU on replayed per-H
# streams
SWEEP_GRID = (256, 1024, 4096, 16384)
SWEEP_EXCHANGE = "compressed:int8"
SWEEP_MAX_ROUNDS = 2000
MEASURED_ROUNDS = 4
SWEEP_TRACE_ROUNDS = 3
STAND_IN_LINK = (1e9, 1e-4)       # synthetic_link(bandwidth B/s, latency s)
MODELS = {"sync": "", "stale:k=2": "/stale:k=2",
          "straggler:mix(p=0.5,slow=16)": "/straggler:mix(p=0.5,slow=16)"}
TUNED = ("E_mpi", "D_pyspark_c")
SMALL_SWEEP_GRID, SMALL_SWEEP_ROUNDS = (16, 32, 64), 60
# calibrate_link on the sharded phases' groups
CALIBRATED_NCCL = ("persistent", "compressed:int8")
CALIBRATED_GLOO = ("persistent", "compressed:int8", "compressed:int8/ring")
# the transformer phase (10): tinyllama at full width trained by local-
# update rounds over K virtual data shards on the one card, its delta
# exchange through the codecs' kernels. Paths: (label, codec, layers
# (None: all 22), rounds). The schedule warms up over one
# round's H steps: under the default 100-step warmup the first steps'
# updates (~1e-6 at lr 1e-4) fall below half a bf16 ulp of the weights
# (~0.02, ulp 1.2e-4) and leave them where they are. Adam's first steps
# move every weight by about lr * lr_scale, all in the descent
# direction, so a layer's pre-activations move by about that times its
# fan-in (2048): at lr 1e-3 (5e-4 a weight) the loss rose from 10.8 to
# 15-17 before it fell, on an H100.
LM_ARCH = "tinyllama-1.1b"
LM_K, LM_H, LM_BATCH, LM_SEQ, LM_LR = 4, 2, 4, 512, 1e-4
# The other rows scale LM_LR by LM_FAN_IN / their widest product input
# (``lm_fan_in``; tinyllama's is its d_ff, 5632), capped at LM_LR: by the
# reasoning above a row whose fan-in is 2.4x (chatglm3's d_ff 13,696) to
# 5.2x (qwen2-vl's 29,568) tinyllama's at lr 1e-4 takes the kick lr
# 2.4e-4 to 5.2e-4 gives tinyllama: at lr 1e-4 the loss of chatglm3-6b
# (4 layers) and of deepseek-v3 (2 layers) rose over two rounds on an
# H100
LM_FAN_IN = 5632
# Rows: (arch, cuts, codec, rounds); cuts are the config fields a row
# changes ("num_layers", "vocab_size", "d_model"; "num_experts" and
# "first_k_dense" of its moe), listed in its line's ``reduced``. The other
# families run at their published widths, cut by one rule until the
# row fits the card's 85 GB with ~10 GB to spare (``lm_predicted_peak``:
# 44 B a param at K = 4, 60 B under ef:, 28 B an element of the largest
# leaf, 16 B a logit, 1.5 GB): the layers first, one of each block kind
# kept; then the experts, to no fewer than 2 top_k; then the vocab (a
# multiple of 256); only then d_model, alone (no other width of theirs is
# a multiple of it). Below, each row's params and predicted peak.
LM_ROWS = (
    ("tinyllama-1.1b", {}, "f32", 3),
    ("tinyllama-1.1b", {}, "int8", 3),
    ("tinyllama-1.1b", {}, "ef:topk(r=0.01)", 2),
    # ssm: 24 of 64 layers, 1.223 B params (40.2 M a layer and 0.258 B of
    # embed and unembed; the (24, 2560, 10576) in-projection 650 M
    # elements; 75.2 GB); 64 would be 2.83 B. Under ef:int4 16 layers,
    # 0.902 B (69.4 GB)
    ("mamba2-2.7b", {"num_layers": 24}, "int8", 2),
    ("mamba2-2.7b", {"num_layers": 16}, "ef:int4", 2),
    # hybrid: one (rglru, rglru, attn_local) cycle, 0.657 B; beside it the
    # published 256,000-row embed and unembed (2.10 B) make 2.75 B, so
    # the vocab is cut to 81,920: 1.328 B (72.0 GB)
    ("recurrentgemma-9b", {"num_layers": 3, "vocab_size": 81920}, "int8",
     2),
    # dense with 2d RoPE: 4 of 28 layers (0.204 B a layer, 0.533 B of
    # embed and unembed), 1.349 B (70.4 GB)
    ("chatglm3-6b", {"num_layers": 4}, "int8", 2),
    # audio: whole, 0.049 B (5.9 GB; 6.7 under ef:int2)
    ("whisper-tiny", {}, "int8", 2),
    ("whisper-tiny", {}, "ef:int2", 2),
    # vlm: 1 of 80 layers (0.876 B); its 152,064-row embed and unembed
    # (2.49 B) cut to 24,576 rows: 1.280 B (65.4 GB)
    ("qwen2-vl-72b", {"num_layers": 1, "vocab_size": 24576}, "int8", 2),
    # moe top-1: 1 of 48 layers; its 128 experts of 5120 x 8192 (16.1 B)
    # cut to 2 (0.444 B with the shared expert and attention); the
    # 202,048-row embed and unembed (2.07 B) to 81,920: 1.279 B (72.2 GB)
    ("llama4-maverick-400b-a17b",
     {"num_layers": 1, "num_experts": 2, "vocab_size": 81920}, "int8", 2),
    # moe top-8 with MLA and MTP: one dense prologue layer and one MoE
    # layer of 61 (first_k_dense 3 -> 1) and the MTP module; 256 experts
    # cut to 16. At d_model 7168 that is 2.21 B without any vocab, so
    # the vocab goes to 16,384 and d_model to 3584: 1.276 B (62.0 GB)
    ("deepseek-v3-671b",
     {"num_layers": 2, "first_k_dense": 1, "num_experts": 16,
      "vocab_size": 16384, "d_model": 3584}, "int8", 2),
)
# the rows whose extra step is traced: tinyllama's and the one with the
# largest predicted peak
LM_TRACED = {("tinyllama-1.1b", "f32"), ("tinyllama-1.1b", "int8"),
             ("tinyllama-1.1b", "ef:topk(r=0.01)"), ("mamba2-2.7b", "int8")}
LM_REPS = 3
# phase 10b: one train step of each arch at .reduced(), batch x seq, on
# the card and on the CPU in f32, then twice on the card in bf16
LM_SMALL_ARCHS = ("tinyllama-1.1b", "mamba2-2.7b", "recurrentgemma-9b",
                  "chatglm3-6b", "whisper-tiny", "qwen2-vl-72b",
                  "llama4-maverick-400b-a17b", "deepseek-v3-671b")
LM_SMALL = (2, 64)
LM_SMALL_RTOL, LM_SMALL_GRAD_TOL, LM_SMALL_GRAD_FLOOR = 1e-5, 1e-4, 1e-4
# the serving phase (11): greedy generation through
# repro_torch.serve.greedy_generate at full width, random bf16 params
# (seed 0) and seeded prompts over the whole vocab. Paths: (arch, layers
# served (None: all), batch, prompt, new tokens, the dtype holding the
# decode against teacher forcing, its layers (None: those served)).
# command-r-35b runs with the card otherwise empty: 60.6 GB of weights,
# and its checks hold two (8, 512, 256,000) f32 logits blocks, 4.2 GB
# each; then qwen2-vl-72b at 32 of its 80 layers (877.8 M params, 1.756
# GB a layer; with embed and unembed, 4.98 GB, 61.2 GB: 80 layers would
# be ~145 GB), its prompt opening with SERVE_PATCHES patch embeddings.
# whisper-tiny's batch carries its encoder's 1,500 frames. In bf16 two
# computations of the same positions that differ only in their shapes
# (a decode step's 8 rows, a forward's 4,344) round apart, and through
# a deep random model the difference grows past 0.15: about 0.2 at 36-40
# layers, and along the decoded positions of mamba2 to 0.59, in the
# reference too (mamba2 at 16 layers, B 1, prompt 256: 0.094 -> 0.199 on
# the CPU, jax; tests/torch_bf16_witness.py, PERF.md). So those paths
# are held in f32 (params from the same seed, f32 states; command-r's
# f32 weights fit at 16 layers), their bf16 drift printed beside it.
# chatglm3-6b, whisper-tiny and qwen2-vl-72b at 32 layers stay within
# 0.15 in bf16 (0.094, 0.016, 0.109 on an H100). qwen2-vl's decode is
# held on the prompt as text only: the reference's cache keeps one
# patch of a patch prompt (every patch has t = 0 and so slot 0), where
# teacher forcing sees all of them. Last, the MoE family, cut only in
# depth: llama4-maverick-400b-a17b at 2 of its 48 layers (128 experts of
# 8192, top 1, and a shared expert; 69.33 GB, 48 layers would be 1.57
# TB) and deepseek-v3-671b at 5 of its 61 (its 3 dense prologue layers
# and 2 MoE layers of 256 experts of 2048, top 8, and a shared expert;
# MLA; the MTP head, drawn, not run; 54.62 GB, 6 layers would be 77.6
# GB), at the configured capacity factor of 1.25 (a prefill drops the
# assignments over an expert's C = int(1.25 top_k T / E) rows; a decode
# step drops none). Their decode is held against teacher forcing
# ("no-drop") on the same weights with capacity_factor = num_experts, so
# that the full forward drops no token either, at SERVE_TF_NO_DROP's B 1
# and prompt 64: without drops every expert's slab is T top_k rows
# (deepseek's at B 8 and prompt 512 would gather 127 GB). deepseek's is
# held in f32 ("f32-no-drop", at 4 layers: its 3 dense and 1 MoE, 63.19
# GB in f32), its bf16 run printed: its router's 8th and 9th of 256
# experts sit close enough that a bf16 rounding difference changes an
# expert, and so the layer's output, at some positions. The prefill's
# full forward and teacher forcing's, which differ only in length,
# already route 14 of the prompt's 64 positions apart on an H100, and
# MLA's absorbed decode, in f32 where the prefill rounds the rebuilt
# keys and values to bf16, adds to it (0.367; its decode rebuilt as the
# prefill's, 0.282, the decoded positions changing an expert 11 -> 7).
# The reference drifts alike: 0.39 at deepseek's MLA widths and router
# with d_model 1024 on the CPU (tests/torch_bf16_witness.py)
SERVE_PATHS = (("tinyllama-1.1b", None, 8, 512, 64, "bf16", None),
               ("nemotron-4-15b", None, 8, 512, 32, "bf16", None),
               ("mamba2-2.7b", None, 8, 512, 32, "f32", None),
               ("recurrentgemma-9b", None, 8, 512, 32, "f32", None),
               ("chatglm3-6b", None, 8, 512, 32, "bf16", None),
               ("whisper-tiny", None, 8, 224, 64, "bf16", None),
               ("command-r-35b", None, 8, 512, 32, "f32", 16),
               ("qwen2-vl-72b", 32, 8, 512, 32, "bf16", None),
               ("llama4-maverick-400b-a17b", 2, 8, 512, 32, "no-drop", None),
               ("deepseek-v3-671b", 5, 8, 512, 32, "f32-no-drop", 4))
SERVE_TF_TOL = 0.15          # tests/test_models_smoke.py's decode bound
SERVE_TF_NO_DROP = (1, 64)   # batch, prompt of the no-drop teacher forcing
# in f32: ten times the f32 logits' rtol of 1e-4, at logits of ~10
SERVE_TF_TOL_F32 = 1e-3
SERVE_TRACE_STEPS = 5
# a vlm prompt's patches: input_specs' min(num_patch_tokens, S // 2)
# (256 at a 512 prompt: one 448 x 448 image after Qwen2-VL's 2 x 2
# merge), cut to the largest square, on a (t = 0, h, w) grid
SERVE_PATCHES = 256
# the small card-vs-CPU run: the ported archs at .reduced() in f32
SERVE_SMALL = (4, 24, 12)
# the local-update rounds across ranks (12): phase 10's model and
# settings, one process a data shard, each round's delta exchange and
# opt-state sync through comm.collectives.Fabric, LU_ROUNDS rounds a path
# with the opt state synced. 12a: a 1-rank NCCL group in this process at
# all 22 layers, against virtual_round at K = 1 by params hash. 12b: LU_K
# gloo ranks on the one card at the deepest depth whose ranks' peaks, plus
# LU_CONTEXT_BYTES of CUDA context each (an allowance, not a
# measurement), fit LU_GLOO_BYTES, a rank's peak fitted from one-shard
# rounds at LU_PROBE_LAYERS; then LU_GRAD_SYNC_STEPS steps of
# make_train_step(grad_sync_axis=...) on the same ranks. virtual_round
# runs twice on each path first: hashes compare only if the card's step
# is deterministic
LU_NCCL_PATHS = ("int8", "ef:topk(r=0.01)")
LU_GLOO_PATHS = ("f32", "int8", "ef:topk(r=0.01)")
LU_ROUNDS, LU_K, LU_GRAD_SYNC_STEPS = 2, 4, 2
LU_GLOO_BYTES, LU_CONTEXT_BYTES = 64e9, 1e9
LU_PROBE_LAYERS = (2, 4)
# the partitioned paths (14): a (1, 1) ("data", "model") mesh over a
# 1-rank NCCL group, the steps built by repro_torch.launch.build on
# DTensors and held bit for bit against the unpartitioned ones. 14a:
# phase 10's tinyllama (22 layers, its batches, lr and schedule): one
# lower_train step, one lower_train_local_updates round (int8, H = LM_H)
# and MESH_DECODE[2] greedy decode steps through lower_decode after a
# lower_prefill of MESH_DECODE[1] tokens a row. 14b: MESH_MOE's arch at
# phase 11's widths and its layers, the prefill through _moe_sharded. 14c:
# LU_K gloo ranks on the card as a (2, 2) mesh, one MoE layer of
# MESH_GLOO's arch at its published widths, its experts cut to fit, in
# f32 without drops (capacity_factor = num_experts). 14d: the dry-run
# and roofline (launch.dryrun, launch.roofline) of MESH_DRY on a fake
# 16 x 16 group on the card's host
MESH_DECODE = (8, 512, 8)          # rows, prompt, decode steps
MESH_MOE = ("llama4-maverick-400b-a17b", 2, 8, 512)  # arch, layers, B, S
MESH_GLOO = dict(arch="deepseek-v3-671b", experts=16, batch=4, seq=64)
MESH_GLOO_RTOL = 1e-5
MESH_DRY = (("tinyllama-1.1b", "train_4k"), ("tinyllama-1.1b", "decode_32k"),
            ("deepseek-v3-671b", "train_4k"),
            ("deepseek-v3-671b", "decode_32k"),
            ("mamba2-2.7b", "prefill_32k"), ("whisper-tiny", "decode_32k"))
# phase 15: specs registered here (not in the harness's DEFAULT_MODULES),
# each timing kernels (KERNEL_NAMES' keys) at the main path's shapes,
# run by repro_torch.bench.run; then one that sleeps BENCH_SLEEP[0] s
# past a budget of BENCH_SLEEP[1] s and must come back "timeout"
BENCH_SPECS = {"chip_smoke_k1": ("scd_solve",),
               "chip_smoke_k2_k3_int8": ("int8", "decode_int8"),
               "chip_smoke_k4": ("topk",)}
BENCH_SLEEP = (3.0, 1.0)
# substrings of the names of cuBLAS's matrix-product kernels
LM_GEMM = ("gemm", "xmma", "cutlass", "sm90_", "nvjet")
POWER_ITERS = 30
CODECS = ("int8", "int4", "int2")
BITS = {"int8": 8, "int4": 4, "int2": 2}
# K2 and K4 run at the planned C (None) and at every C forced
CLUSTER_RUNS = (None, 16, 8, 4, 2, 1)
# the names of each timed wrapper's __global__ functions, as the profiler
# reports them (substrings of the demangled names): every kernel of each
# of its forms (K4's and K2's grid forms launch several) and none of
# torch.topk's
TOPK_KERNELS = ("topk_kernel", "topk_grid_")
KERNEL_NAMES = {"scd_solve": "scd_kernel", "topk": TOPK_KERNELS,
                "topk_k_eq_L": TOPK_KERNELS,
                "topk_device_form": TOPK_KERNELS,
                **{c: (f"quant_kernel<{8 // b},", "quant_grid_init",
                       "quant_grid_absmax", f"quant_grid_pack<{8 // b}>")
                   for c, b in (("int8", 8), ("int4", 4), ("int2", 2))},
                "decode_int8": "dequant_kernel<8,",
                "decode_int4": "dequant_kernel<4,",
                "decode_int2": "dequant_kernel<2,",
                "matvec": "bmv_rows_kernel", "vecmat": "bmv_cols_kernel"}
# the fixed-order batched products' launches a round on each baseline
# path ((matvec, vecmat); CoCoA and the legacy loop launch none): mini-
# batch SCD's A_T w and Delta v; SGD's A_s alpha and resid A_s a step,
# and A alpha for the metric
BMV = ("batched_matvec", "batched_vecmat")


def bmv_per_round(name: str, H=None) -> dict:
    if name == "minibatch_scd":
        per = (1, 1)
    elif name in ("sgd_h1", "local_sgd"):
        per = (H + 1, H)
    else:
        per = (0, 0)
    return dict(zip(BMV, per))


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


def max_err(a, b, chunk: int = 1 << 26) -> float:
    """The largest |a - b| in f64, ``chunk`` elements at a time (a whole
    f64 copy of a transformer leaf's (K, L) stack would not fit)."""
    a, b = a.reshape(-1), b.reshape(-1)
    return max((float((a[i:i + chunk].double() - b[i:i + chunk].double())
                      .abs().max()) for i in range(0, a.numel(), chunk)),
               default=0.0)


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


def dot_bound(n: int) -> float:
    """2 gamma_n: two f32 sums of the same n products, in any two
    orders, differ by at most this times the sum of their magnitudes."""
    u = 2.0 ** -24
    return 2 * n * u / (1 - n * u)


def own_kernels(codec) -> tuple:
    """The kernels a path under ``codec`` launches once a round for its
    exchange (none without a codec kernel)."""
    if codec is None:
        return ()
    if codec == "topk":
        return ("topk_select",)
    return (f"quantize_pack_{codec}", f"decode_reduce_{codec}")


def lipschitz(torch, A, lam: float, iters: int = POWER_ITERS) -> float:
    """``sigma_max(A)^2 + lam``, the Lipschitz constant of the ridge
    gradient, by power iterations on ``A^T A`` (a full SVD of A would
    take far longer)."""
    g = torch.Generator(device=A.device).manual_seed(0)
    v = torch.randn((A.shape[1],), generator=g, device=A.device)
    v = v / torch.linalg.vector_norm(v)
    for _ in range(iters):
        u = A.T @ (A @ v)
        s = torch.linalg.vector_norm(u)
        v = u / s
    return float(s) + lam


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


def link_fields(link) -> dict:
    """A LinkCalibration as a JSON line's fields (an infinite bandwidth
    as the string "inf")."""
    bw = link.bandwidth_Bps
    return dict(bandwidth_Bps=bw if bw != float("inf") else "inf",
                latency_s=link.latency_s, source=link.source)


def sharded_stats(torch, tr, hist, log, counters, K: int, eps: float
                  ) -> dict:
    """What one sharded run of ``tr`` left on this rank: its History,
    launches, K1 plan, peak memory, the bytes and dtypes of its log, and
    the hashes of the final state."""
    from repro_torch.analysis.traffic import (derived_round_traffic,
                                              payload_collectives,
                                              quantized_wire_dtypes)
    from repro_torch.kernels.scd import scd_solve
    from repro_torch.launch.dist import sha256

    rounds = log.rounds()
    sgd = not hasattr(tr, "w_final")
    length = tr.n if sgd else tr.m
    payload = [c for t in rounds for c in payload_collectives(log.of_round(t))]
    return dict(
        primal=hist.primal, rounds=hist.rounds, seconds=hist.seconds,
        rounds_to_eps=hist.rounds_to(eps),
        launches={fn.__name__: fn.launches for fn in counters},
        plan=(dataclasses.asdict(scd_solve.last_plan)
              if scd_solve.launches else None),
        max_memory_allocated=torch.cuda.max_memory_allocated(),
        derived_bytes=[derived_round_traffic(log.of_round(t), tr.exchange, K)
                       for t in rounds],
        model_bytes=[tr.comm_bytes_per_round(t) for t in rounds],
        model_bytes_all_live=tr.comm_bytes_per_round(),
        calls_per_round=len(log) / max(len(rounds), 1),
        staged=sum(c.staged for c in log),
        quantized_dtypes=sorted(quantized_wire_dtypes(log)),
        payload_dtypes=sorted({(c.op, c.dtype) for c in payload}),
        f32_update_payloads=sum(c.dtype == "float32"
                                and c.nbytes >= 4 * length for c in payload),
        shared_sha256=sha256(tr.alpha_final if sgd else tr.w_final),
        local_sha256=None if sgd else sha256(tr.alpha))


def sharded_rank(rank: int, world: int, device, job: dict) -> dict:
    """One rank of the gloo phase: worker ``rank``'s blocks from
    ``job["dir"]``, every path of ``job["paths"]`` on the sharded
    driver, then (rank 0) a trace of 5 int8 rounds and each kernel's
    device time at its sharded shape."""
    import numpy as np
    import torch

    from repro_torch.bench.timing import calibrate_link
    from repro_torch.comm.collectives import Fabric
    from repro_torch.comm.collectives import recording as record_calls
    from repro_torch.core import (CoCoAConfig, CoCoATrainer, MinibatchSCD,
                                  MinibatchSGD, SGDConfig)
    from repro_torch.core.baselines import WorkerRows
    from repro_torch.core.cocoa import WorkerColumns
    from repro_torch.kernels import bmv, dequant, quant
    from repro_torch.kernels.scd import scd_solve
    from repro_torch.kernels.topk import topk_select

    started = time.time() - job["spawned_at"]  # process start and group join
    loaded = LOADED_AT - job["spawned_at"]
    t0 = time.perf_counter()
    torch.zeros((1,), device=device)           # the rank's CUDA context
    torch.cuda.synchronize(device)
    context_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    d = job["dir"]
    b = np.load(os.path.join(d, "b.npy"))
    cols = WorkerColumns(job["part"], rank,
                         np.load(os.path.join(d, f"cols{rank}.npy")),
                         job["n"])
    rows = WorkerRows(rank, np.load(os.path.join(d, f"rows{rank}.npy")),
                      job["m"])
    counters = ([scd_solve, topk_select]
                + [getattr(quant, f"quantize_pack_{c}") for c in CODECS]
                + [getattr(dequant, f"decode_reduce_{c}") for c in CODECS]
                + [bmv.batched_matvec, bmv.batched_vecmat])

    def trainer(name, ex):
        if name == "sgd_h1":
            return MinibatchSGD(SGDConfig(exchange=ex, **job["sgd"]), rows, b,
                                device=device)
        cls = CoCoATrainer if name == "cocoa" else MinibatchSCD
        return cls(CoCoAConfig(exchange=ex, **job["cocoa"]), cols, b,
                   device=device)

    def run(tr, rounds, eps):
        if isinstance(tr, MinibatchSGD):
            return tr.run_sharded(rounds, record_every=1, target_eps=eps,
                                  p_star=job["p_star"], p_zero=job["p_zero"])
        return tr.run_sharded(rounds, target_eps=eps, p_star=job["p_star"])

    out = {"paths": [], "started_s": started, "loaded_s": loaded,
           "cuda_context_s": context_s,
           "blocks_loaded_s": time.perf_counter() - t0}
    for name, ex, rounds, eps in job["paths"]:
        t0 = time.perf_counter()
        tr = trainer(name, ex)
        for fn in counters:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats(device)
        with record_calls() as log:
            hist = run(tr, rounds, eps)
        torch.cuda.synchronize(device)
        out["paths"].append(sharded_stats(torch, tr, hist, log, counters,
                                          world, job["eps"]))
        del tr
        free(torch)
        out["paths"][-1]["wall_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    # 5 int8 rounds, rank 0 under the profiler, the others alongside
    tr = trainer("cocoa", "compressed:int8")
    go = lambda: run(tr, GLOO_TRACE_ROUNDS, None)     # noqa: E731
    if rank == 0:
        out["trace"] = device_trace(go, host=GLOO_HOST_OPS)
    else:
        go()
    # each kernel at its sharded shape: K1 on this worker's block, K2 and
    # K4 on its round-1 row, K3 on the gathered (K, .) payload, the
    # batched products on the block (mini-batch SCD's A_T w and Delta v)
    A_T, col_sq, mask = tr.worker_data(rank)
    alpha0 = torch.zeros_like(mask)
    w0 = -tr.b
    idx = tr.index_source(1)[rank:rank + 1]
    kw = dict(sigma=float(world), lam=job["cocoa"]["lam"], eta=1.0)
    dv, _ = scd_solve(A_T, col_sq, alpha0, w0, idx, **kw)
    q, scale = quant.quantize_pack_int8(dv)
    fab = Fabric()
    qs, scales = fab.all_gather(q), fab.all_gather(scale)
    if rank == 0:
        k = job["topk_k"]
        y = torch.randn(mask.shape, device=device) * 1e-3
        calls = {
            "scd_solve": (lambda: scd_solve(A_T, col_sq, alpha0, w0, idx,
                                            **kw), "scd_kernel", 20,
                          tuple(A_T.shape) + (idx.shape[1],)),
            "quantize_pack_int8": (lambda: quant.quantize_pack_int8(dv),
                                   "quant_kernel<1,", 200, tuple(dv.shape)),
            "decode_reduce_int8": (lambda: dequant.decode_reduce_int8(
                qs, scales, tr.m, mean=False), "dequant_kernel<8,", 200,
                tuple(qs.shape)),
            "topk_select": (lambda: topk_select(dv, k), "topk_kernel", 200,
                            tuple(dv.shape) + (k,)),
            "batched_matvec": (lambda: bmv.batched_matvec(A_T, w0),
                               "bmv_rows_kernel", 20, tuple(A_T.shape)),
            "batched_vecmat": (lambda: bmv.batched_vecmat(y, A_T),
                               "bmv_cols_kernel", 20, tuple(A_T.shape))}
        out["kernels"] = {
            key: dict(shape=list(shape), device_ms=device_ms(
                fn, n, kname), plan=None)
            for key, (fn, kname, n, shape) in calls.items()}
        out["kernels"]["scd_solve"]["plan"] = dataclasses.asdict(
            scd_solve.last_plan)
    out["trace_and_timing_s"] = time.perf_counter() - t0
    # this rank's fit of each exchange's collective over the gloo group
    t0 = time.perf_counter()
    out["links"] = {ex: link_fields(calibrate_link(ex, device=device))
                    for ex in job["calibrate"]}
    out["calibrate_s"] = time.perf_counter() - t0
    return out


def time_codec_kernels(torch, codec_, e, parts, K: int) -> dict:
    """Each kernel of ``codec_``'s exchange at one leaf: its encode (K2,
    or K4) on the (K, L) stack ``e`` and (K3) its decode+mean of
    ``parts``, by events and by the device time of a trace, beside its
    bound, its plain version and (K4) ``torch.topk``, and whether its
    output equals the plain version's on the same inputs bit for bit
    (``equal_to_plain``). The caller restores the launch counters: these
    launches do not count."""
    from repro_torch.kernels import dequant, quant, topk
    L = e.shape[1]
    base = getattr(codec_, "base", codec_)
    if "topk" in codec_.name:
        k = base._k(L)
        fns = {"topk": (lambda: topk.topk_select(e, k),
                        lambda: topk.topk_select_ref(e, k))}
        lib = {"topk": lambda: torch.topk(e.abs(), k, dim=1, sorted=True)}
    else:
        c = base.name
        p_, s_ = parts
        enc, dec = (getattr(quant, f"quantize_pack_{c}"),
                    getattr(dequant, f"decode_reduce_{c}"))
        enc_ref = getattr(quant, f"quantize_pack_{c}_ref")
        dec_ref = getattr(dequant, f"decode_reduce_{c}_ref")
        fns = {c: (lambda: enc(e), lambda: enc_ref(e)),
               f"decode_{c}": (lambda: dec(p_, s_, L, mean=True),
                               lambda: dec_ref(p_, s_, L, mean=True))}
        lib, k = {}, 1
    b = codec_bounds(K, L, k)
    timing = {}
    for key, (fn, ref) in fns.items():
        guards = []
        timing[key] = dict(
            shape=[K, L], k=k if key == "topk" else None,
            ms=time_ms(fn, LM_REPS, warmup=1),
            device_ms=device_ms(fn, LM_REPS, KERNEL_NAMES[key],
                                guards),
            plain_ms=time_ms(ref, 1, warmup=0),
            library_ms=(time_ms(lib[key], 1, warmup=1)
                        if key in lib else None),
            bound_ms=b[key][0], bound_by=b[key][1], trace_guard=guards[0])
        got, want = fn(), ref()
        got, want = ((got,), (want,)) if torch.is_tensor(got) else (got, want)
        timing[key].update(
            equal_to_plain=all(bits_equal(torch, a, b)
                               for a, b in zip(got, want)),
            max_abs_err=max(max_err(a, b) for a, b in zip(got, want)))
        del got, want
        if isinstance(timing[key]["device_ms"], float):
            timing[key]["bound_ratio"] = (timing[key]["device_ms"]
                                          / b[key][0])
    return timing


def lm_row_config(arch: str, cuts: dict):
    """A phase 10 row's config: ``arch``'s published one with ``cuts``
    applied (``num_experts`` and ``first_k_dense`` to its moe), and its
    ``reduced`` list, one "field: published -> cut" a cut."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    moe_keys = ("num_experts", "first_k_dense")
    top = {k: v for k, v in cuts.items() if k not in moe_keys}
    moe = {k: v for k, v in cuts.items() if k in moe_keys}
    reduced = [f"{k}: {getattr(cfg, k)} -> {v}" for k, v in top.items()
               if getattr(cfg, k) != v]
    reduced += [f"moe.{k}: {getattr(cfg.moe, k)} -> {v}"
                for k, v in moe.items() if getattr(cfg.moe, k) != v]
    if moe:
        top["moe"] = dataclasses.replace(cfg.moe, **moe)
    return dataclasses.replace(cfg, **top), reduced


def lm_fan_in(cfg) -> int:
    """The widest input of a model's products: d_model, d_ff, the
    attention output's heads x head_dim (MLA's heads x v_head_dim and its
    ranks), the experts' and shared expert's widths, the SSM's d_inner,
    the RG-LRU's width."""
    widths = [cfg.d_model, cfg.d_ff, cfg.num_heads * cfg.head_dim]
    if cfg.moe is not None:
        widths.append(cfg.moe.d_expert * max(cfg.moe.num_shared, 1))
    if cfg.mla is not None:
        widths += [cfg.num_heads * cfg.mla.v_head_dim, cfg.mla.q_lora_rank,
                   cfg.mla.kv_lora_rank]
    if cfg.ssm is not None:
        widths.append(cfg.ssm.d_inner(cfg.d_model))
    if cfg.rglru is not None:
        widths.append(cfg.rglru.lru_width or cfg.d_model)
    return max(widths)


def lm_lr(cfg) -> float:
    """A row's peak learning rate: ``LM_LR`` scaled by ``LM_FAN_IN`` over
    its widest product input, at most ``LM_LR``."""
    return LM_LR * min(1.0, LM_FAN_IN / lm_fan_in(cfg))


def lm_batches(torch, ts, cfg, K: int, H: int, rng, device) -> dict:
    """K shards' H batches of ``LM_BATCH`` x ``LM_SEQ`` tokens from the
    token stream ``ts``, with whisper's frames and a vlm's patch
    embeddings drawn by ``serve_extras`` from ``rng``, as (K, H, ...)
    tensors on ``device``."""
    import numpy as np
    bs = [[ts.next_batch() for _ in range(H)] for _ in range(K)]
    out = {n: torch.tensor(np.stack([np.stack([b[n] for b in row])
                                     for row in bs])).to(device)
           for n in ("tokens", "labels")}
    extras = [[serve_extras(torch, cfg, LM_BATCH, LM_SEQ, rng, device)
               for _ in range(H)] for _ in range(K)]
    for n in extras[0][0]:
        out[n] = torch.stack([torch.stack([e[n] for e in row])
                              for row in extras])
    return out


def codec_kernel_plan(codec, K: int, L: int) -> dict:
    """The plan the row's encode kernel takes at its largest leaf, a
    (K, L) stack (K2's ``quant_plan``, K4's ``topk_plan``), checked
    before the row runs: a leaf past the kernels' int32 indices or a
    plan either refuses raises here, not at a launch. None without a
    codec kernel."""
    from repro_torch.kernels.quant import INDEX_MAX, quant_plan
    from repro_torch.kernels.topk import topk_plan
    if codec.lossless:
        return None
    if L > INDEX_MAX:
        raise SystemExit(f"chip_smoke: a leaf of {L} elements is past the "
                         f"codec kernels' int32 indices ({INDEX_MAX})")
    base = getattr(codec, "base", codec)
    if "topk" in codec.name:
        return dict(kernel="topk_select", **dataclasses.asdict(
            topk_plan(K, L, base._k(L))))
    return dict(kernel=f"quantize_pack_{base.name}", **dataclasses.asdict(
        quant_plan(K, L, base.bits)))


def grads_repeat(torch, model, params, batch) -> dict:
    """Two ``loss_and_grads`` of the same params and batch: whether every
    gradient leaf (and the loss) repeats bit for bit, and the leaves
    that do not."""
    from repro_torch.train import loss_and_grads
    from repro_torch.utils.trees import tree_flatten_with_path
    runs = [loss_and_grads(model, params, batch, remat=True)
            for _ in range(2)]
    keys = [k for k, _ in tree_flatten_with_path(params)]
    differ = [str(k) for k, a, b in zip(keys, runs[0][2], runs[1][2])
              if not bits_equal(torch, a, b)]
    loss_equal = bits_equal(torch, runs[0][0], runs[1][0])
    del runs
    return dict(equal=loss_equal and not differ, loss_equal=loss_equal,
                leaves=len(keys), leaves_differing=differ)


def transformer_phase(torch, counters, device="cuda") -> dict:
    """Phase 10: each row of ``LM_ROWS`` at its peak learning rate
    (``lm_lr``), with the launch counters set to 0 just before and read
    just after; returns the kernels line's ``transformer`` entries by
    kernel name."""
    import functools

    import numpy as np

    from repro_torch.comm.codec import get_codec
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import build_model
    from repro_torch.optim import (AdamWConfig, LocalUpdatesConfig,
                                   adamw_init, cosine_schedule,
                                   delta_wire_bytes, init_delta_codec_state,
                                   local_updates, virtual_round)
    from repro_torch.train import make_train_step
    from repro_torch.utils.device import full_f32_matmul
    from repro_torch.utils.trees import (tree_allfinite, tree_leaves,
                                         tree_params)

    full_f32_matmul()
    entries = {}
    K, H = LM_K, LM_H
    for arch, cuts, codec_name, rounds in LM_ROWS:
        label = f"{arch} {codec_name}"
        t0 = time.perf_counter()
        free(torch)
        held_before = torch.cuda.memory_allocated()
        cfg, reduced = lm_row_config(arch, cuts)
        codec = get_codec(codec_name)
        model = build_model(cfg)
        params = model.init(torch.Generator(device=device).manual_seed(0))
        leaves = tree_leaves(params)
        largest = max(p.numel() for p in leaves)
        embed_len = params["embed"].numel()
        plan = codec_kernel_plan(codec, K, largest)
        n_params = tree_params(params)
        predicted = lm_predicted_peak(cfg, n_params, largest, codec_name,
                                      K=LM_K, batch=LM_BATCH, seq=LM_SEQ)
        lr = lm_lr(cfg)
        opt_cfg = AdamWConfig(lr=lr)
        opt = adamw_init(params, opt_cfg)
        step = make_train_step(model, opt_cfg, remat=True, schedule=(
            functools.partial(cosine_schedule, warmup=H, total=rounds * H)))
        lc = LocalUpdatesConfig(H=H, codec=codec_name)
        state = init_delta_codec_state(params, lc, shards=K)
        want_bytes = delta_wire_bytes(params, lc, K)
        ts = TokenStream(cfg.vocab_size, LM_SEQ, LM_BATCH, seed=0)
        rng = np.random.default_rng(0)
        setup_s = time.perf_counter() - t0

        # events: the round's start, the end of its last shard's steps
        # (the exchange starts), the round's end
        marks, checks, timing, kept, timing_ctx = [], {}, {}, {}, {}
        steps_fn = local_updates._steps
        exchange_fn = local_updates.exchange_leaf
        calls = {"steps": 0, "round": 0}

        def steps_hook(*a, **kw):
            out = steps_fn(*a, **kw)
            calls["steps"] += 1
            if calls["steps"] % K == 0:
                ev = torch.cuda.Event(enable_timing=True)
                ev.record()
                marks[-1]["local_end"] = ev
            return out

        def exchange_hook(codec_, stack, st=None):
            out = exchange_fn(codec_, stack, st)
            L = stack.shape[1]
            if calls["round"] != 1 or codec_.lossless or L not in (
                    largest, embed_len) or L in checks:
                return out
            # round 1, the largest leaf and embed: the kernels' mean
            # against the plain versions' on the same stack (and
            # residual); these launches do not count. The largest leaf's
            # stack and parts are kept for time_largest()
            saved = {fn: fn.launches for fn in counters}
            mean_k, st_k, parts_k = out
            e = stack if st is None else stack + st
            # the plain encode a row at a time (each worker's row is
            # encoded alone), a K-th of its scratch beside the round
            rows_p = [codec_.encode_ref(e[i:i + 1]) for i in range(K)]
            parts_p = tuple(torch.cat(ts_) for ts_ in zip(*rows_p))
            del rows_p
            res = {"parts": all(bits_equal(torch, a, b)
                                for a, b in zip(parts_k, parts_p))}
            mean_p = (codec_.decode_stacked_mean(parts_p, L)
                      if "topk" in codec_.name else
                      getattr(codec_, "base", codec_).decode_reduce_ref(
                          parts_p, L, mean=True))
            res["mean"] = bits_equal(torch, mean_k, mean_p)
            res["max_abs_err"] = max_err(mean_k, mean_p)
            if st is not None:
                res["residual"] = all(bits_equal(
                    torch, st_k[i], e[i] - codec_.decode_stacked(
                        tuple(t[i:i + 1] for t in parts_p), L)[0])
                    for i in range(K))
            del parts_p, mean_p
            checks[L] = res
            if L == largest:
                kept.update(e=e, parts=parts_k, codec=codec_)
            for fn, n in saved.items():
                fn.launches = n
            return out

        def time_largest():
            """Each of the path's kernels at round 1's largest leaf, after
            the round: events, its device time, the plain version and, for
            K4, torch.topk; these launches do not count."""
            saved = {fn: fn.launches for fn in counters}
            e, codec_ = kept["e"], kept["codec"]
            free(torch)         # the round's cached blocks back to the card
            timing_ctx.update(
                memory_allocated=torch.cuda.memory_allocated(),
                memory_reserved=torch.cuda.memory_reserved())
            timing.update(time_codec_kernels(torch, codec_, e, kept["parts"],
                                             K))
            kept.clear()
            for fn, n in saved.items():
                fn.launches = n

        for fn in counters:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        local_updates._steps = steps_hook
        local_updates.exchange_leaf = exchange_hook
        losses, aux, mtp, wire, host_s = [], [], [], [], []
        try:
            for r in range(1, rounds + 1):
                calls["round"] = r
                batches = lm_batches(torch, ts, cfg, K, H, rng, device)
                torch.cuda.synchronize()
                h0 = time.perf_counter()
                start = torch.cuda.Event(enable_timing=True)
                start.record()
                marks.append({"start": start})
                out = virtual_round(step, params, opt, batches, lc, state)
                end = torch.cuda.Event(enable_timing=True)
                end.record()
                marks[-1]["end"] = end
                torch.cuda.synchronize()
                host_s.append(time.perf_counter() - h0)
                params, opt, metrics = out[:3]
                if state is not None:
                    state = out[3]
                losses.append(metrics["loss"].float().cpu().numpy())
                aux.append(metrics["aux_loss"].float().cpu().numpy())
                if "mtp_loss" in metrics:
                    mtp.append(metrics["mtp_loss"].float().cpu().numpy())
                wire.append(metrics["wire_bytes"])
                if kept:
                    time_largest()
        finally:
            local_updates._steps = steps_fn
            local_updates.exchange_leaf = exchange_fn
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counters}
        peak = torch.cuda.max_memory_allocated()
        finite = bool(tree_allfinite(params))
        # shard 0's first batch: the bf16 gradients of two steps from the
        # same params, and (LM_TRACED) one more step under the profiler:
        # where a step's device time goes, and the busy share
        b0 = {n: v[0, 0] for n, v in batches.items()}
        repeat = grads_repeat(torch, model, params, b0)
        step_trace = "not traced (LM_TRACED)"
        if (arch, codec_name) in LM_TRACED:
            trace = device_trace(lambda: step(params, opt, b0))
            kern = trace.get("kernels", {})
            step_trace = dict(
                window_ms=trace["window_ms"],
                busy_share_of_window=trace.get("busy_share_of_window"),
                device_busy_ms=trace.get("device_busy_ms"),
                gemm_ms=sum(v["device_ms"] for n, v in kern.items()
                            if any(g in n.lower() for g in LM_GEMM)),
                kernels_launched=sum(v["calls"] for v in kern.values()),
                top=dict(list(kern.items())[:12]), guard=trace.get("guard"))
        for fn in counters:   # the repeated and traced steps launch none
            fn.launches = launches[fn.__name__]
        split = [dict(round=i + 1, round_ms=m_["start"].elapsed_time(
            m_["end"]), local_ms=m_["start"].elapsed_time(m_["local_end"]),
            exchange_ms=m_["local_end"].elapsed_time(m_["end"]),
            host_s=host_s[i]) for i, m_ in enumerate(marks)]
        steady = split[1:] or split
        tokens = K * H * LM_BATCH * LM_SEQ
        first = float(np.mean(losses[0][:, 0]))
        last = float(np.mean(losses[-1][:, -1]))
        want = {fn.__name__: 0 for fn in counters}
        own = own_kernels(None if codec.lossless else "topk"
                          if "topk" in codec.name
                          else codec.name.removeprefix("ef:"))
        want.update({n: len(leaves) * rounds for n in own})
        ok = dict(loss_falls=last < first, finite=finite,
                  launches=launches == want,
                  bytes=all(w == want_bytes for w in wire),
                  timed_equal_plain=all(t_["equal_to_plain"]
                                        for t_ in timing.values()),
                  plain=(all(all(v for k_, v in c_.items()
                                 if k_ != "max_abs_err")
                             for c_ in checks.values())
                         and (codec.lossless
                              or len(checks) == len({largest, embed_len}))),
                  bf16_grads_repeat=repeat["equal"])
        phase_done(
            torch, "transformer_path", t0, path=label, codec=codec_name,
            arch=cfg.name, family=cfg.family, reduced=reduced or "none",
            layers=cfg.num_layers, d_model=cfg.d_model,
            vocab=cfg.vocab_size,
            experts=cfg.moe.num_experts if cfg.moe else None,
            params=n_params, K=K, H=H, batch=LM_BATCH,
            seq=LM_SEQ, rounds=rounds, lr=lr, fan_in=lm_fan_in(cfg),
            leaves=len(leaves), largest_leaf=largest,
            largest_leaf_plan=plan, checks=ok,
            loss_first_step=first, loss_last_round=last,
            loss_by_round=[l_.tolist() for l_ in losses],
            aux_loss_by_round=([a_.tolist() for a_ in aux] if cfg.moe
                               else "no moe layer"),
            mtp_loss_by_round=([m_.tolist() for m_ in mtp] if mtp
                               else "no mtp head"),
            wire_bytes_by_round=wire, delta_wire_bytes=want_bytes,
            launches=launches, expected_launches=want,
            launches_per_round={n: launches[n] / rounds for n in own},
            plain_vs_kernel={str(k_): v for k_, v in checks.items()},
            bf16_grads_repeat=repeat,
            round_split_ms=split,
            tokens_per_round=tokens,
            tokens_per_s=tokens / np.median([s["round_ms"] for s in steady])
            * 1e3,
            tokens_per_s_label="median over the rounds after the first (the "
                               "first holds the plain-version checks)",
            kernels_at_largest_leaf=timing, timing_context=timing_ctx,
            step_trace=step_trace,
            memory_allocated_before=held_before,
            predicted_peak=predicted, max_memory_allocated=peak,
            setup_seconds=setup_s)
        if not all(ok.values()):
            raise SystemExit(f"chip_smoke: the transformer path {label} "
                             f"failed a check {ok} (see its "
                             f"transformer_path line)")
        for name in own:
            key = {"topk_select": "topk"}.get(
                name, name.replace("quantize_pack_", "").replace(
                    "decode_reduce_", "decode_"))
            entry = entries.setdefault(name, dict(launches=0, rows={}))
            entry["launches"] += launches[name]
            entry["rows"][label] = dict(
                launches=launches[name],
                launches_per_round=launches[name] / rounds,
                leaves=len(leaves), **timing[key])
        del params, opt, state, out, step, model, batches, b0
        free(torch)
    return entries


def lm_card_vs_cpu_phase(torch, device="cuda") -> None:
    """Phase 10b: each of ``LM_SMALL_ARCHS`` at ``.reduced()``, one train
    step's loss and gradients (``loss_and_grads``, what
    ``make_train_step`` differentiates) in f32 on the card and on the
    CPU from the same params and batch: the loss, the aux and MTP terms
    within rtol ``LM_SMALL_RTOL``, every gradient leaf within
    ``LM_SMALL_GRAD_TOL`` times that leaf's largest |CPU| value (at least
    ``LM_SMALL_GRAD_FLOOR``); then the same step twice on the card in
    bf16: every gradient leaf bit for bit."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import build_model
    from repro_torch.train import loss_and_grads
    from repro_torch.utils.device import full_f32_matmul
    from repro_torch.utils.trees import tree_flatten_with_path, tree_map

    full_f32_matmul()
    B, S = LM_SMALL
    failed = []
    for arch in LM_SMALL_ARCHS:
        t0 = time.perf_counter()
        cfg = get_config(arch).reduced()
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), torch.float32)
        batch = TokenStream(cfg.vocab_size, S, B, seed=0).next_batch()
        batch = {n: torch.tensor(v) for n, v in batch.items()}
        batch.update({n: v.float() if v.is_floating_point() else v
                      for n, v in serve_extras(
                          torch, cfg, B, S, np.random.default_rng(0),
                          "cpu").items()})
        to = {"cpu": lambda t: t, "card": lambda t: t.to(device)}
        runs = {w: loss_and_grads(model, tree_map(f, params),
                                  tree_map(f, batch))
                for w, f in to.items()}
        (l_c, m_c, g_c), (l_d, m_d, g_d) = runs["cpu"], runs["card"]
        keys = [str(k) for k, _ in tree_flatten_with_path(params)]
        # each leaf's error over its largest |CPU| value, floored at
        # LM_SMALL_GRAD_FLOOR: a key bias's gradient is 0 in exact
        # arithmetic (the softmax ignores a shift shared by every key),
        # and both devices hold ~1e-10 there
        grad_err = {k: max_err(a.cpu(), b) / max(float(b.abs().max()),
                                                 LM_SMALL_GRAD_FLOOR)
                    for k, a, b in zip(keys, g_d, g_c)}
        terms = {n: (float(m_d[n]), float(m_c[n]))
                 for n in ("loss", "ce", "aux_loss", "mtp_loss")
                 if n in m_c}
        terms_ok = all(abs(d - c) <= LM_SMALL_RTOL * max(abs(c), 1e-30)
                       for d, c in terms.values())
        worst = max(grad_err, key=grad_err.get)
        del runs
        # bf16, twice on the card
        p16 = tree_map(lambda t: t.to(device, torch.bfloat16)
                       if t.is_floating_point() else t.to(device), params)
        b16 = {n: v.to(device, torch.bfloat16 if v.is_floating_point()
                       else v.dtype) for n, v in batch.items()}
        repeat = grads_repeat(torch, model, p16, b16)
        ok = dict(terms=terms_ok,
                  grads=grad_err[worst] <= LM_SMALL_GRAD_TOL,
                  bf16_grads_repeat=repeat["equal"])
        emit(phase="transformer_card_vs_cpu", arch=cfg.name,
             family=cfg.family, batch=B, seq=S,
             extras=sorted(n for n in batch if n not in ("tokens", "labels")),
             terms_card_cpu=terms, grad_leaves=len(keys),
             worst_grad_leaf=worst, worst_grad_rel_err=grad_err[worst],
             tolerance=dict(terms_rtol=LM_SMALL_RTOL,
                            grad_of_leaf_max=LM_SMALL_GRAD_TOL,
                            leaf_max_floor=LM_SMALL_GRAD_FLOOR),
             bf16_grads_repeat=repeat, checks=ok,
             seconds=time.perf_counter() - t0)
        if not all(ok.values()):
            failed.append(arch)
        del params, p16, b16, batch
        free(torch)
    if failed:
        raise SystemExit(f"chip_smoke: the train step on the card and on "
                         f"the CPU disagree, or bf16 gradients did not "
                         f"repeat, for {failed} (see their "
                         f"transformer_card_vs_cpu lines)")


class ServeRecorder:
    """The ``Model`` interface ``greedy_generate`` calls, delegated to
    ``model``, keeping the states it allocates, the last row of the
    prefill's logits (a copy: not the whole (B, S, V) block) and each
    decode step's logits and, with ``events``, CUDA events around the
    prefill and each step. ``cache_dtype`` replaces the states' default
    bf16."""

    def __init__(self, torch, model, events: bool, cache_dtype=None):
        self.torch, self.model, self.events = torch, model, events
        self.cache_dtype = cache_dtype
        self.states, self.prefill_last, self.step_logits = None, None, []
        self.marks, self.cross = [], []

    def _event(self):
        if not self.events:
            return None
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def init_states(self, params, B, max_len, batch=None):
        kw = {} if self.cache_dtype is None else {"dtype": self.cache_dtype}
        self.states = self.model.init_states(params, B, max_len, batch, **kw)
        return self.states

    def prefill(self, params, batch, states):
        start = self._event()
        logits, states = self.model.prefill(params, batch, states)
        self.marks.append((start, self._event()))
        self.prefill_last = logits[:, -1:].clone()
        # whisper's cross keys and values as the prefill left them: each
        # tensor, its address and a copy of its values
        self.cross = [(st[k], st[k].data_ptr(), st[k].clone())
                      for st in states if "cross_k" in st
                      for k in ("cross_k", "cross_v")]
        return logits, states

    def decode_step(self, params, batch, states):
        start = self._event()
        logits, states = self.model.decode_step(params, batch, states)
        self.marks.append((start, self._event()))
        self.step_logits.append(logits)
        return logits, states

    def logits(self):
        """The prefill's last row and every step's, (B, steps + 1, V)."""
        return self.torch.cat([self.prefill_last] + self.step_logits, dim=1)

    def ms(self):
        return [a.elapsed_time(b) for a, b in self.marks]


def serve_extras(torch, cfg, B: int, S: int, rng, device) -> dict:
    """The batch's inputs beyond the tokens, drawn from ``rng``: whisper's
    (B, source_len, d_model) frames x 0.02 in bf16; a vlm's patches x
    0.02 in bf16 at the prompt's start, the largest square within
    ``min(SERVE_PATCHES, S // 2)``, on a (t = 0, h, w) grid."""
    import math

    import numpy as np
    if cfg.family == "audio":
        return {"frame_embeds": torch.tensor(rng.standard_normal(
            (B, cfg.encdec.source_len, cfg.d_model)) * 0.02).to(
                device, torch.bfloat16)}
    if cfg.family != "vlm":
        return {}
    side = math.isqrt(min(SERVE_PATCHES, S // 2))
    h, w = np.meshgrid(np.arange(side), np.arange(side), indexing="ij")
    grid = np.stack([np.zeros_like(h), h, w], -1).reshape(1, -1, 3)
    return {"patch_embeds": torch.tensor(rng.standard_normal(
                (B, side * side, cfg.d_model)) * 0.02).to(
                    device, torch.bfloat16),
            "patch_positions": torch.tensor(
                np.repeat(grid, B, 0), dtype=torch.int32, device=device)}


def teacher_forcing(torch, model, params, prompts, ids, logits,
                    tol: float, extras=None) -> dict:
    """Every decoded position (``logits``: the prefill's last row and
    each step's) against teacher forcing, the full forward over the
    prompt (with ``extras``) and the ids before it: the largest
    log-softmax difference (and by position), and whether each id is
    that forward's argmax where its top-two gap exceeds ``tol``."""
    S = prompts.shape[1]
    with torch.inference_mode():
        seq = torch.cat([prompts, ids[:, :-1]], dim=1)
        tf, _ = model.forward_train(params, {"tokens": seq,
                                             **(extras or {})})
        tf = torch.log_softmax(tf[:, S - 1:], dim=-1)
        got = torch.log_softmax(logits, dim=-1)
        top2 = tf.topk(2, dim=-1).values
        sure = (top2[..., 0] - top2[..., 1]) > tol
        return dict(
            err=max_err(got, tf),
            err_by_position=(got - tf).abs().amax(dim=(0, 2)).tolist(),
            argmax_ok=bool((ids == tf.argmax(-1).to(torch.int32))[sure]
                           .all()),
            positions_with_top2_gap_over_tol=int(sure.sum()),
            positions=int(sure.numel()), tolerance=tol)


def expected_pos_abs(torch, T: int, written: list):
    """A cache of T slots after ``written`` positions in that order, each
    at slot ``pos % T`` (the last write to a slot wins): -1 elsewhere."""
    want = torch.full((T,), -1, dtype=torch.int32)
    for p_ in written:
        want[p_ % T] = p_
    return want


@contextlib.contextmanager
def routes():
    """Record the experts of every MoE routing (``layers._route``) made
    inside: a list of (T, top_k) tensors, in call order."""
    from repro_torch.models import layers as L
    calls, route = [], L._route

    def recorded(router_p, mo, xt):
        out = route(router_p, mo, xt)
        calls.append(out[1])
        return out
    L._route = recorded
    try:
        yield calls
    finally:
        L._route = route


def expert_flips(torch, decoded: list, forced: list, n_moe: int,
                 prompt: int) -> dict:
    """Positions whose experts (as sets) differ between a greedy
    generation's routings (the prefill's n_moe calls over the ``prompt``
    positions, then n_moe a step, B = 1) and teacher forcing's (n_moe
    calls over every position): how many positions differ in any layer,
    and in each layer; in all, among the prompt's positions (two full
    forwards that differ only in their lengths) and among the decoded
    ones (a step against the full forward)."""
    if not n_moe:
        return dict(positions_changed=0, by_layer=[], positions=0)
    per_layer, changed = [], None
    for j in range(n_moe):
        dec = torch.cat(decoded[j::n_moe], dim=0).sort(-1).values
        tf = forced[j][:dec.shape[0]].sort(-1).values
        diff = (dec != tf).any(-1)
        per_layer.append(diff)
        changed = diff if changed is None else changed | diff
    return dict(
        positions_changed=int(changed.sum()),
        by_layer=[int(d.sum()) for d in per_layer],
        positions=int(changed.shape[0]), prompt_positions=prompt,
        prompt_positions_changed=int(changed[:prompt].sum()),
        prompt_by_layer=[int(d[:prompt].sum()) for d in per_layer],
        decoded_positions_changed=int(changed[prompt:].sum()),
        decoded_by_layer=[int(d[prompt:].sum()) for d in per_layer])


@contextlib.contextmanager
def mla_decode_rebuilt():
    """An MLA decode step (``layers.mla_apply``, mode "step") attending as
    the prefill does: each head's keys and values rebuilt from the cache's
    latents in the activations' dtype (bf16 where the absorbed form stays
    in f32) and ``flash_attention`` over the filled slots; the cache is
    written by the step as shipped, whose output is dropped. B = 1 and a
    cache that has not wrapped: slots 0 ... pos hold positions 0 ... pos.
    A probe of the bf16 drift, not a path of the port."""
    import torch

    from repro_torch.models import layers as L
    mla = L.mla_apply

    def rebuilt(p, cfg, x, positions, *, mode, state):
        y, state = mla(p, cfg, x, positions, mode=mode, state=state)
        if mode != "step":
            return y, state
        m, H = cfg.mla, cfg.num_heads
        nope, rope = m.qk_nope_dim, m.qk_rope_dim
        pos1d = positions[..., 0] if positions.ndim == 3 else positions
        n = int(pos1d.max()) + 1
        if x.shape[0] != 1 or not torch.equal(
                state["pos_abs"][0, :n].cpu(), torch.arange(n,
                                                            dtype=torch.int32)):
            raise ValueError("mla_decode_rebuilt: B = 1 and an unwrapped "
                             "cache only")
        q = L.dense(p["w_uq"], L.apply_norm(p["q_norm"],
                                            L.dense(p["w_dq"], x)))
        q = q.reshape(1, 1, H, nope + rope)
        q = torch.cat([q[..., :nope], L._mla_rope(q[..., nope:], pos1d,
                                                   cfg)], -1)
        c, kr = state["c"][:, :n].to(x.dtype), state["kr"][:, :n].to(x.dtype)
        k = torch.cat([L.dense(p["w_uk"], c).reshape(1, n, H, nope),
                       kr[:, :, None].expand(1, n, H, rope)], -1)
        v = L.dense(p["w_uv"], c).reshape(1, n, H, m.v_head_dim)
        out = L.flash_attention(q, k, v, q_pos=pos1d,
                                kv_pos=state["pos_abs"][:, :n], causal=True,
                                window=None, scale=(nope + rope) ** -0.5)
        return L.dense(p["wo"], out.reshape(1, 1, H * m.v_head_dim)), state
    L.mla_apply = rebuilt
    try:
        yield
    finally:
        L.mla_apply = mla


def no_drop_teacher_forcing(torch, cfg, params, prompts, n: int, tol: float,
                            cache_dtype=None, probe_mla=False) -> dict:
    """An MoE arch's greedy generation against teacher forcing with no
    token dropped: ``params`` under capacity_factor = num_experts (the
    prefill's and the full forward's dispatch exact, as a decode step's
    is), at ``SERVE_TF_NO_DROP``'s batch and prompt, states in
    ``cache_dtype`` (bf16 by default); with the positions whose experts
    differ between the two (``expert_flips``). ``probe_mla``: the same
    again with the decode steps' MLA in the prefill's form
    (``mla_decode_rebuilt``), under ``mla_decode_rebuilt``."""
    from repro_torch.models import build_model
    from repro_torch.models.transformer import layer_plan
    from repro_torch.serve import greedy_generate
    Bt, St = SERVE_TF_NO_DROP
    mo = cfg.moe
    model = build_model(dataclasses.replace(cfg, moe=dataclasses.replace(
        mo, capacity_factor=float(mo.num_experts))))
    n_moe = sum(ch == "moe" for _, ch in layer_plan(cfg))

    def run():
        rec = ServeRecorder(torch, model, events=False,
                            cache_dtype=cache_dtype)
        with routes() as decoded:
            ids = greedy_generate(rec, params, prompts[:Bt, :St], max_new=n)
        with routes() as forced:
            out = teacher_forcing(torch, model, params, prompts[:Bt, :St],
                                  ids, rec.logits(), tol)
        out["expert_flips"] = expert_flips(torch, decoded, forced, n_moe,
                                           St)
        return out
    held = run()
    held["batch_prompt"] = [Bt, St]
    if probe_mla:
        with mla_decode_rebuilt():
            probe = run()
        held["mla_decode_rebuilt"] = {k: probe[k] for k in (
            "err", "err_by_position", "argmax_ok", "expert_flips")}
    return held


def serve_phase(torch, counters, device="cuda") -> None:
    """Phase 11: each path of ``SERVE_PATHS`` through ``greedy_generate``
    with the launch counters set to 0 just before and read just after,
    its checks, its times beside their bounds and traces of
    ``SERVE_TRACE_STEPS`` decode steps and of a prefill; then the small
    card-vs-CPU run."""
    import numpy as np

    from repro_torch.configs import ARCHS, get_config, padded_vocab
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import layer_plan
    from repro_torch.serve import greedy_generate
    from repro_torch.utils.device import full_f32_matmul
    from repro_torch.utils.trees import tree_bytes, tree_map, tree_params

    full_f32_matmul()
    card = nvidia_smi()
    for arch, layers, B, S, n, held_in, held_layers in SERVE_PATHS:
        t0 = time.perf_counter()
        free(torch)
        held_before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        full_cfg = get_config(arch)
        cfg = dataclasses.replace(full_cfg,
                                  num_layers=layers or full_cfg.num_layers)
        model = build_model(cfg)
        params = model.init(torch.Generator(device=device).manual_seed(0))
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        init_peak = torch.cuda.max_memory_allocated()
        rng = np.random.default_rng(0)
        prompts = torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                               dtype=torch.int32).to(device)
        extras = serve_extras(torch, cfg, B, S, rng, device)
        P = extras["patch_embeds"].shape[1] if "patch_embeds" in extras else 0
        # teacher forcing sees every patch, the reference's decode one: a
        # vlm's decode is held on the same prompt as text only
        tf_extras = {} if P else extras
        # a warm-up call: the first of each kernel loads its module
        greedy_generate(model, params, prompts, max_new=2,
                        batch_extras=extras)
        rec = ServeRecorder(torch, model, events=True)
        for fn in counters:
            fn.launches = 0
        h0 = time.perf_counter()
        ids = greedy_generate(rec, params, prompts, max_new=n,
                              batch_extras=extras)
        torch.cuda.synchronize()
        generate_s = time.perf_counter() - h0
        launches = {fn.__name__: fn.launches for fn in counters}
        peak = torch.cuda.max_memory_allocated()
        ms = rec.ms()
        prefill_ms, step_ms = ms[0], ms[1:]
        steady = step_ms[1:] or step_ms

        with torch.inference_mode():
            # 1. the prefill's logits (the same call on the same prompts
            # and extras, into new states) against forward_train's
            batch = {"tokens": prompts, **extras}
            full, _ = model.prefill(params, batch, model.init_states(
                params, B, S + n, batch=extras or None))
            train, _ = model.forward_train(params, batch)
            # a row at a time: command-r's (8, 512, 256,000) blocks leave
            # no room for a whole difference beside its weights
            prefill_diff = max(max_err(f, t) for f, t in zip(full, train))
            del full, train, batch
        # 2-3. every decoded position against teacher forcing (a vlm's on
        # a text-only run, the patch prompt's error printed)
        if P:
            patch_tf = teacher_forcing(torch, model, params, prompts, ids,
                                       rec.logits(), SERVE_TF_TOL, extras)
            rec_text = ServeRecorder(torch, model, events=False)
            ids_text = greedy_generate(rec_text, params, prompts, max_new=n)
            tf_bf16 = teacher_forcing(torch, model, params, prompts,
                                      ids_text, rec_text.logits(),
                                      SERVE_TF_TOL)
            del rec_text, ids_text
        else:
            patch_tf = None
            tf_bf16 = teacher_forcing(torch, model, params, prompts, ids,
                                      rec.logits(), SERVE_TF_TOL, extras)
        # 4. each attention cache's positions: 0 ... S + n - 2, each at
        # slot pos % T (the last slot empty where T = S + n); a vlm's P
        # patches all at position 0, so slot 0 holds 0 and 1 ... P - 1
        # stay empty
        written = [0] * P + list(range(P, S + n - 1))
        pos_ok = True
        for st in rec.states:
            st = st.get("self", st)
            if "pos_abs" in st:
                want_pos = expected_pos_abs(torch, st["pos_abs"].shape[1],
                                            written)
                pos_ok &= bool((st["pos_abs"].cpu() == want_pos).all())
        # 5. whisper's cross k and v: the prefill's tensors, at their
        # addresses, with their values, after every decode step
        now = [st[k] for st in rec.states if "cross_k" in st
               for k in ("cross_k", "cross_v")]
        cross_ok = len(now) == len(rec.cross) and all(
            a is t and a.data_ptr() == ptr and torch.equal(a, was)
            for a, (t, ptr, was) in zip(now, rec.cross))
        cache_bytes = tree_bytes(rec.states)
        attn_bytes, rec_bytes = state_bytes(cfg, B, S + n)
        want_cache = attn_bytes + rec_bytes
        param_bytes = tree_bytes(params)
        # decode: the weights a step reads (step_weight_bytes), the B
        # embedding rows it gathers (whisper: and B rows of dec_pos), the
        # whole KV cache (whisper: and the cross k and v), which a step
        # reads, and the {h, conv} states, which it reads and writes whole
        read = (step_weight_bytes(cfg, params)
                + B * cfg.d_model * 2 * (2 if cfg.family == "audio" else 1)
                + cache_bytes + rec_bytes)
        decode_bound = bound_ms(read, dense_products(cfg, B,
                                                     decode=True)[0],
                                PEAK_FLOPS_BF16)
        frames = B * cfg.encdec.source_len if cfg.encdec else 0
        pre_flops, pre_bytes = dense_products(cfg, B * S, frames)
        prefill_bound = bound_ms(pre_bytes, pre_flops, PEAK_FLOPS_BF16)
        # 5 decode steps more, traced, writing on past the last slot
        # (positions wrap in the cache; the checks are done)
        step = lambda t: model.decode_step(       # noqa: E731
            params, {"tokens": ids[:, -1:], "positions": torch.full(
                (B, 1), t, dtype=torch.int32, device=device)}, rec.states)

        def steps():
            with torch.inference_mode():
                for t in range(SERVE_TRACE_STEPS):
                    step(S + n - 1 + t)

        trace = device_trace(steps)
        kern = trace.get("kernels", {})
        n_kern = sum(v["calls"] for v in kern.values())
        # and one prefill, into new states
        st = model.init_states(params, B, S + n, batch=extras or None)

        def prefill():
            with torch.inference_mode():
                model.prefill(params, {"tokens": prompts, **extras}, st)

        p_trace = device_trace(prefill)
        p_kern = p_trace.get("kernels", {})
        del st
        held, f32_peak = tf_bf16, None
        n_params = tree_params(params)
        if held_in == "f32":
            # the same greedy generation on f32 params from the same seed
            # and f32 states, the bf16 params freed first
            del params
            rec.states = rec.cross = None
            free(torch)
            torch.cuda.reset_peak_memory_stats()
            m32 = build_model(dataclasses.replace(
                cfg, num_layers=held_layers or cfg.num_layers))
            p32 = m32.init(torch.Generator(device=device).manual_seed(0),
                           torch.float32)
            rec32 = ServeRecorder(torch, m32, events=False,
                                  cache_dtype=torch.float32)
            ids32 = greedy_generate(rec32, p32, prompts, max_new=n,
                                    batch_extras=tf_extras)
            held = teacher_forcing(torch, m32, p32, prompts, ids32,
                                   rec32.logits(), SERVE_TF_TOL_F32,
                                   tf_extras)
            held["layers"] = m32.cfg.num_layers
            f32_peak = torch.cuda.max_memory_allocated()
            del m32, p32, rec32, ids32
            params = None
        no_drop_bf16 = None
        if held_in.endswith("no-drop"):
            # the served bf16 weights, no token dropped in the prefill
            # nor in teacher forcing's forward
            held = no_drop_bf16 = no_drop_teacher_forcing(
                torch, cfg, params, prompts, n, SERVE_TF_TOL,
                probe_mla=cfg.mla is not None)
        if held_in == "f32-no-drop":
            # and on f32 weights from the same seed at the depth that
            # fits, the bf16 weights freed first
            del params
            rec.states = rec.cross = None
            free(torch)
            torch.cuda.reset_peak_memory_stats()
            cfg32 = dataclasses.replace(
                cfg, num_layers=held_layers or cfg.num_layers)
            p32 = build_model(cfg32).init(
                torch.Generator(device=device).manual_seed(0), torch.float32)
            held = no_drop_teacher_forcing(torch, cfg32, p32, prompts, n,
                                           SERVE_TF_TOL_F32, torch.float32)
            held["layers"] = cfg32.num_layers
            f32_peak = torch.cuda.max_memory_allocated()
            del p32
            params = None
        median = float(np.median(steady))
        checks = dict(
            prefill_equals_forward_train=prefill_diff == 0.0,
            decode_vs_teacher_forcing=held["err"] < held["tolerance"],
            ids_are_teacher_forced_argmax=held["argmax_ok"],
            logits_finite=bool(torch.isfinite(rec.logits()).all()),
            pos_abs=pos_ok, cross_kv_kept=cross_ok,
            cache_bytes=cache_bytes == want_cache,
            no_kernel_launched=not any(launches.values()) and not any(
                fn.launches for fn in counters),
            shape=tuple(ids.shape) == (B, n) and ids.dtype == torch.int32)
        line = dict(
            arch=arch, card=card, layers=cfg.num_layers,
            layers_of_config=full_cfg.num_layers,
            encoder_layers=cfg.encdec.num_layers if cfg.encdec else None,
            mixers=sorted({mx for mx, _ in layer_plan(cfg)}),
            rope=cfg.rope_style, d_model=cfg.d_model,
            heads=[cfg.num_heads, cfg.num_kv_heads], d_ff=cfg.d_ff,
            vocab=padded_vocab(cfg), params=n_params,
            batch=B, prompt=S, max_new=n,
            extras={k: list(v.shape) for k, v in extras.items()},
            checks=checks,
            prefill_max_abs_diff_vs_forward_train=prefill_diff,
            teacher_forcing_held_in=held_in,
            teacher_forcing_prompt="text only" if P else "the path's",
            teacher_forcing_layers=held.get("layers", cfg.num_layers),
            teacher_forcing_max_abs_logsoftmax_err=held["err"],
            teacher_forcing_err_by_position=held["err_by_position"],
            positions_with_top2_gap_over_tol=held[
                "positions_with_top2_gap_over_tol"],
            positions=held["positions"],
            teacher_forcing_tolerance=held["tolerance"],
            teacher_forcing_batch_prompt=held.get("batch_prompt", [B, S]),
            teacher_forcing_expert_flips=held.get("expert_flips"),
            moe=None if cfg.moe is None else dict(
                experts=cfg.moe.num_experts, top_k=cfg.moe.top_k,
                d_expert=cfg.moe.d_expert, shared=cfg.moe.num_shared,
                dense_prologue=cfg.moe.first_k_dense,
                capacity_factor=cfg.moe.capacity_factor,
                prefill_capacity=L._capacity(cfg.moe, B * S, False),
                decode_capacity=L._capacity(cfg.moe, B, True)),
            mla=None if cfg.mla is None else dataclasses.asdict(cfg.mla),
            mtp_head_drawn_not_served=cfg.mtp_depth > 0,
            no_drop_bf16_teacher_forcing=(
                None if no_drop_bf16 is held else no_drop_bf16),
            bf16_teacher_forcing=(None if held is tf_bf16 else dict(
                max_abs_logsoftmax_err=tf_bf16["err"],
                err_by_position=tf_bf16["err_by_position"],
                ids_are_argmax_where_gap_over_tol=tf_bf16["argmax_ok"])),
            patch_prompt_teacher_forcing_not_held=(None if patch_tf is None
                                                   else dict(
                max_abs_logsoftmax_err=patch_tf["err"],
                err_by_position=patch_tf["err_by_position"])),
            f32_check_peak_memory=f32_peak,
            prefill_ms=prefill_ms, prefill_bound_ms=prefill_bound[0],
            prefill_bound_by=prefill_bound[1],
            prefill_bf16_tflop=pre_flops / 1e12,
            decode_ms_median=median, decode_ms_max=float(max(steady)),
            decode_ms_first=step_ms[0],
            decode_ms_by_step=step_ms,
            decode_bound_ms=decode_bound[0], decode_bound_by=decode_bound[1],
            decode_bytes_read=read,
            decode_tokens_per_s=B / median * 1e3,
            generate_seconds_host=generate_s,
            param_bytes=param_bytes, cache_bytes=cache_bytes,
            cache_bytes_formula=want_cache, kv_cache_bytes=attn_bytes,
            recurrent_state_bytes=rec_bytes,
            max_memory_allocated=peak, init_peak_memory=init_peak,
            memory_allocated_before=held_before, init_seconds=init_s,
            launches=launches, sample_ids=ids[0, :16].tolist(),
            decode_trace=dict(
                steps=SERVE_TRACE_STEPS,
                kernels_per_step=n_kern / SERVE_TRACE_STEPS,
                window_ms=trace["window_ms"],
                busy_share_of_window=trace.get("busy_share_of_window"),
                device_busy_ms_per_step=(
                    trace["device_busy_ms"] / SERVE_TRACE_STEPS
                    if "device_busy_ms" in trace else "not measured"),
                gemm_ms_per_step=sum(
                    v["device_ms"] for k_, v in kern.items()
                    if any(g in k_.lower() for g in LM_GEMM))
                / SERVE_TRACE_STEPS,
                top=dict(list(kern.items())[:8]), guard=trace["guard"]),
            prefill_trace=dict(
                kernels=sum(v["calls"] for v in p_kern.values()),
                window_ms=p_trace["window_ms"],
                busy_share_of_window=p_trace.get("busy_share_of_window"),
                device_busy_ms=p_trace.get("device_busy_ms", "not measured"),
                gemm_ms=sum(v["device_ms"] for k_, v in p_kern.items()
                            if any(g in k_.lower() for g in LM_GEMM)),
                top=dict(list(p_kern.items())[:5]), guard=p_trace["guard"]))
        phase_done(torch, "serve_path", t0, **line)
        if not all(checks.values()):
            raise SystemExit(f"chip_smoke: serving {arch} failed a check "
                             f"{checks} (see its serve_path line)")
        del params, rec, ids, prompts, extras, tf_extras, trace, p_trace
        free(torch)

    # the small run: the same f32 params, and f32 caches, on the card
    # and on the CPU (a vlm's prompt with patches)
    t0 = time.perf_counter()
    B, S, n = SERVE_SMALL
    small = {}
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        model = build_model(cfg)
        params = model.init(torch.Generator().manual_seed(0), torch.float32)
        rng = np.random.default_rng(1)
        prompts = torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                               dtype=torch.int32)
        extras = serve_extras(torch, cfg, B, S, rng, "cpu")
        runs = {}
        for dev in (device, "cpu"):
            rec = ServeRecorder(torch, model, events=False,
                                cache_dtype=torch.float32)
            ids = greedy_generate(rec, tree_map(lambda a: a.to(dev), params),
                                  prompts.to(dev), max_new=n,
                                  batch_extras=tree_map(lambda a: a.to(dev),
                                                        extras))
            runs[dev] = (ids.cpu(), rec.logits().cpu())
        (ids_d, lg_d), (ids_c, lg_c) = runs[device], runs["cpu"]
        scale = float(lg_c.abs().max())
        err = max_err(lg_d, lg_c)
        small[arch] = dict(
            extras={k: list(v.shape) for k, v in extras.items()},
            ids_equal=bool(torch.equal(ids_d, ids_c)), max_abs_err=err,
            largest_logit=scale,
            close=bool(torch.allclose(lg_d, lg_c, rtol=1e-4,
                                      atol=1e-5 * scale)))
    # and deepseek-v3's train loss with its MTP term, forward only
    from repro_torch.data.tokens import TokenStream
    from repro_torch.train.loss import lm_loss
    cfg = get_config("deepseek-v3-671b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator().manual_seed(0), torch.float32)
    batch = {k: torch.tensor(v) for k, v in TokenStream(
        cfg.vocab_size, 64, 2, seed=0).next_batch().items()}
    mtp = {}
    for dev in (device, "cpu"):
        with torch.inference_mode():
            loss, met = lm_loss(model, tree_map(lambda a: a.to(dev), params),
                                tree_map(lambda a: a.to(dev), batch))
        mtp[str(dev)] = {k: float(v) for k, v in dict(
            loss=loss, mtp_loss=met["mtp_loss"], aux_loss=met["aux_loss"],
            ce=met["ce"]).items()}
    mtp_close = all(np.isclose(mtp[str(device)][k], v, rtol=1e-4, atol=0)
                    for k, v in mtp["cpu"].items())
    phase_done(torch, "serve_card_vs_cpu", t0, card=card, batch=B, prompt=S,
               max_new=n, dtype="float32", archs=small,
               tolerance="rtol 1e-4, atol 1e-5 of the largest logit",
               mtp_lm_loss=dict(arch=cfg.name, batch=2, seq=64, **mtp,
                                close=mtp_close, tolerance="rtol 1e-4"))
    if not all(v["ids_equal"] and v["close"] for v in small.values()) or (
            not mtp_close):
        raise SystemExit("chip_smoke: reduced serving on the card and on "
                         "the CPU disagree (see the serve_card_vs_cpu line)")


def tree_sha256(torch, tree) -> str:
    """SHA-256 of every leaf's bytes in leaf order (a bf16 leaf as its
    16-bit patterns)."""
    import hashlib

    from repro_torch.utils.trees import tree_leaves
    h = hashlib.sha256()
    for leaf in tree_leaves(tree):
        h.update(leaf.detach().contiguous().reshape(-1).view(
            torch.uint8).cpu().numpy())
    return h.hexdigest()


def lu_schedule():
    """Phase 10's lr schedule: cosine, warmed up over one round's H
    steps of ``LU_ROUNDS``."""
    import functools

    from repro_torch.optim import cosine_schedule
    return functools.partial(cosine_schedule, warmup=LM_H,
                             total=LU_ROUNDS * LM_H)


def lu_model(torch, layers, device):
    """Phase 10's model and step at ``layers`` layers (None: all 22):
    (cfg, model, params (bf16, seed 0), the AdamW config, a step factory
    taking ``grad_sync_axis``: remat, lr ``LM_LR`` warmed up over one
    round's H steps of ``LU_ROUNDS``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import make_train_step

    cfg = get_config(LM_ARCH)
    if layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    opt_cfg = AdamWConfig(lr=LM_LR)
    schedule = lu_schedule()

    def step_of(grad_sync_axis=None):
        return make_train_step(model, opt_cfg, remat=True, schedule=schedule,
                               grad_sync_axis=grad_sync_axis)
    return cfg, model, params, opt_cfg, step_of


def lu_batches(torch, cfg, K: int, device) -> list:
    """Each round's (K, H, batch, seq) token batches from
    ``TokenStream(seed=0)``, drawn as phase 10 draws them (shard k's H
    batches, then shard k + 1's)."""
    import numpy as np

    from repro_torch.data.tokens import TokenStream
    ts = TokenStream(cfg.vocab_size, LM_SEQ, LM_BATCH, seed=0)
    out = []
    for _ in range(LU_ROUNDS):
        bs = [[ts.next_batch() for _ in range(LM_H)] for _ in range(K)]
        out.append({n: torch.tensor(np.stack([np.stack(
            [b[n] for b in row]) for row in bs])).to(device)
            for n in ("tokens", "labels")})
    return out


def lu_virtual(torch, step, params, opt_cfg, lc, batches, keep=None):
    """``virtual_round`` over each round's batches from ``params``; per
    round the params' SHA-256 and the shards' losses. ``keep(t, params)``
    sees each round's params."""
    from repro_torch.optim import adamw_init, init_delta_codec_state
    from repro_torch.optim import virtual_round
    K = batches[0]["tokens"].shape[0]
    p, o = params, adamw_init(params, opt_cfg)
    st = init_delta_codec_state(params, lc, shards=K)
    out = []
    for t, b in enumerate(batches, 1):
        res = virtual_round(step, p, o, b, lc, st)
        p, o, m = res[:3]
        st = res[3] if st is not None else None
        if keep is not None:
            keep(t, p)
        out.append(dict(hash=tree_sha256(torch, p),
                        loss=m["loss"].float().cpu().tolist()))
    return out


def exchange_vs_plain(torch, codec_, e, rank: int, out) -> dict:
    """One rank's :func:`_codec_mean` of a leaf held bit for bit against
    the plain versions on the same inputs: its row of the gathered parts
    against the plain encode of its ``(1, L)`` row ``e`` (the delta plus
    any residual), the mean against the plain decode+mean of the same
    gathered parts (K3's oracle; the topk decode has no kernel), and an
    ``ef:`` residual against ``e`` less the decoded plain row."""
    mean, state, gathered = out
    L = e.shape[1]
    plain = codec_.encode_ref(e)
    res = dict(shape=list(gathered[0].shape[:1]) + [L], parts=all(
        bits_equal(torch, g[rank:rank + 1], p_)
        for g, p_ in zip(gathered, plain)))
    base = getattr(codec_, "base", codec_)
    if hasattr(base, "decode_reduce_ref"):
        want = base.decode_reduce_ref(gathered, L, mean=True)
        res.update(mean=bits_equal(torch, mean.reshape(-1), want),
                   max_abs_err=max_err(mean.reshape(-1), want))
    if state is not None:
        res["residual"] = bits_equal(
            torch, state, (e - codec_.decode_stacked(plain, L))[0])
    return res


def plain_held(res: dict, want: int) -> bool:
    """Every check of :func:`exchange_vs_plain` passed, at ``want``
    leaves."""
    return len(res) == want and all(
        v for r in res.values() for v in r.values() if isinstance(v, bool))


def lu_dist_rounds(torch, step, params, opt_cfg, lc, batches, fabric,
                   counters, time_leaf=False, keep=None):
    """``local_updates_round`` over ``fabric`` for each round's batches
    (this rank's row). Per round: the params' SHA-256, the losses,
    ``wire_bytes``, the split by CUDA events (local steps / delta
    exchange / opt-state sync), the calls into the group by op (CUDA
    events around each, and the host's seconds inside them and inside the
    staging copies), and the delta exchange's and the opt-state sync's
    calls, recorded apart. Round 1 also holds this rank's exchange of
    ``embed`` and of the largest other leaf against the plain versions
    (:func:`exchange_vs_plain`, ``plain_vs_kernel`` by leaf length). With
    ``time_leaf``, each kernel of the codec at round 1's largest leaf
    after that round (``time_codec_kernels``, launches not counted).
    Returns (the last params, the rounds, the kernel times)."""
    from repro_torch.comm.collectives import recording as record_calls
    from repro_torch.optim import (adamw_init, init_delta_codec_state,
                                   local_updates, local_updates_round)
    from repro_torch.utils.trees import tree_leaves

    steps_fn = local_updates._steps
    sync_fn = local_updates._sync_opt_state
    mean_fn = local_updates._codec_mean
    sizes = [x.numel() for x in tree_leaves(params)]
    largest, embed_len = max(sizes), params["embed"].numel()
    held = {embed_len, max(n for n in sizes if n != embed_len)}
    marks, opt_logs, kept, calls, host, plain = {}, [], {}, [], {}, {}

    def mark(name):
        marks[name] = torch.cuda.Event(enable_timing=True)
        marks[name].record()

    def steps_hook(*a):
        out = steps_fn(*a)
        mark("local_end")
        return out

    def sync_hook(o, f):
        mark("sync_start")
        with record_calls() as log:
            out = sync_fn(o, f)
        mark("sync_end")
        opt_logs.append(list(log))
        return out

    def mean_hook(delta, codec_, f, state=None):
        out = mean_fn(delta, codec_, f, state)
        n = delta.numel()
        if f.round != 1 or n not in held:
            return out
        row = delta.reshape(1, -1)
        e = row if state is None else row + state.reshape(1, -1)
        if n not in plain:
            plain[n] = exchange_vs_plain(torch, codec_, e, f.rank, out)
        if time_leaf and n == largest:
            kept.update(codec=codec_, parts=out[2], e=e)
        return out

    def timed(op, fn):
        def call(x):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            h0 = time.perf_counter()
            a.record()
            out = fn(x)
            b.record()
            host[op] = host.get(op, 0.0) + time.perf_counter() - h0
            calls.append((op, a, b))
            return out
        return call

    fabric.all_gather = timed("all_gather", fabric.all_gather)
    fabric.all_reduce = timed("all_reduce", fabric.all_reduce)
    stage = fabric._stage

    def stage_timed(x):
        h0 = time.perf_counter()
        out = stage(x)
        host["staging"] = host.get("staging", 0.0) + time.perf_counter() - h0
        return out

    fabric._stage = stage_timed
    local_updates._steps = steps_hook
    local_updates._sync_opt_state = sync_hook
    local_updates._codec_mean = mean_hook
    p, o = params, adamw_init(params, opt_cfg)
    st = init_delta_codec_state(params, lc)
    rounds, timing = [], {}
    try:
        for t, b in enumerate(batches, 1):
            fabric.round = t
            mine = {n: v[fabric.rank] for n, v in b.items()}
            opt_logs.clear()
            calls.clear()
            host.clear()
            torch.cuda.synchronize()
            h0 = time.perf_counter()
            mark("start")
            with record_calls() as log:
                out = local_updates_round(step, p, o, mine, lc, fabric, st)
            mark("end")
            torch.cuda.synchronize()
            host_s = time.perf_counter() - h0
            p, o, m = out[:3]
            st = out[3] if st is not None else None
            if keep is not None:
                keep(t, p)
            ms = {op: 0.0 for op, _, _ in calls}
            for op, a, b_ in calls:
                ms[op] += a.elapsed_time(b_)
            rounds.append(dict(
                hash=tree_sha256(torch, p),
                loss=m["loss"].float().cpu().tolist(), wire=m["wire_bytes"],
                round_ms=marks["start"].elapsed_time(marks["end"]),
                local_ms=marks["start"].elapsed_time(marks["local_end"]),
                exchange_ms=marks["local_end"].elapsed_time(
                    marks["sync_start"]),
                opt_sync_ms=marks["sync_start"].elapsed_time(
                    marks["sync_end"]),
                host_s=host_s, calls_ms=ms, calls_host_s=dict(host),
                delta_log=list(log), opt_log=opt_logs[0],
                plain_vs_kernel={str(n): r for n, r in plain.items()}))
            plain.clear()
            if kept:
                saved = {fn: fn.launches for fn in counters}
                timing = time_codec_kernels(torch, kept["codec"], kept["e"],
                                            kept["parts"], fabric.K)
                kept.clear()
                for fn, n in saved.items():
                    fn.launches = n
    finally:
        local_updates._steps = steps_fn
        local_updates._sync_opt_state = sync_fn
        local_updates._codec_mean = mean_fn
        fabric.round = None
        for name in ("all_gather", "all_reduce", "_stage"):
            del fabric.__dict__[name]
    return p, rounds, timing


def lu_round_summary(rnd: dict, want_delta: int, want_opt: int, K: int,
                     wire_dtype) -> dict:
    """A round of :func:`lu_dist_rounds` without its logs: the bytes
    derived from the delta exchange's calls (2 K x the operands; 0 at
    K = 1 by the rule, so the operands too) and from the opt-state
    sync's, beside the models, and the wire dtypes."""
    from types import SimpleNamespace

    from repro_torch.analysis.traffic import (derived_round_traffic,
                                              payload_collectives,
                                              quantized_wire_dtypes)
    fused = SimpleNamespace(backend="xla",
                            scheme=SimpleNamespace(transport="compressed"))
    delta, opt = rnd.pop("delta_log"), rnd.pop("opt_log")
    rnd.update(
        delta_operand_bytes=sum(c.nbytes for c in delta),
        delta_derived_bytes=derived_round_traffic(delta, fused, K),
        opt_operand_bytes=sum(c.nbytes for c in opt),
        opt_derived_bytes=derived_round_traffic(opt, fused, K),
        calls=len(delta) + len(opt), staged=sum(c.staged for c in delta + opt),
        quantized_dtypes=sorted(quantized_wire_dtypes(delta)),
        f32_payloads_over_4_bytes=sum(
            c.dtype == "float32" and c.nbytes > 4
            for c in payload_collectives(delta)))
    rnd["bytes_ok"] = (rnd["wire"] == want_delta
                       and (rnd["delta_derived_bytes"] == want_delta
                            if K > 1 else
                            2 * rnd["delta_operand_bytes"] == want_delta)
                       and rnd["opt_operand_bytes"] * 2 * K == want_opt
                       and (K == 1 or rnd["opt_derived_bytes"] == want_opt))
    rnd["dtypes_ok"] = (rnd["quantized_dtypes"] == sorted(
        {wire_dtype} - {None}) and (wire_dtype is None
                                    or not rnd["f32_payloads_over_4_bytes"]))
    return rnd


def lu_expected(lc, params, K: int, rounds: int, counters) -> tuple:
    """(the delta exchange's modelled bytes, the opt-state sync's: 2 K 4
    bytes a float element of mu and nu, the codec's wire dtype, each
    counter's expected launches: the codec's kernels once a leaf a
    round)."""
    from repro_torch.analysis.traffic import codec_wire_dtype
    from repro_torch.comm.codec import get_codec
    from repro_torch.optim import delta_wire_bytes
    from repro_torch.utils.trees import tree_leaves, tree_params
    codec = get_codec(lc.codec)
    own = own_kernels(None if codec.lossless else "topk"
                      if "topk" in codec.name
                      else codec.name.removeprefix("ef:"))
    want = {fn.__name__: 0 for fn in counters}
    want.update({n: len(tree_leaves(params)) * rounds for n in own})
    return (delta_wire_bytes(params, lc, K), 2 * K * 4 * 2
            * tree_params(params), codec_wire_dtype(lc.codec), want)


def lu_nccl_phase(torch, counters, work, device="cuda") -> dict:
    """Phase 12a: each codec of ``LU_NCCL_PATHS`` at full width on a
    1-rank NCCL group in this process, against ``virtual_round`` at K = 1
    (run twice first) by params hash; returns each codec kernel's
    launches and times at the largest leaf by path."""
    import numpy as np
    import torch.distributed as tdist

    from repro_torch.comm.collectives import Fabric
    from repro_torch.launch.dist import init_group
    from repro_torch.optim import LocalUpdatesConfig
    from repro_torch.utils.device import full_f32_matmul
    from repro_torch.utils.trees import tree_params

    full_f32_matmul()
    free(torch)
    cfg, _, params, opt_cfg, step_of = lu_model(torch, None, device)
    step = step_of()
    batches = lu_batches(torch, cfg, 1, device)
    out = {}
    init_group("nccl", "file://" + os.path.join(work, "lu_nccl"), 1, 0)
    try:
        fab = Fabric()
        for codec_name in LU_NCCL_PATHS:
            t0 = time.perf_counter()
            lc = LocalUpdatesConfig(H=LM_H, codec=codec_name)
            virt = [lu_virtual(torch, step, params, opt_cfg, lc, batches)
                    for _ in range(2)]
            virtual_s = time.perf_counter() - t0
            free(torch)
            for fn in counters:
                fn.launches = 0
            torch.cuda.reset_peak_memory_stats()
            held = torch.cuda.memory_allocated()
            t1 = time.perf_counter()
            rounds, timing = lu_dist_rounds(
                torch, step, params, opt_cfg, lc, batches, fab, counters,
                time_leaf=True)[1:]
            dist_s = time.perf_counter() - t1
            launches = {fn.__name__: fn.launches for fn in counters}
            peak = torch.cuda.max_memory_allocated()
            free(torch)
            want_delta, want_opt, wire_dt, want_l = lu_expected(
                lc, params, 1, LU_ROUNDS, counters)
            rounds = [lu_round_summary(r, want_delta, want_opt, 1, wire_dt)
                      for r in rounds]
            hashes = [r["hash"] for r in rounds]
            checks = dict(
                deterministic=virt[0] == virt[1],
                same_as_virtual=hashes == [v["hash"] for v in virt[0]],
                bytes=all(r["bytes_ok"] for r in rounds),
                dtypes=all(r["dtypes_ok"] for r in rounds),
                staged=not any(r["staged"] for r in rounds),
                launches=launches == want_l,
                plain=plain_held(rounds[0]["plain_vs_kernel"], 2),
                timed_equal_plain=all(t_["equal_to_plain"]
                                      for t_ in timing.values()))
            tokens = LM_H * LM_BATCH * LM_SEQ
            line = dict(
                path=codec_name, group="nccl", K=1, arch=cfg.name,
                layers=cfg.num_layers, params=tree_params(params), H=LM_H,
                batch=LM_BATCH, seq=LM_SEQ, rounds=LU_ROUNDS, lr=LM_LR,
                sync_opt_state=True, checks=checks, launches=launches,
                expected_launches=want_l, delta_wire_bytes=want_delta,
                opt_sync_model_bytes=want_opt, rounds_detail=rounds,
                virtual_losses=[v["loss"] for v in virt[0]],
                tokens_per_round=tokens,
                tokens_per_s=[tokens / r["round_ms"] * 1e3 for r in rounds],
                kernels_at_largest_leaf=timing,
                memory_allocated_before=held, max_memory_allocated=peak,
                virtual_seconds=virtual_s, dist_seconds=dist_s)
            phase_done(torch, "lu_nccl_path", t0, **line)
            if not all(checks.values()):
                raise SystemExit(f"chip_smoke: the 1-rank NCCL local-update "
                                 f"path {codec_name} failed a check {checks} "
                                 f"(see its lu_nccl_path line)")
            out[codec_name] = dict(launches=launches, timing=timing,
                                   median_round_ms=float(np.median(
                                       [r["round_ms"] for r in rounds])),
                                   hashes=hashes)
    finally:
        tdist.destroy_process_group()
    del params, step
    free(torch)
    return out


def lu_gloo_rank(rank: int, world: int, device, job: dict) -> dict:
    """One rank of phase 12b: shard ``rank`` of each codec of
    ``job["paths"]`` at ``job["layers"]`` layers over the gloo group's
    Fabric, then ``LU_GRAD_SYNC_STEPS`` steps with the grads averaged over
    the group; rank 0 also holds the ``f32`` path's round 1 against the
    virtual run's params (``job["dir"]``)."""
    import torch

    from repro_torch.comm.collectives import Fabric
    from repro_torch.kernels import dequant, quant
    from repro_torch.kernels.topk import topk_select
    from repro_torch.optim import LocalUpdatesConfig, adamw_init
    from repro_torch.utils.device import full_f32_matmul
    from repro_torch.utils.trees import tree_leaves

    full_f32_matmul()
    started = time.time() - job["spawned_at"]
    counters = ([topk_select]
                + [getattr(quant, f"quantize_pack_{c}") for c in CODECS]
                + [getattr(dequant, f"decode_reduce_{c}") for c in CODECS])
    cfg, _, params, opt_cfg, step_of = lu_model(torch, job["layers"], device)
    step = step_of()
    batches = lu_batches(torch, cfg, world, device)
    fab = Fabric()
    out = {"paths": {}, "started_s": started,
           "alloc_conf": os.environ.get("PYTORCH_CUDA_ALLOC_CONF")}
    for codec_name in job["paths"]:
        t0 = time.perf_counter()
        lc = LocalUpdatesConfig(H=LM_H, codec=codec_name)
        seen = {}

        def keep(t, p):
            if t == 1 and codec_name == "f32" and rank == 0:
                virt = torch.load(os.path.join(job["dir"], "virtual_f32.pt"))
                seen.update(f32_vs_virtual(torch, tree_leaves(p), virt))
            if t == 1:
                free_, total = torch.cuda.mem_get_info(device)
                seen["card_used_bytes"] = total - free_

        for fn in counters:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats(device)
        rounds = lu_dist_rounds(torch, step, params, opt_cfg, lc, batches,
                                fab, counters, keep=keep)[1]
        want_delta, want_opt, wire_dt, want_l = lu_expected(
            lc, params, world, LU_ROUNDS, counters)
        launches = {fn.__name__: fn.launches for fn in counters}
        out["paths"][codec_name] = dict(
            rounds=[lu_round_summary(r, want_delta, want_opt, world, wire_dt)
                    for r in rounds],
            launches=launches, launches_ok=launches == want_l,
            max_memory_allocated=torch.cuda.max_memory_allocated(device),
            seconds=time.perf_counter() - t0, **seen)
        free(torch)
    # synchronous data parallelism on the same ranks
    t0 = time.perf_counter()
    synced = step_of(grad_sync_axis=fab)
    p, o = params, adamw_init(params, opt_cfg)
    mine = {n: v[rank] for n, v in batches[0].items()}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for h in range(LU_GRAD_SYNC_STEPS):
        p, o, m = synced(p, o, {n: v[h] for n, v in mine.items()})
    end.record()
    torch.cuda.synchronize(device)
    out["grad_sync"] = dict(hash=tree_sha256(torch, p),
                            steps_ms=start.elapsed_time(end),
                            seconds=time.perf_counter() - t0)
    return out


def f32_vs_virtual(torch, got: list, want: list) -> dict:
    """The ``f32`` path's params against the virtual run's, leaf by leaf:
    the largest difference in units of the bf16 ulp at the virtual
    value (a mean that differs in its last f32 bits can round a param to
    its bf16 neighbour), and how many elements differ."""
    worst, differ, n = 0.0, 0, 0
    for a, b in zip(got, want):
        b = b.to(a.device).float()
        # |b| = m 2^e with m in [0.5, 1): bf16 keeps 8 significant bits
        ulp = torch.ldexp(torch.ones_like(b), torch.frexp(b).exponent - 8)
        diff = torch.abs(a.float() - b)
        worst = max(worst, float(torch.max(diff / ulp)))
        differ += int(torch.count_nonzero(diff))
        n += a.numel()
    return dict(f32_max_diff_bf16_ulps=worst, f32_elements_differing=differ,
                f32_elements=n)


def lu_gloo_phase(torch, counters, work, device="cuda") -> dict:
    """Phase 12b: the depth whose ``LU_K`` ranks fit (one rank's peak
    fitted from one-shard rounds at ``LU_PROBE_LAYERS``), ``virtual_round``
    at K = ``LU_K`` on each path twice, then ``LU_K`` gloo ranks on the
    one card (:func:`lu_gloo_rank`) held to it; returns each codec
    kernel's launches on rank 0 by path."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.launch.dist import spawn
    from repro_torch.optim import (LocalUpdatesConfig, adamw_init,
                                   init_delta_codec_state, virtual_round)
    from repro_torch.utils.device import full_f32_matmul
    from repro_torch.utils.trees import tree_leaves, tree_params

    full_f32_matmul()
    t0 = time.perf_counter()
    probe = {}
    for layers in LU_PROBE_LAYERS:
        free(torch)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        cfg, _, params, opt_cfg, step_of = lu_model(torch, layers, device)
        lc = LocalUpdatesConfig(H=LM_H, codec=LU_GLOO_PATHS[-1])
        virtual_round(step_of(), params, adamw_init(params, opt_cfg),
                      {n: v[:1] for n, v in lu_batches(
                          torch, cfg, 1, device)[0].items()}, lc,
                      init_delta_codec_state(params, lc, shards=1))
        torch.cuda.synchronize()
        probe[layers] = torch.cuda.max_memory_allocated() - held
        del params, step_of
    free(torch)
    (l0, p0), (l1, p1) = sorted(probe.items())
    per_layer = (p1 - p0) / (l1 - l0)

    def rank_bytes(layers):
        return p0 + per_layer * (layers - l0) + LU_CONTEXT_BYTES

    full_depth = get_config(LM_ARCH).num_layers
    layers = max((d for d in range(1, full_depth + 1)
                  if LU_K * rank_bytes(d) <= LU_GLOO_BYTES), default=None)
    if layers is None:
        raise SystemExit(f"chip_smoke: {LU_K} ranks of one layer need "
                         f"{LU_K * rank_bytes(1):.4g} bytes, over "
                         f"{LU_GLOO_BYTES:.4g} (probe peaks {probe})")
    probe_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    cfg, _, params, opt_cfg, step_of = lu_model(torch, layers, device)
    step = step_of()
    batches = lu_batches(torch, cfg, LU_K, device)
    virtual = {}
    for codec_name in LU_GLOO_PATHS:
        lc = LocalUpdatesConfig(H=LM_H, codec=codec_name)

        def keep(t, p):
            if t == 1 and codec_name == "f32":
                torch.save([x.cpu() for x in tree_leaves(p)],
                           os.path.join(work, "virtual_f32.pt"))
        # the second run covers round 1, the one held to the ranks
        virtual[codec_name] = [
            lu_virtual(torch, step, params, opt_cfg, lc, batches, keep=keep),
            lu_virtual(torch, step, params, opt_cfg, lc, batches[:1])]
    n_params = tree_params(params)
    want = {c: lu_expected(LocalUpdatesConfig(H=LM_H, codec=c), params,
                           LU_K, LU_ROUNDS, counters) for c in LU_GLOO_PATHS}
    del params, step, step_of, batches
    free(torch)
    virtual_s = time.perf_counter() - t0
    parent_held = torch.cuda.memory_allocated()

    t0 = time.perf_counter()
    job = dict(layers=layers, paths=LU_GLOO_PATHS, dir=work,
               spawned_at=time.time())
    ranks = spawn(LU_K, lu_gloo_rank, backend="gloo", device="cuda",
                  init_file=os.path.join(work, "lu_gloo"), args=(job,),
                  timeout_s=900)
    spawn_s = time.perf_counter() - t0
    out, ok = {}, True
    for codec_name in LU_GLOO_PATHS:
        got = [r["paths"][codec_name] for r in ranks]
        virt = virtual[codec_name]
        hashes = [[rd["hash"] for rd in g["rounds"]] for g in got]
        losses = np.array([[rd["loss"] for rd in g["rounds"]] for g in got])
        checks = dict(
            ranks_agree=all(h == hashes[0] for h in hashes),
            deterministic=virt[0][0] == virt[1][0],
            bytes=all(rd["bytes_ok"] for g in got for rd in g["rounds"]),
            dtypes=all(rd["dtypes_ok"] for g in got for rd in g["rounds"]),
            launches=all(g["launches_ok"] for g in got),
            # the shards' mean at the first step against the last round's
            # last step
            loss_falls=float(losses[:, -1, -1].mean())
            < float(losses[:, 0, 0].mean()))
        checks["plain"] = all(plain_held(
            g["rounds"][0]["plain_vs_kernel"], 0 if codec_name == "f32"
            else 2) for g in got)
        if codec_name == "f32":
            f = got[0]
            checks["f32_within_a_bf16_ulp"] = (
                f["f32_max_diff_bf16_ulps"] <= 1.0
                and f["f32_elements_differing"] <= 1e-5 * f["f32_elements"])
        else:
            checks["round1_equals_virtual"] = (hashes[0][0]
                                               == virt[0][0]["hash"])
        ok &= all(checks.values())
        tokens = LU_K * LM_H * LM_BATCH * LM_SEQ
        r0 = got[0]["rounds"]
        line = dict(
            path=codec_name, group="gloo", K=LU_K, ranks_on="cuda:0",
            arch=cfg.name, layers=layers, params=n_params, H=LM_H,
            batch=LM_BATCH, seq=LM_SEQ, rounds=LU_ROUNDS, lr=LM_LR,
            sync_opt_state=True, checks=checks,
            delta_wire_bytes=want[codec_name][0],
            opt_sync_model_bytes=want[codec_name][1],
            launches_rank0=got[0]["launches"],
            loss_by_rank=losses.tolist(),
            virtual_round1_hash_equal_by_rank=[
                h[0] == virt[0][0]["hash"] for h in hashes],
            rounds_rank0=r0,
            plain_vs_kernel_by_rank=[g["rounds"][0]["plain_vs_kernel"]
                                     for g in got],
            round_ms_by_rank=[[rd["round_ms"] for rd in g["rounds"]]
                              for g in got],
            opt_sync_ms_by_rank=[[rd["opt_sync_ms"] for rd in g["rounds"]]
                                 for g in got],
            tokens_per_s=[tokens / rd["round_ms"] * 1e3 for rd in r0],
            tokens_per_s_label=(f"{LU_K} processes time-sharing one card in "
                                f"a gloo group, every payload through the "
                                f"host: not a multi-GPU number"),
            max_memory_allocated_by_rank=[g["max_memory_allocated"]
                                          for g in got],
            card_used_bytes_by_rank=[g["card_used_bytes"] for g in got],
            seconds_by_rank=[g["seconds"] for g in got],
            **({k: got[0][k] for k in ("f32_max_diff_bf16_ulps",
                                         "f32_elements_differing",
                                         "f32_elements")}
               if codec_name == "f32" else {}))
        emit(phase="lu_gloo_path", **line)
        out[codec_name] = dict(launches=got[0]["launches"])
    gs = [r["grad_sync"] for r in ranks]
    grad_ok = len({g["hash"] for g in gs}) == 1
    alloc = [r["alloc_conf"] for r in ranks]
    phase_done(torch, "lu_gloo", t0, K=LU_K, layers=layers,
               full_depth=full_depth, probe_peak_bytes=probe,
               per_layer_bytes=per_layer,
               rank_bytes_model=rank_bytes(layers),
               context_bytes_assumed=LU_CONTEXT_BYTES,
               budget_bytes=LU_GLOO_BYTES, probe_seconds=probe_s,
               parent_memory_allocated=parent_held,
               virtual_seconds=virtual_s, spawn_seconds=spawn_s,
               rank_started_seconds=[r["started_s"] for r in ranks],
               alloc_conf_by_rank=alloc,
               grad_sync=dict(steps=LU_GRAD_SYNC_STEPS, ranks_agree=grad_ok,
                              steps_ms_by_rank=[g["steps_ms"] for g in gs]))
    if not (ok and grad_ok and alloc == [os.environ.get(
            "PYTORCH_CUDA_ALLOC_CONF")] * LU_K):
        raise SystemExit("chip_smoke: a gloo local-update path failed a "
                         "check (see its lu_gloo_path line and the lu_gloo "
                         "line)")
    return out


def analysis_phase(torch, work) -> None:
    """Phase 13: ``python -m repro_torch.analysis --cells all --inject
    wire-f32`` on ``LU_K`` gloo ranks on the card, in one group: every
    reference cell clean, the injected cell tripping wire-dtype and
    bytes-match (so the CLI's exit code is 1)."""
    import io

    from repro_torch.analysis import run as analysis_run
    from repro_torch.analysis.cells import all_cells
    t0 = time.perf_counter()
    path = os.path.join(work, "ANALYSIS.json")
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        rc = analysis_run.main(["--cells", "all", "--devices", str(LU_K),
                                "--inject", "wire-f32", "--out", path])
    with open(path) as f:
        report = json.load(f)
    errors = [x for x in report["findings"] if x["severity"] == "error"]
    injected = [x for x in errors if "injected-f32-wire" in x["cell"]]
    checks = dict(
        exit_code=rc == 1,
        clean=len(injected) == len(errors),
        tripped={x["rule"] for x in injected} == {"bytes-match",
                                                  "wire-dtype"},
        cells=report["summary"]["cells"] == len(all_cells()) + 1)
    phase_done(torch, "analysis", t0, K=LU_K, ranks_on="cuda:0",
               cells=report["summary"]["cells"], summary=report["summary"],
               rules=[r["id"] for r in report["rules"]], checks=checks,
               findings_outside_the_injected_cell=len(errors) - len(injected),
               injected_findings=len(injected), exit_code=rc)
    if not all(checks.values()):
        raise SystemExit("chip_smoke: the analysis sweep found an error or "
                         "missed the injected one (see the analysis line):\n"
                         + printed.getvalue()[-4000:])


def kernel_launches(counters) -> dict:
    return {fn.__name__: fn.launches for fn in counters}


def reset_launches(counters) -> None:
    for fn in counters:
        fn.launches = 0


def step_cost(torch, fn) -> dict:
    """One call of ``fn``: its milliseconds (CUDA events, after a warm
    call) and the kernels it launched (a profiler trace)."""
    fn()
    ms = time_ms(fn, reps=2, warmup=0)
    trace = device_trace(fn)
    kernels = sum(v["calls"] for v in trace.get("kernels", {}).values())
    return dict(ms=ms, kernels=kernels,
                device_busy_ms=trace.get("device_busy_ms", "not measured"))


def mesh_train_decode_phase(torch, counters, work, lu_hashes=None,
                            device="cuda") -> dict:
    """14a: tinyllama on a (1, 1) mesh over a 1-rank NCCL group; returns
    the kernels' launches in the local-updates round."""
    import torch.distributed as tdist

    from repro_torch.comm.collectives import Fabric
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import build
    from repro_torch.launch.dist import init_group
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim import (LocalUpdatesConfig, adamw_init,
                                   local_updates_round)
    from repro_torch.serve.decode import greedy_generate, make_serve_step
    from repro_torch.utils.device import full_f32_matmul
    from repro_torch.utils.trees import tree_map

    full_f32_matmul()
    free(torch)
    t0 = time.perf_counter()
    cfg, model, params, opt_cfg, step_of = lu_model(torch, None, device)
    step, sched = step_of(), lu_schedule()
    rnd = {k: v[0] for k, v in lu_batches(torch, cfg, 1, device)[0].items()}
    batch = {k: v[0] for k, v in rnd.items()}
    opt0 = adamw_init(params, opt_cfg)
    init_group("nccl", "file://" + os.path.join(work, "mesh_nccl"), 1, 0)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")

        def whole(tree):
            return tree_map(lambda t: t.full_tensor()
                            if hasattr(t, "full_tensor") else t, tree)
        # one train step both ways
        p1, _, m1 = step(params, opt0, batch)
        shape = ShapeConfig("mesh_train", LM_SEQ, LM_BATCH, "train")
        built = build.lower_train(cfg, shape, mesh, opt_cfg=opt_cfg,
                                  schedule=sched, values=(params, opt0, batch))
        p2, _, m2 = built.run()
        train = dict(
            loss=float(m1["loss"]), loss_equal=bits_equal(
                torch, m1["loss"], m2["loss"].full_tensor()),
            params_equal=tree_sha256(torch, p1) == tree_sha256(
                torch, whole(p2)),
            plain=step_cost(torch, lambda: step(params, opt0, batch)),
            partitioned=step_cost(torch, built.run), notes=built.notes)
        del p1, p2, m1, m2
        free(torch)
        # one local-updates round both ways, int8: K2 and K3 launch
        lc = LocalUpdatesConfig(H=LM_H, codec="int8")
        reset_launches(counters)
        pu, _, mu = local_updates_round(step, params, opt0, rnd, lc, Fabric())
        plain_l = kernel_launches(counters)
        h_plain = tree_sha256(torch, pu)
        del pu
        free(torch)
        reset_launches(counters)
        lu = build.lower_train_local_updates(
            cfg, shape, mesh, H=LM_H, codec="int8", opt_cfg=opt_cfg,
            schedule=sched, values=(params, opt0, rnd))
        pl, _, ml = lu.run()
        mesh_l = kernel_launches(counters)
        h_mesh = tree_sha256(torch, whole(pl))
        del pl
        free(torch)
        local = dict(
            params_equal=h_plain == h_mesh, launches=mesh_l,
            launches_equal=mesh_l == plain_l,
            k2_k3_launched=(mesh_l.get("quantize_pack_int8", 0) > 0
                            and mesh_l.get("decode_reduce_int8", 0) > 0),
            loss_equal=bits_equal(torch, mu["loss"][-1],
                                  ml["loss"].full_tensor()
                                  if hasattr(ml["loss"], "full_tensor")
                                  else ml["loss"]),
            same_as_phase_12=(None if not lu_hashes
                              else lu_hashes[0] == h_mesh),
            wire_bytes=ml["wire_bytes"])
        # greedy decode: a prefill, then MESH_DECODE[2] steps, both ways
        B, S, n = MESH_DECODE
        gen = torch.Generator(device=device).manual_seed(7)
        prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                               device=device, dtype=torch.int32)
        ids_ref = greedy_generate(model, params, prompt, max_new=n + 1)
        serve = make_serve_step(model)
        with torch.inference_mode():
            st = model.init_states(params, B, S + n + 1)
            lg, st = model.prefill(params, {"tokens": prompt}, st)
            plain_logits, tok, t_plain = [lg[:, -1]], None, 0.0
            tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
            plain_ids = [tok]
            for t in range(S, S + n):
                pos = torch.full((B, 1), t, dtype=torch.int32, device=device)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                lg, st = serve(params, st, tok, pos)
                torch.cuda.synchronize()
                t_plain += time.perf_counter() - t1
                tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
                plain_logits.append(lg[:, -1])
                plain_ids.append(tok)
            del st
            st = model.init_states(params, B, S + n + 1)
            pre = build.lower_prefill(
                cfg, ShapeConfig("mesh_prefill", S, B, "prefill"), mesh,
                values=(params, {"tokens": prompt}, st),
                last_logits_only=False)
            lg, dst = pre.run()
            dec = build.lower_decode(
                cfg, ShapeConfig("mesh_decode", S + n + 1, B, "decode"),
                mesh, values=(params, dst, prompt[:, :1], prompt[:, :1]))
            lg = lg.full_tensor()
            mesh_logits = [lg[:, -1]]
            tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
            mesh_ids, t_mesh = [tok], 0.0
            dparams, dst = dec.args[0], dec.args[1]
            from repro_torch.launch import sharding as sh
            for t in range(S, S + n):
                pos = torch.full((B, 1), t, dtype=torch.int32, device=device)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                with build.partitioning(mesh):
                    lg, dst = dec.step(dparams, dst,
                                       sh.distribute(tok, dec.specs[2], mesh),
                                       sh.distribute(pos, dec.specs[3], mesh))
                torch.cuda.synchronize()
                t_mesh += time.perf_counter() - t1
                lg = lg.full_tensor()
                tok = lg[:, -1].argmax(-1).to(torch.int32)[:, None]
                mesh_logits.append(lg[:, -1])
                mesh_ids.append(tok)
        decode = dict(
            rows=B, prompt=S, steps=n,
            ids_equal_greedy_generate=bool(torch.equal(
                torch.cat(mesh_ids, 1), ids_ref)) and bool(torch.equal(
                    torch.cat(plain_ids, 1), ids_ref)),
            logits_equal=all(bits_equal(torch, a, b) for a, b in
                             zip(plain_logits, mesh_logits)),
            step_ms=dict(plain=t_plain / n * 1e3,
                         partitioned=t_mesh / n * 1e3))
        checks = dict(train_loss=train["loss_equal"],
                      train_params=train["params_equal"],
                      lu_params=local["params_equal"],
                      lu_loss=local["loss_equal"],
                      lu_kernels=local["k2_k3_launched"],
                      lu_launches=local["launches_equal"],
                      lu_phase_12=local["same_as_phase_12"] is not False,
                      decode_ids=decode["ids_equal_greedy_generate"],
                      decode_logits=decode["logits_equal"])
        phase_done(torch, "mesh_1x1", t0, arch=cfg.name,
                   layers=cfg.num_layers, mesh="(1, 1) data x model, nccl",
                   batch=LM_BATCH, seq=LM_SEQ, H=LM_H, train=train,
                   local_updates=local, decode=decode, checks=checks)
        if not all(checks.values()):
            raise SystemExit(f"chip_smoke: the partitioned paths on the (1, "
                             f"1) mesh differ from the unpartitioned ones "
                             f"{checks} (see the mesh_1x1 line)")
    finally:
        tdist.destroy_process_group()
    del params, opt0
    free(torch)
    return mesh_l


def mesh_moe_phase(torch, work, device="cuda") -> None:
    """14b: MESH_MOE's arch at phase 11's widths on a (1, 1) mesh: its
    first MoE block on DTensors takes _moe_sharded (the counter shows
    it) and equals moe_apply bit for bit, and so does the prefill."""
    import torch.distributed as tdist

    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import build
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.dist import init_group
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import build_model
    from repro_torch.models import layers as L
    from repro_torch.models.transformer import _period, layer_plan
    from repro_torch.utils.device import full_f32_matmul
    from repro_torch.utils.trees import tree_map

    full_f32_matmul()
    free(torch)
    t0 = time.perf_counter()
    arch, layers, B, S = MESH_MOE
    full = get_config(arch)
    cfg = dataclasses.replace(full, num_layers=layers)
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0))
    plan = layer_plan(cfg)
    # the first MoE layer's channel block (the prologue's are dense)
    k = next(i for i, (_, ch) in enumerate(plan) if ch == "moe")
    c, slot = divmod(k - cfg.moe.first_k_dense, _period(cfg))
    moe_p = tree_map(lambda a: a[c], params["stack"][slot]["channel"])
    gen = torch.Generator(device=device).manual_seed(11)
    x = torch.randn((B, S, cfg.d_model), generator=gen, device=device
                    ).to(torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                           device=device, dtype=torch.int32)
    init_group("nccl", "file://" + os.path.join(work, "mesh_moe"), 1, 0)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), "cuda")
        with torch.inference_mode():
            y_plain, aux_plain = L.moe_apply(moe_p, cfg, x)
            before = dict(L.MOE_PATHS)
            specs = sh.param_specs({"channel": moe_p}, mesh,
                                   fsdp=True)["channel"]
            dmoe = sh.distribute(moe_p, specs, mesh)
            with build.partitioning(mesh):
                y_mesh, aux_mesh = L.moe_apply(
                    dmoe, cfg, sh.distribute(x, ("data", None, None), mesh))
            block_paths = {n: L.MOE_PATHS[n] - before[n] for n in before}
            block_equal = bits_equal(torch, y_plain, y_mesh.full_tensor())
            aux_equal = bits_equal(torch, aux_plain, aux_mesh.full_tensor())
            del y_plain, y_mesh
            st = model.init_states(params, B, S)
            lg_plain, _ = model.prefill(params, {"tokens": prompt}, st,
                                        last_logits_only=True)
            del st
            before = dict(L.MOE_PATHS)
            pre = build.lower_prefill(
                cfg, ShapeConfig("mesh_moe_prefill", S, B, "prefill"), mesh,
                values=(params, {"tokens": prompt},
                        model.init_states(params, B, S)))
            lg_mesh, _ = pre.run()
            prefill_paths = {n: L.MOE_PATHS[n] - before[n] for n in before}
            prefill_equal = bits_equal(torch, lg_plain, lg_mesh.full_tensor())
        n_moe = sum(ch == "moe" for _, ch in plan)
        checks = dict(block_sharded=block_paths == {"global": 0, "sharded": 1},
                      block_equal=block_equal, aux_equal=aux_equal,
                      prefill_sharded=prefill_paths == {
                          "global": 0, "sharded": n_moe},
                      prefill_equal=prefill_equal)
        phase_done(torch, "mesh_moe_1x1", t0, arch=arch, layers=layers,
                   of_layers=full.num_layers, batch=B, prompt=S,
                   moe_layers=n_moe, block_paths=block_paths,
                   prefill_paths=prefill_paths, checks=checks,
                   max_memory_allocated=torch.cuda.max_memory_allocated())
        if not all(checks.values()):
            raise SystemExit(f"chip_smoke: the expert-parallel MoE on the "
                             f"(1, 1) mesh differs from moe_apply {checks} "
                             f"(see the mesh_moe_1x1 line)")
    finally:
        tdist.destroy_process_group()
    del params, moe_p
    free(torch)


def mesh_gloo_cfg():
    from repro_torch.configs import get_config
    full = get_config(MESH_GLOO["arch"])
    E = MESH_GLOO["experts"]
    moe = dataclasses.replace(full.moe, num_experts=E, capacity_factor=E)
    return full, dataclasses.replace(full, moe=moe)


def mesh_gloo_rank(rank: int, world: int, device, job: dict) -> dict:
    """One rank of 14c: the MoE layer on its (2, 2) mesh coordinate."""
    import torch

    from repro_torch.comm.collectives import recording
    from repro_torch.launch import build
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import layers as L
    _, cfg = mesh_gloo_cfg()
    p = L.init_moe(torch.Generator(device=device).manual_seed(0), cfg,
                   dtype=torch.float32)
    x = torch.randn((MESH_GLOO["batch"], MESH_GLOO["seq"], cfg.d_model),
                    generator=torch.Generator(device=device).manual_seed(1),
                    device=device) * 0.1
    mesh = make_mesh((2, 2), ("data", "model"), "cuda")
    before = dict(L.MOE_PATHS)
    with recording() as log, build.partitioning(mesh), torch.no_grad():
        y, aux = L.moe_apply(p, cfg, x)
    torch.cuda.synchronize()
    return dict(y=y.cpu(), aux=float(aux), coord=mesh.get_coordinate(),
                paths={n: L.MOE_PATHS[n] - before[n] for n in before},
                log=[(c.op, c.nbytes, c.staged, c.K) for c in log],
                max_memory_allocated=torch.cuda.max_memory_allocated())


def mesh_gloo_phase(torch, work, device="cuda") -> None:
    """14c: 4 gloo ranks on the card as a (2, 2) mesh against the
    single-process moe_apply."""
    from repro_torch.analysis.traffic import all_to_all_bytes
    from repro_torch.comm.collectives import LoggedCall
    from repro_torch.launch.dist import spawn
    from repro_torch.models import layers as L
    from repro_torch.models.layers import _capacity

    free(torch)
    t0 = time.perf_counter()
    full, cfg = mesh_gloo_cfg()
    res = spawn(LU_K, mesh_gloo_rank, backend="gloo", device=device,
                init_file=os.path.join(work, "mesh_gloo"), args=({},),
                timeout_s=600)
    p = L.init_moe(torch.Generator(device=device).manual_seed(0), cfg,
                   dtype=torch.float32)
    B, S = MESH_GLOO["batch"], MESH_GLOO["seq"]
    x = torch.randn((B, S, cfg.d_model),
                    generator=torch.Generator(device=device).manual_seed(1),
                    device=device) * 0.1
    with torch.no_grad():
        y_ref, _ = L.moe_apply(p, cfg, x)
    y_ref = y_ref.cpu()
    rows = B // 2
    tp = 2
    C_loc = _capacity(cfg.moe, rows * S, False)
    true_a2a = 2 * cfg.moe.num_experts * C_loc * cfg.d_model * 4 * (tp - 1) \
        // tp
    per_rank, ok = [], True
    for r in res:
        d = r["coord"][0]
        want = y_ref[d * rows:(d + 1) * rows]
        err = float((r["y"] - want).abs().max())
        a2a = [LoggedCall(op, "float32", n, st, None, None, K)
               for op, n, st, K in r["log"] if op == "all_to_all"]
        logged = all_to_all_bytes(a2a, tp)
        rank_ok = (err <= MESH_GLOO_RTOL * float(want.abs().max())
                   and r["paths"] == {"global": 0, "sharded": 1}
                   and logged == true_a2a and len(a2a) == 2)
        ok &= rank_ok
        per_rank.append(dict(coord=r["coord"], max_abs_err=err,
                             max_abs_ref=float(want.abs().max()),
                             all_to_all_calls=len(a2a),
                             all_to_all_logged_bytes=logged,
                             calls=[c[:3] for c in r["log"]],
                             max_memory_allocated=r["max_memory_allocated"],
                             ok=rank_ok))
    phase_done(torch, "mesh_gloo_moe", t0, arch=full.name, mesh="(2, 2) gloo "
               "ranks on cuda:0", d_model=cfg.d_model, top_k=cfg.moe.top_k,
               d_expert=cfg.moe.d_expert,
               experts=dict(published=full.moe.num_experts,
                            run=cfg.moe.num_experts),
               capacity_factor=cfg.moe.capacity_factor, batch=B, seq=S,
               C_loc=C_loc, true_all_to_all_bytes_a_rank=true_a2a,
               rtol=MESH_GLOO_RTOL, ranks=per_rank, ok=ok)
    if not ok:
        raise SystemExit("chip_smoke: the 4-rank expert-parallel MoE "
                         "differs from moe_apply or its all-to-all bytes "
                         "from the form's (see the mesh_gloo_moe line)")
    free(torch)


def mesh_dry_rows() -> list:
    """The dry-run and roofline of MESH_DRY on a fake 16 x 16 group, on
    the host (no card): per pair, per-device bytes (the peak live ones
    against the card's 80 GB) and the dominant term."""
    import torch
    import torch.distributed as tdist

    from repro_torch.launch import dryrun, roofline
    torch.set_num_threads(1)
    rows = []
    try:
        for arch, shape in MESH_DRY:
            t1 = time.perf_counter()
            rec = dryrun.run_pair(arch, shape, multi_pod=False, verbose=False)
            roof = roofline.roofline_pair(arch, shape, dry=rec)
            b = rec["per_device_bytes"]
            rows.append(dict(
                arch=arch, shape=shape, status=rec["status"],
                depth=rec["depth"], notes=rec["notes"],
                arguments=b["arguments"], outputs=b["outputs"],
                aliased=b["aliased"], peak_live=b["peak_live"],
                fits_80GB=b["peak_live"] < CARD_BYTES, flops=rec["flops"],
                collective_bytes=rec["collective_operand_bytes"],
                collectives=rec["collectives"], dominant=roof["dominant"],
                dominant_fused=roof["dominant_fused"],
                terms_s={k: roof[k] for k in ("compute_s", "memory_s",
                                              "memory_products_s",
                                              "collective_s")},
                seconds=time.perf_counter() - t1))
    finally:
        if tdist.is_initialized():
            tdist.destroy_process_group()
    return rows


def pin_away_from(core: int) -> list:
    """Move every thread of this process off ``core`` (the threads it
    starts later, and the processes it spawns, inherit the mask), so that
    a child pinned to ``core`` shares no core with what this process
    times; returns the cores left to this process."""
    rest = sorted(os.sched_getaffinity(0) - {core})
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), rest)
        except ProcessLookupError:      # a thread that has ended
            pass
    return rest


def start_mesh_dry(work: str):
    """14d in a child process on the host while the card works: ``python
    chip_smoke.py --mesh-dry-run <json>``, pinned to the last of this
    process's cores, which this process and the ranks it spawns then
    leave to it (one thread: the timed phases' host work keeps the other
    cores); returns (the process, its JSON path, its log path)."""
    import atexit
    out = os.path.join(work, "mesh_dry.json")
    log = os.path.join(work, "mesh_dry.log")
    cores = sorted(os.sched_getaffinity(0))
    core = cores[-1]
    rest = pin_away_from(core) if len(cores) > 1 else cores
    with open(log, "w") as f:
        proc = subprocess.Popen([sys.executable, os.path.abspath(__file__),
                                 "--mesh-dry-run", out], cwd=ROOT,
                                stdout=f, stderr=subprocess.STDOUT)
    atexit.register(stop_process, proc)
    # before its interpreter has started a thread: they inherit the mask
    os.sched_setaffinity(proc.pid, {core})
    emit(phase="mesh_dry_start", child_core=core, main_cores=rest)
    return proc, out, log


def stop_process(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def mesh_dry_phase(torch, dry, timeout_s: float = 600) -> None:
    """14d: wait for the child :func:`start_mesh_dry` started and emit its
    rows."""
    proc, out, log = dry
    t0 = time.perf_counter()
    try:
        rc = proc.wait(timeout=timeout_s)
    finally:
        stop_process(proc)
    rows = []
    if rc == 0:
        with open(out) as f:
            rows = json.load(f)
    ok = rc == 0 and bool(rows) and all(r["status"] == "ok" for r in rows)
    emit(phase="mesh_dry_run", waited_seconds=time.perf_counter() - t0,
         mesh="16x16", device="fake group of 256 on the host", pairs=rows,
         ok=ok)
    if not ok:
        with open(log) as f:
            tail = f.read()[-4000:]
        raise SystemExit(f"chip_smoke: the dry-run child failed (rc {rc}):"
                         f"\n{tail}")


def mesh_phase(torch, counters, work, dry, lu_hashes=None) -> dict:
    """Phase 14 (14a to 14d); returns 14a's local-updates launches."""
    t14 = time.perf_counter()
    mesh_l = mesh_train_decode_phase(torch, counters, work, lu_hashes)
    mesh_moe_phase(torch, work)
    mesh_gloo_phase(torch, work)
    mesh_dry_phase(torch, dry)
    emit(phase="mesh", seconds=time.perf_counter() - t14)
    return mesh_l


def bench_phase(torch, calls: dict, bounds: dict, timing_ms: dict,
                card: str) -> None:
    """Phase 15: the bench harness on the card. ``BENCH_SPECS`` are
    registered and run through ``run.run_benchmarks``, each timing its
    kernels' ``calls`` (key: (fn, reps)) by ``device_ms``, with the
    kernels' ``bounds`` as counters; every result must be ``ok``, load
    back through ``schema.load`` with an ``env`` naming ``card`` (the
    card and its power limit as nvidia-smi prints them), compare equal to
    itself (``compare.main`` exits 0) and, with one timing doubled, exit
    1 and print REGRESSION; a spec sleeping past its budget must come
    back ``timeout``. Printed: each spec's device times beside phase 5's
    (``timing_ms``)."""
    import io
    import tempfile

    t0 = time.perf_counter()

    def spec(keys):
        def fn(ctx):
            timings, counters, rows = {}, {}, []
            for key in keys:
                call, reps = calls[key]
                guards = []
                t = device_ms(call, reps, KERNEL_NAMES[key], guards)
                if not isinstance(t, float):
                    raise RuntimeError(f"{key}: device time {t} "
                                       f"(trace guard {guards})")
                timings[f"{key}_device_s"] = t / 1e3
                counters[f"{key}_bound_ms"] = bounds[key][0]
                rows.append(dict(kernel=key, trace_guard=guards[0]))
            return dict(params={key: calls[key][1] for key in keys},
                        timings_s=timings, counters=counters, rows=rows)
        return fn

    def sleep(ctx):
        time.sleep(BENCH_SLEEP[0])
        return {}

    for name, keys in BENCH_SPECS.items():
        registry.benchmark(name, description=", ".join(keys)
                           + " at the main path's shapes")(spec(keys))
    registry.benchmark("chip_smoke_sleep")(sleep)

    def quiet(argv):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = compare.main(argv)
        return rc, buf.getvalue().splitlines()

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "results")
        results = run.run_benchmarks(only=list(BENCH_SPECS), out_dir=out)
        failed = {r.benchmark: r.notes for r in results if r.status != "ok"}
        if failed:
            raise SystemExit(f"chip_smoke: bench specs failed: {failed}")
        slept = run.run_benchmarks(only=["chip_smoke_sleep"],
                                   out_dir=os.path.join(tmp, "sleep"),
                                   timeout_s=BENCH_SLEEP[1], verbose=False)[0]
        paths = {r.benchmark: os.path.join(out, schema.result_filename(
            r.benchmark)) for r in results}
        loaded = {name: schema.load(path) for name, path in paths.items()}
        envs = {name: f"{r.env.device_kind}, {r.env.power_limit}"
                for name, r in loaded.items()}
        itself = {name: quiet([path, path])[0] for name, path in paths.items()}
        # a copy of K1's result with its timing doubled (K1's ~3.6 ms is
        # above compare's --min-time floor of 0.1 ms; K2's ~3 us is not)
        first = next(iter(BENCH_SPECS))
        doubled = loaded[first].to_dict()
        metric = sorted(doubled["timings_s"])[0]
        doubled["timings_s"][metric] *= 2
        doubled_path = os.path.join(tmp, "doubled",
                                    schema.result_filename(first))
        os.makedirs(os.path.dirname(doubled_path))
        with open(doubled_path, "w") as f:
            json.dump(doubled, f)
        doubled_rc, doubled_lines = quiet([paths[first], doubled_path])
        env = dataclasses.asdict(loaded[first].env)
    kernels = {row["kernel"]: dict(
        harness_device_ms=r.timings_s[f"{row['kernel']}_device_s"] * 1e3,
        timing_phase_device_ms=timing_ms[row["kernel"]],
        bound_ms=r.counters[f"{row['kernel']}_bound_ms"],
        trace_guard=row["trace_guard"]) for r in results for row in r.rows}
    ok = dict(env_names_the_card=all(e == card for e in envs.values()),
              compare_itself_exits_0=all(rc == 0 for rc in itself.values()),
              compare_doubled_exits_1=doubled_rc == 1,
              doubled_prints_regression=any("REGRESSION" in ln
                                            for ln in doubled_lines),
              sleep_times_out=slept.status == "timeout")
    phase_done(torch, "bench_harness", t0, kernels=kernels,
               status={r.benchmark: r.status for r in results},
               wall_s={r.benchmark: r.wall_s for r in results},
               env=env, env_card=envs, card=card, compare_itself=itself,
               compare_doubled=dict(metric=metric, exit=doubled_rc,
                                    lines=doubled_lines),
               sleep=dict(status=slept.status, wall_s=slept.wall_s,
                          slept_s=BENCH_SLEEP[0], budget_s=BENCH_SLEEP[1],
                          notes=slept.notes), checks=ok)
    if not all(ok.values()):
        raise SystemExit(f"chip_smoke: the bench harness failed "
                         f"{[k for k, v in ok.items() if not v]} (see the "
                         f"bench_harness line)")


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
    ap.add_argument("--long-m", type=int, default=350000,
                    help="examples of the long-row path (webspam's)")
    ap.add_argument("--long-n", type=int, default=1024)
    ap.add_argument("--long-rounds", type=int, default=30)
    ap.add_argument("--only-mesh", action="store_true",
                    help="build the kernels and run phase 14 alone (no "
                         "result line)")
    ap.add_argument("--mesh-dry-run", metavar="JSON",
                    help="(phase 14d's child) write the dry-run rows of "
                         "MESH_DRY to JSON; needs no card")
    args = ap.parse_args(argv)
    if args.mesh_dry_run:
        rows = mesh_dry_rows()
        with open(args.mesh_dry_run, "w") as f:
            json.dump(rows, f)
        return 0

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    import numpy as np

    from repro_torch.carry import ReplayIndices
    from repro_torch.comm.codec import get_codec
    from repro_torch.core import (CoCoAConfig, CoCoATrainer, ExchangeConfig,
                                  MinibatchSCD, MinibatchSGD, SGDConfig)
    from repro_torch.core.solvers import (scd_steps, scd_steps_fixed_point,
                                          scd_steps_fixed_point_batched)
    from repro_torch.data import make_glm_data
    from repro_torch.kernels import _build, bmv, dequant, quant, scd, topk
    from repro_torch.kernels.scd import scd_solve
    from repro_torch.kernels.topk import (topk_plan, topk_select,
                                          topk_select_ref)
    from repro_torch.utils.device import full_f32_matmul

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
    counters = ([scd_solve] + list(enc.values()) + list(dec.values())
                + [topk_select, bmv.batched_matvec, bmv.batched_vecmat])
    if args.only_mesh:
        work = os.path.join(ROOT, "build", "chip_smoke_mesh")
        shutil.rmtree(work, ignore_errors=True)
        os.makedirs(work)
        try:
            mesh_phase(torch, counters, work, start_mesh_dry(work))
        finally:
            shutil.rmtree(work, ignore_errors=True)
        return 0

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
    codec_plans["topk"] = dict(k=k_main, **dataclasses.asdict(topk_plan(
        K, m, k_main, max_active_clusters=lambda p: topk.max_active_clusters(
            dev, p))))
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
    # the fixed-order batched products at the baselines' shapes: mini-
    # batch SCD's A_T w and Delta v, SGD's on the (K, m/K, n) row blocks
    # and local SGD's on (K, 205, n) gathered rows, then ragged,
    # misaligned and expanded cases; each within the dot-product bound of
    # its plain version, and each worker's block alone bit for bit equal
    # to its rows of the K-worker launch (mini-batch SCD's and SGD's)
    blocks = tr.A[:K * (m // K)].view(K, m // K, -1)
    n_cols = blocks.shape[2]

    def rnd(*shape, scale=1.0):
        return torch.randn(shape, generator=g, device=dev) * scale

    bmv_cases = [
        ("minibatch_scd", tr.A_T, w0, rnd(K, n_pad, scale=1e-3)),
        ("sgd_h1", blocks, rnd(n_cols, scale=1e-2), rnd(K, m // K)),
        ("local_sgd", blocks[:, :205].contiguous(), rnd(K, n_cols, scale=1e-2),
         rnd(K, 205)),
        ("ragged, x misaligned", rnd(3, 33, 97), rnd(3, 98)[:, 1:],
         rnd(3, 33)),
        ("one vector expanded", rnd(5, 17, 258), rnd(258).expand(5, -1),
         rnd(5, 17))]
    over_bound, bmv_alone = {}, {}
    for key in ("matvec", "vecmat"):
        ok[key], err[key] = True, 0.0
    for label, M_, x_, y_ in bmv_cases:
        xs = x_.expand(M_.shape[0], -1) if x_.dim() == 1 else x_
        for key, got, want, bound in (
                ("matvec", bmv.batched_matvec(M_, x_),
                 bmv.batched_matvec_ref(M_, x_),
                 dot_bound(M_.shape[2]) * bmv.batched_matvec_ref(
                     M_.abs(), xs.abs())),
                ("vecmat", bmv.batched_vecmat(y_, M_),
                 bmv.batched_vecmat_ref(y_, M_),
                 dot_bound(M_.shape[1]) * bmv.batched_vecmat_ref(
                     y_.abs(), M_.abs()))):
            diff = (got - want).abs()
            ok[key] &= bool((diff <= bound).all())
            err[key] = max(err[key], max_err(got, want))
            over_bound[f"{key} {label} {list(M_.shape)}"] = float(
                (diff / bound.clamp_min(1e-30)).max())
            if label in ("minibatch_scd", "sgd_h1"):
                alone = [bmv.batched_matvec(
                    M_[k_:k_ + 1], x_ if x_.dim() == 1 else x_[k_:k_ + 1])
                    if key == "matvec" else
                    bmv.batched_vecmat(y_[k_:k_ + 1], M_[k_:k_ + 1])
                    for k_ in range(M_.shape[0])]
                bmv_alone[f"{key} {label}"] = all(
                    bits_equal(torch, a[0], got[k_])
                    for k_, a in enumerate(alone))
                ok[key] &= bmv_alone[f"{key} {label}"]
    del bmv_cases, blocks, M_, x_, y_, xs, got, want, bound, diff, alone
    free(torch)
    phase_done(torch, "kernels_vs_plain", t0,
               ok=ok, max_abs_err=err, scd_by_cluster=scd_by_c,
               tolerance={"scd_solve": "rtol 1e-4, atol 1e-5",
                          "quantize, decode and topk": "bit-identical",
                          "matvec and vecmat": (
                              "|kernel - plain| <= 2 gamma_n sum_j "
                              "|products|, gamma_n = n u / (1 - n u), "
                              "u = 2^-24; a worker alone bit-identical "
                              "to its rows of the K launch")},
               bmv_err_over_bound=over_bound,
               bmv_worker_alone_bit_identical=bmv_alone,
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

    # -- 2b. each kernel at the shapes its first designs refused --------
    t0 = time.perf_counter()
    gl = torch.Generator(device=dev).manual_seed(args.seed + 1)
    long_ok, long_err, long_plans = {}, {}, {}
    for K_, m_, n_, H_, cl_ in SCD_LONG:
        A_T = torch.randn((K_, n_, m_), generator=gl, device=dev)
        A_T[:, -1] = 0.0                                  # a zero column
        args_ = (A_T, torch.sum(A_T * A_T, dim=2),
                 torch.randn((K_, n_), generator=gl, device=dev) * 0.1,
                 torch.randn((m_,), generator=gl, device=dev),
                 torch.randint(0, n_, (K_, H_), generator=gl, device=dev,
                               dtype=torch.int32))
        kw_ = dict(sigma=float(K_), lam=args.lam, eta=1.0)
        dv_c, al_c = scd_solve(*args_, cluster=cl_, **kw_)
        dv_p, al_p = scd_steps(*args_, **kw_)
        name = (f"scd_solve {K_}x{m_}, n_pad {n_}, H {H_}"
                + (f", C {cl_}" if cl_ else ""))
        long_plans[name] = dataclasses.asdict(scd_solve.last_plan)
        long_ok[name] = (torch.allclose(dv_c, dv_p, rtol=1e-4, atol=1e-5)
                         and torch.allclose(al_c, al_p, rtol=1e-4, atol=1e-5))
        long_err[name] = max(max_err(dv_c, dv_p), max_err(al_c, al_p))
        err["scd_solve"] = max(err["scd_solve"], long_err[name])
        del A_T, args_, dv_c, al_c, dv_p, al_p
        free(torch)
    for shape in QUANT_LONG:
        x = torch.randn(shape, generator=gl, device=dev)
        x[1] *= 1e-6
        for c in CODECS:
            pk, sk = enc[c](x)
            pp, sp = enc_ref[c](x)
            name = f"quantize_pack_{c} {shape}"
            long_plans[name] = dataclasses.asdict(
                quant.quant_plan(*shape, BITS[c]))
            long_ok[name] = (bits_equal(torch, pk, pp)
                             and bits_equal(torch, sk, sp))
            long_err[name] = max(max_err(pk, pp), max_err(sk, sp))
            err[c] = max(err[c], long_err[name])
            for mean in (False, True):
                out_k = dec[c](pk, sk, shape[1], mean=mean)
                out_p = dec_ref[c](pk, sk, shape[1], mean=mean)
                name = f"decode_reduce_{c} {shape} mean={mean}"
                long_ok[name] = bits_equal(torch, out_k, out_p)
                long_err[name] = max_err(out_k, out_p)
                err[f"decode_{c}"] = max(err[f"decode_{c}"], long_err[name])
        del x, pk, sk, pp, sp, out_k, out_p
    for (K_, L_), kk in TOPK_LONG:
        x = torch.randn((K_, L_), generator=gl, device=dev)
        if K_ > 1:                       # a row of ties and +x/-x pairs
            x[-1] = torch.randint(-3, 4, (L_,), generator=gl,
                                  device=dev).float()
        got, want = topk_select(x, kk), topk_select_ref(x, kk)
        name = f"topk_select {K_}x{L_}, k {kk}"
        long_plans[name] = dataclasses.asdict(topk_select.last_plan)
        long_ok[name] = all(bits_equal(torch, a, b_)
                            for a, b_ in zip(got, want))
        long_err[name] = max(max_err(got[0], want[0]),
                             max_err(got[2], want[2]),
                             max_err(got[1].long(), want[1].long()))
        err["topk"] = max(err["topk"], long_err[name])
        del x, got, want
    # the grid forms, forced, at rows that put every key in one bin (the
    # passes past the candidate cap read x again) or tie across the pass
    # tiles; k = 1, ceil(L/100), L; x aligned and one float off
    for K_, L_ in GRID_LONG:
        for off in (0, 1):
            x = torch.randn(K_ * L_ + off, generator=gl,
                            device=dev)[off:].view(K_, L_)
            x[0] = torch.randint(-3, 4, (L_,), generator=gl,
                                 device=dev).float()
            x[1] = 0.0
            x[2] = 0.0
            x[2, L_ // 2] = -1.5
            for kk in sorted({1, -(-L_ // 100), L_}):
                got, want = topk_select(x, kk, grid=True), topk_select_ref(
                    x, kk)
                name = f"topk_select grid {K_}x{L_} +{off}, k {kk}"
                long_plans[name] = dataclasses.asdict(topk_select.last_plan)
                long_ok[name] = all(bits_equal(torch, a, b_)
                                    for a, b_ in zip(got, want))
                long_err[name] = max(max_err(got[0], want[0]),
                                     max_err(got[2], want[2]),
                                     max_err(got[1].long(), want[1].long()))
                err["topk"] = max(err["topk"], long_err[name])
                del got, want
            for c in CODECS:
                pk, sk = enc[c](x, grid=True)
                pp, sp = enc_ref[c](x)
                name = f"quantize_pack_{c} grid {K_}x{L_} +{off}"
                long_plans[name] = dataclasses.asdict(
                    quant.quant_plan(K_, L_, BITS[c], grid=True))
                long_ok[name] = (bits_equal(torch, pk, pp)
                                 and bits_equal(torch, sk, sp))
                long_err[name] = max(max_err(pk, pp), max_err(sk, sp))
                err[c] = max(err[c], long_err[name])
                del pk, sk, pp, sp
            del x
    # the main path's stack in K4's device-memory form, which phase 5
    # times against the shared form the plan takes there
    for kk in (k_main, m):
        got = topk_select(dv_k, kk, survivors="device")
        want = topk_select_ref(dv_k, kk)
        name = f"topk_select {K}x{m}, k {kk}, survivors in device memory"
        long_plans[name] = dataclasses.asdict(topk_select.last_plan)
        long_ok[name] = all(bits_equal(torch, a, b_)
                            for a, b_ in zip(got, want))
        long_err[name] = max(max_err(got[0], want[0]),
                             max_err(got[2], want[2]),
                             max_err(got[1].long(), want[1].long()))
        err["topk"] = max(err["topk"], long_err[name])
        del got, want
    free(torch)
    phase_done(torch, "kernels_vs_plain_long", t0, ok=long_ok,
               max_abs_err=long_err, plans=long_plans,
               tolerance={"scd_solve": "rtol 1e-4, atol 1e-5",
                          "quantize, decode and topk": "bit-identical"})
    if not all(long_ok.values()):
        raise SystemExit("chip_smoke: a kernel disagrees with its plain "
                         "version at a long shape (see the "
                         "kernels_vs_plain_long line)")

    # -- 3. the main paths ----------------------------------------------

    def plans_of(tr, c):
        """The plans K1 and the path's codec kernels took on ``tr``."""
        K_, _, m_ = tr.A_T.shape
        out = {"scd_solve": dataclasses.asdict(scd_solve.last_plan)}
        if c == "topk":
            out["topk_select"] = dataclasses.asdict(topk_select.last_plan)
        else:
            out[f"quantize_pack_{c}"] = dataclasses.asdict(
                quant.quant_plan(K_, m_, BITS[c]))
        return out

    def run_path(line, ex, c, go, tr, k1, extra, bmv_each=None):
        """Run one path (``go()``, every round recorded) on trainer ``tr``
        with every launch counter set to 0 just before and read just
        after: the path's codec kernels, and K1 when ``k1``, must launch
        once a round, the batched products ``bmv_each[name]`` times a
        round, and no other kernel at all. ``extra(hist)`` adds the
        path's own fields to its line. A CoCoA trainer's data go to the
        card before the peak-memory window opens."""
        if isinstance(tr, CoCoATrainer):
            tr._round_fn  # noqa: B018 (places the data)
        held = torch.cuda.memory_allocated()
        for fn in counters:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        hist = go()
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counters}
        n_rounds = len(hist.rounds)
        r2e = hist.rounds_to(args.eps)
        sec = np.array(hist.seconds)
        exchanged = not ex.startswith("(none)")
        phase_done(torch, line, t0, exchange=ex, rounds=n_rounds,
                   rounds_to_eps=r2e if r2e is not None else "not reached",
                   eps=args.eps, final_subopt=hist.subopt[-1],
                   subopt=hist.subopt,
                   round_ms_median=float(np.median(sec)) * 1e3,
                   round_ms_max=float(sec.max()) * 1e3,
                   round_ms_quartiles=(np.percentile(sec, [25, 75])
                                       * 1e3).tolist(),
                   comm_bytes_per_round=(tr.comm_bytes_per_round()
                                         if exchanged else "no exchange"),
                   comm_bytes_by_round=(
                       [tr.comm_bytes_per_round(t) for t in hist.rounds]
                       if "drop:" in ex else "every round the same"),
                   memory_allocated_before=held,
                   max_memory_allocated=torch.cuda.max_memory_allocated(),
                   launches=launches, **extra(hist))
        want = {fn.__name__: 0 for fn in counters}
        want.update({name: n_rounds for name in
                     (("scd_solve",) if k1 else ()) + own_kernels(c)})
        want.update({name: n * n_rounds
                     for name, n in (bmv_each or {}).items()})
        if launches != want:
            raise SystemExit(f"chip_smoke: under {ex} ({line}) "
                             f"{'K1 and ' if k1 else ''}the {c} kernels must "
                             f"launch once per round ({n_rounds} rounds), "
                             f"the batched products {bmv_each} times a "
                             f"round and no other kernel, got {launches}")
        if not (np.all(np.isfinite(hist.primal))
                and np.all(np.isfinite(tr.alpha_final))
                and tr.alpha_final.shape == (tr.n,)
                and hist.span == [1] * n_rounds
                and hist.subopt[-1] < 1.0):
            raise SystemExit(f"chip_smoke: the {ex} path's output ({line}) "
                             f"is not finite, not of shape (n,), or made no "
                             f"progress")
        return dict(primal=hist.primal, rounds=n_rounds, launches=launches,
                    rounds_to_eps=r2e)

    def drive(tr, ex, c, rounds, line):
        """One CoCoA path: K1 and the path's codec kernels once a round."""
        path_p_star = tr.p_star  # solved outside the path's peak memory
        return run_path(line, ex, c, lambda: tr.run(rounds,
                                                    target_eps=args.eps),
                        tr, True, lambda h: dict(p_star=path_p_star,
                                                 plans=plans_of(tr, c)))

    runs = {}
    for ex, c in PATHS:
        if tr is None:
            tr = CoCoATrainer(dataclasses.replace(cfg, exchange=ex), A, b)
        runs[ex] = drive(tr, ex, c, args.rounds, "main_path")
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

    # -- 4b. the long-row path: webspam's row count ---------------------
    t0 = time.perf_counter()
    AL, bL, _ = make_glm_data(m=args.long_m, n=args.long_n,
                              density=args.density, zipf_a=1.1,
                              seed=args.seed)
    cfgL = dataclasses.replace(cfg, H=-(-args.long_n // args.K),
                               exchange=LONG_PATHS[0][0])
    phase_done(torch, "long_setup", t0, m=args.long_m, n=args.long_n,
               K=args.K, H=cfgL.H, density=args.density)
    long_runs = {}
    for ex, c in LONG_PATHS:
        trL = CoCoATrainer(dataclasses.replace(cfgL, exchange=ex), AL, bL)
        long_runs[ex] = drive(trL, ex, c, args.long_rounds, "long_row_path")
        del trL
        free(torch)
        # the first rounds again with the plain SCD on the same index
        # stream (the dot's sum order differs, hence rtol 1e-4)
        t0 = time.perf_counter()
        trP = CoCoATrainer(dataclasses.replace(cfgL, exchange=ex,
                                               solver="scd_ref"), AL, bL)
        primal = trP.run(n_chk).primal
        del trP
        free(torch)
        want = long_runs[ex]["primal"][:n_chk]
        rel = (np.abs(np.array(primal) - want) / np.abs(want)).tolist()
        phase_done(torch, "long_row_plain_vs_kernel", t0, exchange=ex,
                   primal_rel=rel, tolerance="rtol 1e-4")
        if max(rel) > 1e-4:
            raise SystemExit(f"chip_smoke: the long-row path under {ex} "
                             f"left the plain SCD's primal by {max(rel)}")

    # -- 4c. the baselines at the main shape ----------------------------
    def reached(hist):
        return {str(e): hist.rounds_to(e) or "not reached"
                for e in BASELINE_EPS}

    t0 = time.perf_counter()
    cfg_scd = dataclasses.replace(cfg, exchange="compressed:int8")
    trB = MinibatchSCD(cfg_scd, A, b)                # solver -> scd_fixed
    base_p_star, base_p_zero = trB.p_star, trB.p_zero
    L_ridge = lipschitz(torch, trB.A, args.lam)
    phase_done(torch, "baselines_setup", t0, p_star=base_p_star,
               p_zero=base_p_zero, lipschitz=L_ridge,
               power_iterations=POWER_ITERS, scd_solver=trB.cfg.solver)
    label = "minibatch_scd compressed:int8"
    runs[label] = run_path(
        "baseline_path", "compressed:int8", "int8",
        lambda: trB.run(SCD_ROUNDS, target_eps=BASELINE_EPS[0]), trB, False,
        lambda h: dict(path=label, H=cfg_scd.H, rounds_to_each_eps=reached(h),
                       cocoa_rounds_to_eps=(
                           runs["compressed:int8"]["rounds_to_eps"]
                           or "not reached")),
        bmv_per_round("minibatch_scd"))
    t0 = time.perf_counter()
    trace = device_trace(lambda: trB.run(5))
    phase_done(torch, "baseline_trace", t0, path=label, rounds=5, **trace)
    del trB
    free(torch)
    # (a) the first rounds again through the step loop, the batched
    # solve's plain version, on the same index stream
    t0 = time.perf_counter()
    trL = MinibatchSCD(cfg_scd, A, b)
    trL._algo.solver = scd_steps_fixed_point
    trL._p_star_cache = base_p_star      # the same problem: solved once
    loop = trL.run(n_chk)
    del trL
    free(torch)
    want = runs[label]["primal"][:n_chk]
    rel = (np.abs(np.array(loop.primal) - want) / np.abs(want)).tolist()
    phase_done(torch, "baseline_batched_vs_loop", t0, path=label,
               primal_rel=rel, loop_round_ms=[x * 1e3 for x in loop.seconds],
               tolerance="rtol 1e-4")
    if max(rel) > 1e-4:
        raise SystemExit(f"chip_smoke: mini-batch SCD's batched solve left "
                         f"the step loop's primal by {max(rel)}")

    sgd_stack = None
    for name, ex, H_s, frac, rounds, c in SGD_PATHS:
        cfg_s = SGDConfig(batch_frac=frac, step_size=1.0 / (
            L_ridge * (args.K if H_s > 1 else 1)), lam=args.lam, eta=1.0,
            K=args.K, H=H_s, seed=args.seed, exchange=ex)
        trS = MinibatchSGD(cfg_s, A, b)
        label = f"{name} {ex}"
        runs[label] = run_path(
            "baseline_path", ex, c, lambda: trS.run_workers(
                rounds, record_every=1, p_star=base_p_star,
                p_zero=base_p_zero), trS, False,
            lambda h: dict(path=label, H=H_s, batch_frac=frac,
                           batch_local=trS.batch_local,
                           step_size=cfg_s.step_size),
            bmv_per_round(name, H_s))
        if sgd_stack is None:
            # the path's round-1 gradient stack, which phase 5 times K2,
            # K3 and K4 on
            local0, alpha0_s = trS.init_state()
            sgd_stack = trS._algo.local_step(trS._data, local0, alpha0_s,
                                             trS.row_source(1), 1)[0]
            t0 = time.perf_counter()
            trace = device_trace(lambda: trS.run_workers(
                5, record_every=1, p_star=base_p_star, p_zero=base_p_zero))
            phase_done(torch, "baseline_trace", t0, path=label, rounds=5,
                       **trace)
            del local0, alpha0_s
        del trS
        free(torch)
    cfg_s = SGDConfig(batch_frac=LEGACY_FRAC, step_size=1.0 / L_ridge,
                      lam=args.lam, eta=1.0, K=args.K, seed=args.seed)
    trS = MinibatchSGD(cfg_s, A, b)
    run_path("baseline_path", "(none)", None, lambda: trS.run(
        LEGACY_ROUNDS, p_star=base_p_star, p_zero=base_p_zero,
        record_every=1), trS, False, lambda h: dict(
            path="sgd_run legacy", batch=trS.batch,
            step_size=cfg_s.step_size))
    del trS
    free(torch)

    # (b) a small problem on the card (kernels) and on the CPU (plain
    # versions) with one replayed stream
    t0 = time.perf_counter()
    small_rel, small_codes = {}, {}
    for name, ex, H_s, frac in SMALL_BASELINES:
        if H_s is None:
            cfg_b = CoCoAConfig(K=4, H=64, lam=1.0, exchange=ex,
                                seed=args.seed)
            probe = MinibatchSCD(cfg_b, As, bs, device="cpu").index_source

            def make(where, stream):
                return MinibatchSCD(cfg_b, As, bs, device=where,
                                    index_source=ReplayIndices(
                                        stream, device=where)).run(10)
        else:
            cfg_b = SGDConfig(batch_frac=frac, step_size=0.1, lam=1.0, K=4,
                              H=H_s, seed=args.seed, exchange=ex)
            probe = MinibatchSGD(cfg_b, As, bs, device="cpu").row_source

            def make(where, stream):
                return MinibatchSGD(cfg_b, As, bs, device=where,
                                    row_source=ReplayIndices(
                                        stream, device=where)).run_workers(
                                            10, record_every=1)
        stream = [probe(t).numpy() for t in range(1, 11)]
        codec = ExchangeConfig.parse(ex).scheme.codec
        small, sent = {}, {}
        for where in ("cuda", "cpu"):
            with recording(codec) as seen:
                small[where] = make(where, stream).primal
            sent[where] = seen
        bits = getattr(codec, "base", codec).bits
        small_codes[f"{name} {ex}"] = [
            codes_differ(torch, a[0], b_[0], bits)
            for a, b_ in zip(sent["cuda"], sent["cpu"])]
        small_rel[f"{name} {ex}"] = (
            np.abs(np.array(small["cuda"]) - small["cpu"])
            / np.abs(small["cpu"])).tolist()
    worst = {k: max(v) for k, v in small_rel.items()}
    phase_done(torch, "baseline_card_vs_cpu", t0, primal_rel=small_rel,
               primal_rel_max=worst, codes_differ_card_vs_cpu=small_codes,
               tolerance="rtol 1e-4")
    if max(worst.values()) > 1e-4:
        raise SystemExit("chip_smoke: a baseline's card and CPU runs "
                         "disagree (see the baseline_card_vs_cpu line)")

    # -- 5. timing at the main path's shapes ----------------------------
    t0 = time.perf_counter()
    tr = CoCoATrainer(cfg, A, b)                 # K1's inputs again
    alpha0, w0 = tr.init_state()
    idx1 = tr.index_source(1)
    L = m
    ms, plain = {}, {}
    ms["scd_solve"] = time_ms(lambda: scd_solve(
        tr.A_T, tr.col_sq, alpha0, w0, idx1, **kw), args.reps)
    plain["scd_solve"] = time_ms(lambda: scd_steps(
        tr.A_T, tr.col_sq, alpha0, w0, idx1, **kw), 3, warmup=1)
    scd_ms = {str(c): time_ms(lambda c=c: scd_solve(
        tr.A_T, tr.col_sq, alpha0, w0, idx1, cluster=c, **kw), args.reps)
        for c in fits}
    ms["topk"] = time_ms(lambda: topk_select(dv_k, k_main),
                         4 * args.reps)
    ms["topk_k_eq_L"] = time_ms(lambda: topk_select(dv_k, L),
                                args.reps)
    ms["topk_device_form"] = time_ms(lambda: topk_select(
        dv_k, k_main, survivors="device"), 4 * args.reps)
    plain["topk"] = time_ms(lambda: topk_select_ref(dv_k, k_main),
                            4 * args.reps)
    library = {"topk": time_ms(lambda: torch.topk(
        dv_k.abs(), k_main, dim=1, sorted=True), 4 * args.reps)}
    for c in CODECS:
        p, s, _ = main_payload[c]
        ms[c] = time_ms(lambda: enc[c](dv_k), 4 * args.reps)
        plain[c] = time_ms(lambda: enc_ref[c](dv_k), 4 * args.reps)
        ms[f"decode_{c}"] = time_ms(
            lambda: dec[c](p, s, L, mean=False), 4 * args.reps)
        plain[f"decode_{c}"] = time_ms(
            lambda: dec_ref[c](p, s, L, mean=False), 4 * args.reps)
    # the same calls again under the profiler: each kernel's own device
    # time per launch, without the host's part of the wrapper
    calls = {"scd_solve": (lambda: scd_solve(
        tr.A_T, tr.col_sq, alpha0, w0, idx1, **kw), args.reps),
        "topk": (lambda: topk_select(dv_k, k_main), 4 * args.reps),
        "topk_k_eq_L": (lambda: topk_select(dv_k, L), args.reps),
        "topk_device_form": (lambda: topk_select(dv_k, k_main,
                                                 survivors="device"),
                             4 * args.reps)}
    for c in CODECS:
        p, s, _ = main_payload[c]
        calls[c] = (lambda c=c: enc[c](dv_k), 4 * args.reps)
        calls[f"decode_{c}"] = (lambda p=p, s=s, c=c: dec[c](
            p, s, L, mean=False), 4 * args.reps)
    dev_ms = {key: device_ms(fn, n, KERNEL_NAMES[key])
              for key, (fn, n) in calls.items()}
    # K2 and K4 also at every C that fits the main path's stack
    ms_by_c, dev_by_c = {}, {}
    for key in CODECS + ("topk",):
        for cl in codec_fits[key]:
            fn = ((lambda cl=cl: topk_select(dv_k, k_main, cluster=cl))
                  if key == "topk" else
                  (lambda cl=cl, key=key: enc[key](dv_k, cluster=cl)))
            ms_by_c.setdefault(key, {})[str(cl)] = time_ms(
                fn, 4 * args.reps)
            dev_by_c.setdefault(key, {})[str(cl)] = device_ms(
                fn, 4 * args.reps, KERNEL_NAMES[key])
    bounds, distinct, scd_bytes = kernel_bounds(idx1, n_pad, m, k_main)
    bounds["topk_k_eq_L"] = kernel_bounds(idx1, n_pad, m, L)[0]["topk"]
    phase_done(torch, "timing", t0, reps=args.reps,
               distinct_columns=distinct, scd_bytes=scd_bytes,
               topk_k=k_main, wrapper_ms=ms, device_ms=dev_ms,
               bound_ms={key: b[0] for key, b in bounds.items()},
               topk_k_eq_L=dict(k=L, wrapper_ms=ms["topk_k_eq_L"],
                                device_ms=dev_ms["topk_k_eq_L"],
                                bound_ms=bounds["topk_k_eq_L"][0]),
               topk_device_form=dict(
                   k=k_main, wrapper_ms=ms["topk_device_form"],
                   device_ms=dev_ms["topk_device_form"],
                   shared_form_device_ms=dev_ms["topk"]),
               scd_ms_by_cluster=scd_ms, codec_ms_by_cluster=ms_by_c,
               codec_device_ms_by_cluster=dev_by_c,
               scd_bound_ratio_by_cluster={
                   c: t / bounds["scd_solve"][0] for c, t in scd_ms.items()})

    # mini-batch SCD's batched solve on K1's round-1 inputs, and K2, K3
    # and K4 on the SGD path's round-1 gradient stack (K, n)
    t0 = time.perf_counter()
    fixed = lambda: scd_steps_fixed_point_batched(   # noqa: E731
        tr.A_T, tr.col_sq, alpha0, w0, idx1, **kw)
    fixed_ms = time_ms(fixed, args.reps)
    fixed_trace = device_trace(lambda: [fixed()
                                               for _ in range(args.reps)])
    fixed_dev = (fixed_trace["device_busy_ms"] / args.reps
                 if "device_busy_ms" in fixed_trace else "not measured")
    a_t_bytes = tr.A_T.numel() * tr.A_T.element_size()
    # the form reads A_T twice (A_T @ w, then the change in alpha times
    # A_T); the function itself needs each input once
    fixed_two = bound_ms(2 * a_t_bytes, 4 * tr.A_T.numel())
    fixed_once = bound_ms(a_t_bytes + 4 * (3 * K * n_pad + m + K * m)
                          + 4 * idx1.numel(), 4 * tr.A_T.numel())
    visits = torch.zeros((K, n_pad), dtype=torch.int32, device=dev)
    visits.scatter_add_(1, idx1.long(), torch.ones_like(idx1))
    Ks, Ls = sgd_stack.shape
    k_sgd = get_codec(f"topk(r={TOPK_R:g})")._k(Ls)
    sgd_same, sgd_calls, sgd_plain = {}, {}, {}
    for c in ("int8", "int4"):
        pS, sS = enc[c](sgd_stack)
        pP, sP = enc_ref[c](sgd_stack)
        sgd_same[c] = bits_equal(torch, pS, pP) and bits_equal(torch, sS, sP)
        out_k, out_p = (dec[c](pS, sS, Ls, mean=False),
                        dec_ref[c](pS, sS, Ls, mean=False))
        sgd_same[f"decode_{c}"] = bits_equal(torch, out_k, out_p)
        err[c] = max(err[c], max_err(pS, pP), max_err(sS, sP))
        err[f"decode_{c}"] = max(err[f"decode_{c}"], max_err(out_k, out_p))
        if c == "int8":
            sgd_calls[c] = (lambda: enc["int8"](sgd_stack), 4 * args.reps)
            sgd_plain[c] = lambda: enc_ref["int8"](sgd_stack)
            sgd_calls["decode_int8"] = (lambda p=pS, s_=sS: dec["int8"](
                p, s_, Ls, mean=False), 4 * args.reps)
            sgd_plain["decode_int8"] = lambda p=pS, s_=sS: dec_ref["int8"](
                p, s_, Ls, mean=False)
    got, want = topk_select(sgd_stack, k_sgd), topk_select_ref(sgd_stack,
                                                                k_sgd)
    sgd_same["topk"] = all(bits_equal(torch, a, b_) for a, b_ in
                           zip(got, want))
    err["topk"] = max(err["topk"], max_err(got[0], want[0]),
                      max_err(got[2], want[2]),
                      max_err(got[1].long(), want[1].long()))
    sgd_calls["topk"] = (lambda: topk_select(sgd_stack, k_sgd), 4 * args.reps)
    sgd_plain["topk"] = lambda: topk_select_ref(sgd_stack, k_sgd)
    sgd_ms = {key: time_ms(fn, n) for key, (fn, n) in sgd_calls.items()}
    sgd_dev = {key: device_ms(fn, n, KERNEL_NAMES[key])
               for key, (fn, n) in sgd_calls.items()}
    sgd_plain_ms = {key: time_ms(fn, 4 * args.reps)
                    for key, fn in sgd_plain.items()}
    sgd_library = {"topk": time_ms(lambda: torch.topk(
        sgd_stack.abs(), k_sgd, dim=1, sorted=True), 4 * args.reps)}
    sgd_bounds = codec_bounds(Ks, Ls, k_sgd)
    sgd_row = {key: dict(
        shape=[Ks, Ls, k_sgd] if key == "topk" else [Ks, Ls],
        ms=sgd_ms[key], device_ms=sgd_dev[key],
        bound_ms=sgd_bounds[key][0], bound_by=sgd_bounds[key][1],
        bound_ratio=(sgd_dev[key] / sgd_bounds[key][0]
                     if isinstance(sgd_dev[key], float) else "not measured"),
        plain_ms=sgd_plain_ms[key], library_ms=sgd_library.get(key))
        for key in sgd_calls}
    phase_done(torch, "timing_baselines", t0, reps=args.reps,
               fixed_point_batched=dict(
                   shape=[K, n_pad, m, idx1.shape[1]], ms=fixed_ms,
                   device_ms=fixed_dev, passes=int(visits.max()),
                   bound_ms_two_passes=fixed_two[0],
                   bound_ms_inputs_once=fixed_once[0],
                   device_kernels=fixed_trace.get("kernels")),
               sgd_stack=sgd_row, bit_identical_to_plain=sgd_same)
    if not all(sgd_same.values()):
        raise SystemExit("chip_smoke: K2, K3 or K4 disagrees with its plain "
                         "version on the SGD path's gradient stack (see "
                         "the timing_baselines line)")
    del visits, got, want

    # the fixed-order batched products at their main-path shapes: mini-
    # batch SCD's (K, n_pad, m) stack (the kernels line's numbers) and
    # SGD H = 1's (K, m/K, n) row blocks; beside the plain versions, the
    # library's batched product and the loop of one library product a
    # worker that kept the bits K-independent before these kernels
    t0 = time.perf_counter()
    full_f32_matmul()
    blocks = tr.A[:K * (m // K)].view(K, m // K, -1)
    y_scd = torch.randn((K, n_pad), generator=g, device=dev) * 1e-3
    a_sgd = torch.randn((blocks.shape[2],), generator=g, device=dev) * 1e-2
    y_sgd = torch.randn((K, m // K), generator=g, device=dev)
    bmv_args = {"matvec": (tr.A_T, w0), "vecmat": (y_scd, tr.A_T),
                "matvec_sgd": (blocks, a_sgd), "vecmat_sgd": (y_sgd, blocks)}
    bmv_fn = {"matvec": (bmv.batched_matvec, bmv.batched_matvec_ref,
                         lambda M_, x_: torch.matmul(M_, x_),
                         lambda M_, x_: torch.stack([a @ x_ for a in M_])),
              "vecmat": (bmv.batched_vecmat, bmv.batched_vecmat_ref,
                         lambda y_, M_: torch.matmul(y_[:, None], M_)[:, 0],
                         lambda y_, M_: torch.stack(
                             [r @ a for r, a in zip(y_, M_)]))}
    bmv_row = {}
    for key, a_ in bmv_args.items():
        kern, ref_, lib, loop = bmv_fn[key.split("_")[0]]
        M_ = a_[0] if key.startswith("matvec") else a_[1]
        Kb, rb, cb = M_.shape
        nb = 4 * (Kb * rb * cb + Kb * rb                  # M, and y or x
                  + (cb if key.startswith("matvec") else Kb * cb))
        bnd = bound_ms(nb, 2 * Kb * rb * cb)
        dev_t = device_ms(lambda: kern(*a_), args.reps,
                          KERNEL_NAMES[key.split("_")[0]])
        bmv_row[key] = dict(
            shape=[Kb, rb, cb], ms=time_ms(lambda: kern(*a_),
                                           args.reps),
            device_ms=dev_t, bound_ms=bnd[0], bound_by=bnd[1],
            bound_ratio=(dev_t / bnd[0] if isinstance(dev_t, float)
                         else "not measured"),
            plain_ms=time_ms(lambda: ref_(*a_), 5, warmup=1),
            library_ms=time_ms(lambda: lib(*a_), args.reps),
            per_worker_loop_ms=time_ms(lambda: loop(*a_), args.reps))
    for key in ("matvec", "vecmat"):
        ms[key], dev_ms[key] = bmv_row[key]["ms"], bmv_row[key]["device_ms"]
        plain[key], library[key] = (bmv_row[key]["plain_ms"],
                                    bmv_row[key]["library_ms"])
        bounds[key] = (bmv_row[key]["bound_ms"], bmv_row[key]["bound_by"])
    phase_done(torch, "timing_bmv", t0, reps=args.reps, kernels=bmv_row,
               library="torch.matmul (batched), full f32",
               per_worker_loop="one torch.matmul a worker, stacked")
    del blocks, y_scd, a_sgd, y_sgd, bmv_args, a_, M_
    free(torch)

    # the same kernels at the long-row path's shapes: K1 on its round-1
    # inputs, K2, K3 and K4 on its round-1 Delta v stack
    t0 = time.perf_counter()
    trL = CoCoATrainer(cfgL, AL, bL)
    alphaL, wL = trL.init_state()
    idxL = trL.index_source(1)
    KL, n_padL, mL = trL.A_T.shape
    kwL = dict(sigma=cfgL.sigma_val, lam=cfgL.lam, eta=cfgL.eta)
    dvL, _ = scd_solve(trL.A_T, trL.col_sq, alphaL, wL, idxL, **kwL)
    kL = get_codec(f"topk(r={TOPK_R:g})")._k(mL)
    long_calls = {
        "scd_solve": (lambda: scd_solve(trL.A_T, trL.col_sq, alphaL, wL,
                                        idxL, **kwL), args.reps),
        "topk": (lambda: topk_select(dvL, kL), args.reps)}
    long_plain = {
        "scd_solve": lambda: scd_steps(trL.A_T, trL.col_sq, alphaL, wL,
                                       idxL, **kwL),
        "topk": lambda: topk_select_ref(dvL, kL)}
    same = {}                # K2 and K3 on the path's own Delta v
    for c in CODECS:
        pL, sL = enc[c](dvL)
        pP, sP = enc_ref[c](dvL)
        same[c] = bits_equal(torch, pL, pP) and bits_equal(torch, sL, sP)
        same[f"decode_{c}"] = bits_equal(
            torch, dec[c](pL, sL, mL, mean=False),
            dec_ref[c](pL, sL, mL, mean=False))
        long_calls[c] = (lambda c=c: enc[c](dvL), args.reps)
        long_plain[c] = lambda c=c: enc_ref[c](dvL)
        long_calls[f"decode_{c}"] = (lambda c=c, p=pL, s=sL: dec[c](
            p, s, mL, mean=False), args.reps)
        long_plain[f"decode_{c}"] = lambda c=c, p=pL, s=sL: dec_ref[c](
            p, s, mL, mean=False)
    long_ms = {key: time_ms(fn, n)
               for key, (fn, n) in long_calls.items()}
    long_dev = {key: device_ms(fn, n, KERNEL_NAMES[key])
                for key, (fn, n) in long_calls.items()}
    long_plain_ms = {key: time_ms(fn, 3, warmup=1)
                     for key, fn in long_plain.items()}
    long_library = {"topk": time_ms(lambda: torch.topk(
        dvL.abs(), kL, dim=1, sorted=True), args.reps)}
    # K4's plan at the long row (the widest C whose clusters are all
    # resident), and its device time when C is forced
    topk_select(dvL, kL)
    topk_long_plan = dataclasses.asdict(topk_select.last_plan)
    topk_long_by_c = {str(cl): device_ms(
        lambda cl=cl: topk_select(dvL, kL, cluster=cl), args.reps,
        "topk_kernel") for cl in (16, 8, 4)}
    # both forms of K4 (k at r = TOPK_R and 0.01) and K2 (int8) on each
    # side of the plans' switch to the grid form
    crossover = {}
    for K_, L_ in GRID_CROSSOVER:
        x = torch.randn((K_, L_), generator=g, device=dev) * 1e-3
        cells = {}
        for r in (TOPK_R, 0.01):
            kk = math.ceil(r * L_)
            cells[f"topk k={kk}"] = {
                "grid": lambda kk=kk: topk_select(x, kk, grid=True),
                "cluster": lambda kk=kk: topk_select(x, kk,
                                                     survivors="device")}
        cells["int8"] = {"grid": lambda: enc["int8"](x, grid=True),
                         "cluster": lambda: enc["int8"](x, grid=False)}
        crossover[f"{K_}x{L_}"] = {
            cell: {form: dict(ms=time_ms(fn, args.reps),
                              device_ms=device_ms(
                                  fn, args.reps,
                                  KERNEL_NAMES["int8" if cell == "int8"
                                               else "topk"]))
                   for form, fn in forms.items()}
            for cell, forms in cells.items()}
        crossover[f"{K_}x{L_}"]["planned"] = dict(
            topk=topk_plan(K_, L_, math.ceil(TOPK_R * L_)).variant,
            int8=quant.quant_plan(K_, L_, 8).variant)
        del x
    free(torch)
    long_bounds, long_distinct, long_scd_bytes = kernel_bounds(
        idxL, n_padL, mL, kL)
    long_row = {key: dict(
        shape=([KL, mL, n_padL, cfgL.H] if key == "scd_solve" else
               [KL, mL, kL] if key == "topk" else [KL, mL]),
        ms=long_ms[key], device_ms=long_dev[key],
        bound_ms=long_bounds[key][0], bound_by=long_bounds[key][1],
        bound_ratio=(long_dev[key] / long_bounds[key][0]
                     if isinstance(long_dev[key], float) else "not measured"),
        plain_ms=long_plain_ms[key], library_ms=long_library.get(key))
        for key in long_calls}
    phase_done(torch, "timing_long", t0, reps=args.reps,
               distinct_columns=long_distinct, scd_bytes=long_scd_bytes,
               topk_k=kL, kernels=long_row, topk_plan=topk_long_plan,
               topk_device_ms_by_cluster=topk_long_by_c,
               grid_crossover=crossover,
               bit_identical_to_plain=same)
    if not all(same.values()):
        raise SystemExit("chip_smoke: K2 or K3 disagrees with its plain "
                         "version on the long-row path's Delta v (see the "
                         "timing_long line)")
    del trL, alphaL, wL, idxL, dvL, long_calls, long_plain
    free(torch)

    # -- 6. device traces of compressed:int8 and ef:topk rounds ----------
    for ex in (PATHS[0][0], TOPK):
        t0 = time.perf_counter()
        if tr is None:
            tr = CoCoATrainer(dataclasses.replace(cfg, exchange=ex), A, b)
        tr.run(2)                    # p_star and the first rounds, untraced
        trace = device_trace(lambda: tr.run(5))
        tr = None
        free(torch)
        phase_done(torch, "trace", t0, exchange=ex, rounds=5, **trace)

    # -- 7. the sharded driver on a 1-rank NCCL group --------------------
    import torch.distributed as tdist

    from repro_torch.bench.timing import calibrate_link
    from repro_torch.comm.collectives import recording as record_calls
    from repro_torch.launch.dist import init_group, sha256, spawn
    t0 = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke_sharded")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    A1, b1, _ = make_glm_data(m=args.m, n=NCCL_N, density=args.density,
                              zipf_a=1.1, seed=args.seed)
    cfg1 = dataclasses.replace(cfg, K=1, H=NCCL_N)
    p1, nccl, nccl_ok = None, {}, True
    data_s = time.perf_counter() - t0
    init_group("nccl", "file://" + os.path.join(work, "nccl"), 1, 0)
    try:
        for ex in NCCL_PATHS:
            c1 = dataclasses.replace(cfg1, exchange=ex)
            t1 = time.perf_counter()
            trv = CoCoATrainer(c1, A1, b1)
            p1 = trv.p_star if p1 is None else p1
            trv._p_star_cache = p1           # the same problem: solved once
            hv = trv.run(NCCL_ROUNDS)
            virtual_s = time.perf_counter() - t1
            want = dict(primal=hv.primal, shared=sha256(trv.w_final),
                        local=sha256(trv.alpha),
                        plan=dataclasses.asdict(scd_solve.last_plan))
            del trv
            free(torch)
            trs = CoCoATrainer(c1, A1, b1)
            for fn in counters:
                fn.launches = 0
            t1 = time.perf_counter()
            with record_calls() as log:
                hs = trs.run_sharded(NCCL_ROUNDS, p_star=p1)
            torch.cuda.synchronize()
            sharded_s = time.perf_counter() - t1
            got = dict(primal=hs.primal, shared=sha256(trs.w_final),
                       local=sha256(trs.alpha),
                       plan=dataclasses.asdict(scd_solve.last_plan))
            launches = {fn.__name__: fn.launches for fn in counters}
            c = ExchangeConfig.parse(ex).scheme.codec.name.removeprefix("ef:")
            expect = {fn.__name__: 0 for fn in counters}
            expect.update({k_: NCCL_ROUNDS for k_ in ("scd_solve",)
                           + own_kernels(None if c == "f32" else
                                         "topk" if c.startswith("topk")
                                         else c)})
            nccl[ex] = dict(same_state=(got["shared"], got["local"])
                            == (want["shared"], want["local"]),
                            same_primal=got["primal"] == want["primal"],
                            plan_sharded=got["plan"],
                            plan_virtual=want["plan"],
                            calls_round_1=[[c_.op, c_.dtype, c_.nbytes,
                                            c_.staged]
                                           for c_ in log.of_round(1)],
                            launches=launches, virtual_seconds=virtual_s,
                            sharded_seconds=sharded_s,
                            sharded_round_ms=[x * 1e3 for x in hs.seconds])
            nccl_ok &= (nccl[ex]["same_state"] and nccl[ex]["same_primal"]
                        and launches == expect
                        and not any(c_.staged for c_ in log))
            del trs
            free(torch)
        t1 = time.perf_counter()
        nccl_links = {ex: link_fields(calibrate_link(ex, device=dev))
                      for ex in CALIBRATED_NCCL}
        calibrate_s = time.perf_counter() - t1
    finally:
        tdist.destroy_process_group()
    nccl_ok &= all(f["bandwidth_Bps"] == "inf" for f in nccl_links.values())
    phase_done(torch, "sharded_nccl", t0, data_seconds=data_s, K=1,
               m=args.m, n=NCCL_N,
               H=NCCL_N, rounds=NCCL_ROUNDS, p_star=p1, paths=nccl,
               links=nccl_links, calibrate_seconds=calibrate_s,
               links_label="calibrate_link on a 1-rank NCCL group: one rank "
                           "moves no bytes, so the bandwidth is inf and the "
                           "latency is the call's dispatch",
               note="a 1-rank NCCL group: NCCL refuses two ranks on one "
                    "card, so no multi-GPU exchange runs here")
    if not nccl_ok:
        raise SystemExit("chip_smoke: the 1-rank NCCL sharded run left the "
                         "virtual driver's state, staged a copy, launched "
                         "other kernels or fitted a finite bandwidth (see "
                         "the sharded_nccl line)")
    del A1, b1

    # -- 8. K ranks on the one card in a gloo group ------------------------
    t0 = time.perf_counter()
    part = CoCoATrainer(cfg, A, b).part
    part_s = time.perf_counter() - t0
    m_local = -(-args.m // args.K)
    np.save(os.path.join(work, "b.npy"), b)
    A_cols = np.ascontiguousarray(A.T)   # one pass; then each block is rows
    for k in range(args.K):
        np.save(os.path.join(work, f"cols{k}.npy"), A_cols[part.owned[k]])
        np.save(os.path.join(work, f"rows{k}.npy"),
                A[k * m_local:(k + 1) * m_local])
    del A_cols
    blocks_s = time.perf_counter() - t0 - part_s
    sgd_kw = dict(batch_frac=1.0, step_size=1.0 / L_ridge, lam=args.lam,
                  eta=1.0, K=args.K, H=1, seed=args.seed)
    virtual, job_paths = [], []
    for name, ex, rounds in GLOO_PATHS:
        if name == "sgd_h1":
            trv = MinibatchSGD(SGDConfig(exchange=ex, **sgd_kw), A, b)
            hv = trv.run_workers(rounds, record_every=1, p_star=p_star,
                                 p_zero=base_p_zero)
            shared, local, k1_plan = trv.alpha_final, None, None
        else:
            cls = CoCoATrainer if name == "cocoa" else MinibatchSCD
            trv = cls(dataclasses.replace(cfg, exchange=ex), A, b)
            trv._p_star_cache = p_star
            hv = trv.run(rounds or args.rounds,
                         target_eps=None if rounds else args.eps)
            shared, local = trv.w_final, trv.alpha
            k1_plan = (dataclasses.asdict(scd_solve.last_plan)
                       if name == "cocoa" else None)
        virtual.append(dict(primal=hv.primal, rounds=len(hv.rounds),
                            rounds_to_eps=hv.rounds_to(args.eps),
                            shared=sha256(shared),
                            local=None if local is None else sha256(local),
                            plan=k1_plan))
        job_paths.append((name, ex, len(hv.rounds),
                          None if rounds else args.eps))
        del trv
        free(torch)
    job = dict(dir=work, part=part, n=args.n, m=args.m, p_star=p_star,
               eps=args.eps,
               p_zero=base_p_zero, topk_k=k_main, paths=job_paths,
               sgd=sgd_kw, cocoa=dict(K=args.K, H=H, lam=args.lam, eta=1.0,
                                      solver="scd_kernel", seed=args.seed),
               calibrate=CALIBRATED_GLOO)
    phase_done(torch, "sharded_gloo_setup", t0, K=args.K,
               block_files=2 * args.K + 1, partition_seconds=part_s,
               blocks_seconds=blocks_s,
               virtual_rounds=[v["rounds"] for v in virtual])
    free(torch)
    t0 = time.perf_counter()
    job["spawned_at"] = time.time()
    try:
        ranks = spawn(args.K, sharded_rank, backend="gloo", device="cuda",
                      init_file=os.path.join(work, "gloo"), args=(job,),
                      timeout_s=600)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    spawn_s = time.perf_counter() - t0
    gloo_ok, gloo_paths = True, []
    for (name, ex, rounds, _), want, got in zip(
            job_paths, virtual, zip(*[r["paths"] for r in ranks])):
        r0 = got[0]
        transport = ExchangeConfig.parse(ex).scheme.transport
        codec = ExchangeConfig.parse(ex).scheme.codec.name.removeprefix("ef:")
        c = None if codec == "f32" else "topk" if codec.startswith(
            "topk") else codec
        plans_agree = all(g["plan"] == want["plan"] for g in got)
        rel = float(np.max(np.abs(np.array(r0["primal"]) - want["primal"])
                           / np.abs(want["primal"])))
        expect = {k_: 0 for k_ in r0["launches"]}
        expect.update({k_: len(r0["rounds"]) for k_ in (
            ("scd_solve",) if name == "cocoa" else ()) + own_kernels(c)})
        expect.update({k_: n * len(r0["rounds"])
                       for k_, n in bmv_per_round(name, 1).items()})
        checks = dict(
            ranks_agree=all(g["primal"] == r0["primal"]
                            and g["shared_sha256"] == r0["shared_sha256"]
                            for g in got),
            rounds=len(r0["rounds"]) == want["rounds"] == rounds,
            rounds_to_eps=all(g["rounds_to_eps"] == want["rounds_to_eps"]
                              for g in got),
            primal=rel <= (1e-6 if transport == "compressed" else 1e-4),
            bytes=all(g["derived_bytes"] == [g["model_bytes_all_live"]]
                      * len(g["rounds"]) for g in got),
            dtypes=all(g["f32_update_payloads"] == 0 for g in got)
            if transport == "compressed" else True,
            quantized=all(g["quantized_dtypes"] == (["int8"] if c == "int8"
                                                    else []) for g in got),
            launches=all(g["launches"] == expect for g in got),
            state=(not plans_agree or transport != "compressed"
                   or all((g["shared_sha256"], g["local_sha256"])
                          == (want["shared"], want["local"]) for g in got)))
        gloo_ok &= all(checks.values())
        med = [float(np.median(g["seconds"])) * 1e3 for g in got]
        line = dict(
            path=name, exchange=ex, rounds=len(r0["rounds"]),
            rounds_to_eps=want["rounds_to_eps"] or "not reached",
            checks=checks, primal_rel_max=rel,
            same_state_as_virtual=[(g["shared_sha256"], g["local_sha256"])
                                   == (want["shared"], want["local"])
                                   for g in got],
            plans_agree=plans_agree, plan_virtual=want["plan"],
            plan_rank0=r0["plan"],
            derived_bytes_rank0=sorted(set(r0["derived_bytes"])),
            model_bytes_by_round=r0["model_bytes"],
            payload_dtypes=r0["payload_dtypes"],
            calls_per_round=r0["calls_per_round"],
            staged_copies_rank0=r0["staged"],
            launches_rank0=r0["launches"],
            max_memory_allocated_by_rank=[g["max_memory_allocated"]
                                          for g in got],
            round_ms_median_by_rank=med,
            wall_seconds_by_rank=[g["wall_s"] for g in got],
            round_ms_label=(f"{args.K} processes time-sharing one card in a "
                            f"gloo group, every payload through the host: "
                            f"not a multi-GPU number"))
        emit(phase="sharded_gloo_path", **line)
        gloo_paths.append(line)
    phase_done(torch, "sharded_gloo", t0, K=args.K, ranks_on="cuda:0",
               backend="gloo", spawn_seconds=spawn_s,
               rank_loaded_seconds=[r["loaded_s"] for r in ranks],
               rank_started_seconds=[r["started_s"] for r in ranks],
               rank_cuda_context_seconds=[r["cuda_context_s"] for r in ranks],
               rank_blocks_loaded_seconds=[r["blocks_loaded_s"]
                                           for r in ranks],
               rank0_trace_and_timing_seconds=ranks[0]["trace_and_timing_s"],
               trace_rank0=ranks[0]["trace"],
               kernels_rank0=ranks[0]["kernels"],
               note=f"{args.K} processes on one card in a gloo group: "
                    f"correctness, bytes and dtypes on the card, not a "
                    f"multi-GPU number")
    if not gloo_ok:
        raise SystemExit("chip_smoke: a sharded gloo path failed a check "
                         "(see its sharded_gloo_path line)")
    gloo_links = {ex: [r["links"][ex] for r in ranks]
                  for ex in CALIBRATED_GLOO}
    emit(phase="sharded_gloo_links", K=args.K, fits_by_rank=gloo_links,
         seconds_by_rank=[r["calibrate_s"] for r in ranks],
         label=f"calibrate_link, each rank's own fit: {args.K} processes "
               f"time-sharing one card in a gloo group, every payload "
               f"staged through the host; host staging and time-slicing, "
               f"never an NVLink number")
    if not all(isinstance(f["bandwidth_Bps"], float)
               and f["bandwidth_Bps"] > 0 and f["latency_s"] >= 0
               for fits in gloo_links.values() for f in fits):
        raise SystemExit("chip_smoke: a gloo rank's link fit is not a "
                         "finite positive bandwidth and a latency (see the "
                         "sharded_gloo_links line)")

    # -- 9. the trade-off path: the H sweep at the main shape -----------
    from repro_torch.bench.timing import synthetic_link
    from repro_torch.core import PROFILES
    from repro_torch.core.tradeoff import (TimeModel, autotune_H,
                                           compute_fraction_at, make_trainer,
                                           optimal_H, sweep_H)
    t9 = t0 = time.perf_counter()
    cfg9 = dataclasses.replace(cfg, exchange=SWEEP_EXCHANGE)
    codec9 = own_kernels(SWEEP_EXCHANGE.partition(":")[2])
    for fn in counters:
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    sweep = sweep_H(A, b, cfg9, SWEEP_GRID, eps=args.eps,
                    max_rounds=SWEEP_MAX_ROUNDS, measure=True)
    torch.cuda.synchronize()
    sweep_launches = {fn.__name__: fn.launches for fn in counters}
    # every point runs to eps (or the cap), then measure_solver_time runs
    # MEASURED_ROUNDS at its H; and as many at H = n_local for t_ref
    ran = sum(p_.rounds_to_eps or SWEEP_MAX_ROUNDS for p_ in sweep.points)
    timed = MEASURED_ROUNDS * (len(SWEEP_GRID) + 1)
    want = {fn.__name__: 0 for fn in counters}
    want.update({k_: ran + timed for k_ in ("scd_solve",) + codec9})
    Hs = np.array([p_.H for p_ in sweep.points], float)
    ts = np.array([p_.t_solver_s for p_ in sweep.points])
    slope, intercept = (float(x) for x in np.polyfit(Hs, ts, 1))
    phase_done(torch, "tradeoff_sweep", t0, exchange=sweep.exchange,
               K=sweep.workers, n_local=sweep.n_local, eps=sweep.eps,
               points=[dict(H=p_.H, rounds_to_eps=p_.rounds_to_eps
                            or "not reached", t_solver_s=p_.t_solver_s)
                       for p_ in sweep.points],
               t_ref_s=sweep.t_ref_s, fit_slope_s_per_step=slope,
               fit_intercept_s=intercept,
               comm_bytes_per_round=sweep.comm_bytes_per_round,
               launches=sweep_launches, rounds_run=ran,
               rounds_timed=timed,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    if sweep_launches != want:
        raise SystemExit(f"chip_smoke: the sweep must launch K1 and the "
                         f"{SWEEP_EXCHANGE} kernels once a round "
                         f"({ran + timed} rounds) and no other kernel, got "
                         f"{sweep_launches}")
    if not any(p_.rounds_to_eps for p_ in sweep.points) or not all(
            np.isfinite(ts) & (ts > 0)) or not sweep.t_ref_s > 0:
        raise SystemExit("chip_smoke: no sweep point reached eps, or one "
                         "timed no positive solver time (see the "
                         "tradeoff_sweep line)")

    # each point again on one trainer whose data every H shares: its
    # launches and peak memory, then a trace of a few of its rounds (K1's
    # device time a launch, the host's share of the round)
    t0 = time.perf_counter()
    tr9 = CoCoATrainer(cfg9, A, b)
    tr9.p_star  # noqa: B018 (solved once, outside every window)
    tr9._round_fn  # noqa: B018 (places the data)
    setup9_s = time.perf_counter() - t0
    k1_by_H = {}
    for p_ in sweep.points:
        t0 = time.perf_counter()
        trH = tr9.with_H(p_.H)
        held = torch.cuda.memory_allocated()
        for fn in counters:
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        hist = trH.run(SWEEP_MAX_ROUNDS, target_eps=args.eps)
        torch.cuda.synchronize()
        launches = {fn.__name__: fn.launches for fn in counters}
        peak = torch.cuda.max_memory_allocated()
        n_rounds = len(hist.rounds)
        trace = device_trace(lambda: trH.run(SWEEP_TRACE_ROUNDS))
        k1 = [v for name_, v in trace.get("kernels", {}).items()
              if KERNEL_NAMES["scd_solve"] in name_]
        calls = sum(v["calls"] for v in k1)
        k1_ms = (sum(v["device_ms"] for v in k1) / calls if calls
                 else "not measured")
        k1_by_H[p_.H] = k1_ms
        round_ms = trace["window_ms"] / SWEEP_TRACE_ROUNDS
        want = {fn.__name__: 0 for fn in counters}
        want.update({k_: n_rounds for k_ in ("scd_solve",) + codec9})
        phase_done(
            torch, "tradeoff_point", t0, H=p_.H,
            rounds_to_eps=p_.rounds_to_eps,
            rounds_to_eps_again=hist.rounds_to(args.eps),
            t_solver_ms=p_.t_solver_s * 1e3, k1_device_ms=k1_ms,
            t_solver_minus_k1_ms=(p_.t_solver_s * 1e3 - k1_ms
                                  if calls else "not measured"),
            traced_round_ms=round_ms,
            host_share_of_traced_round=(
                1.0 - trace["busy_share_of_window"]
                if "busy_share_of_window" in trace else "not measured"),
            round_ms_median=float(np.median(hist.seconds)) * 1e3,
            memory_allocated_before=held, max_memory_allocated=peak,
            launches=launches,
            trace_kernels=trace.get("kernels", trace.get("device_time")))
        if launches != want or hist.rounds_to(args.eps) != p_.rounds_to_eps:
            raise SystemExit(f"chip_smoke: at H = {p_.H} K1 and the "
                             f"{SWEEP_EXCHANGE} kernels must launch once a "
                             f"round ({n_rounds}), no other kernel, and the "
                             f"rounds to eps must be the sweep's "
                             f"({p_.rounds_to_eps}); got {launches} and "
                             f"{hist.rounds_to(args.eps)}")
        del trH
        free(torch)

    # H* under each profile and three time models on the stand-in link
    t0 = time.perf_counter()
    link = synthetic_link(*STAND_IN_LINK)
    best = {}
    for name_, prof in PROFILES.items():
        for label, seg in MODELS.items():
            tm = TimeModel(prof, sweep.comm_bytes_per_round, link,
                           exchange=sweep.exchange + seg,
                           workers=sweep.workers)
            h_star, t_star = optimal_H(tm, sweep)
            best.setdefault(name_, {})[label] = dict(
                H_star=h_star, time_to_eps_s=t_star,
                compute_fraction=compute_fraction_at(tm, sweep, h_star))
    phase_done(torch, "tradeoff_models", t0, link=link_fields(link),
               link_label="synthetic_link(1e9, 1e-4), the reference's "
                          "single-device stand-in; model only, no run",
               comm_bytes_per_round=sweep.comm_bytes_per_round,
               optimal=best)

    # autotune_H on live, cached rounds-to-eps and the sweep's fit of
    # t_solver(H), each cost within 2x of the grid's best
    t0 = time.perf_counter()
    live = {}

    def rounds_to_eps(H):
        if H not in live:
            h_ = tr9.with_H(H).run(SWEEP_MAX_ROUNDS, target_eps=args.eps)
            live[H] = (h_.rounds_to(args.eps), len(h_.rounds))
        return live[H][0]

    for fn in counters:
        fn.launches = 0
    tuned, tune_ok = {}, True
    for name_ in TUNED:
        tm = TimeModel(PROFILES[name_], sweep.comm_bytes_per_round, link,
                       exchange=sweep.exchange, workers=sweep.workers)

        def round_time(H, tm=tm):
            return tm.round_time(slope * H + intercept, sweep.t_ref_s)

        h_star = autotune_H(rounds_to_eps, round_time, SWEEP_GRID[0],
                            SWEEP_GRID[-1])
        grid = {p_.H: (p_.rounds_to_eps or float("inf")) * round_time(p_.H)
                for p_ in sweep.points}
        h_grid = min(grid, key=grid.get)
        cost = (rounds_to_eps(h_star) or float("inf")) * round_time(h_star)
        tune_ok &= cost <= 2.0 * grid[h_grid]
        tuned[name_] = dict(H_star=h_star, cost_s=cost, grid_best_H=h_grid,
                            grid_best_cost_s=grid[h_grid],
                            ratio=cost / grid[h_grid])
    torch.cuda.synchronize()
    tune_launches = {fn.__name__: fn.launches for fn in counters}
    want = {fn.__name__: 0 for fn in counters}
    want.update({k_: sum(n for _, n in live.values())
                 for k_ in ("scd_solve",) + codec9})
    phase_done(torch, "tradeoff_autotune", t0, tuned=tuned,
               evaluated={str(H): r for H, (r, _) in sorted(live.items())},
               launches=tune_launches)
    if not tune_ok or tune_launches != want:
        raise SystemExit("chip_smoke: an autotuned H costs over twice the "
                         "grid's best, or its runs launched other kernels "
                         "than K1 and the int8 kernels once a round (see "
                         "the tradeoff_autotune line)")
    del tr9
    free(torch)

    # a small sweep on the card (kernels) and on the CPU (plain versions)
    # on one replayed stream per H: rounds-to-eps, and each point's
    # per-round primal at rtol 1e-4
    t0 = time.perf_counter()
    cfg_s = CoCoAConfig(K=4, H=64, lam=1.0, solver="scd_kernel",
                        exchange=SWEEP_EXCHANGE, seed=args.seed)
    probe = CoCoATrainer(cfg_s, As, bs, device="cpu")
    streams = {H_: [probe.with_H(H_).index_source(t).numpy()
                    for t in range(1, SMALL_SWEEP_ROUNDS + 1)]
               for H_ in SMALL_SWEEP_GRID}
    small_r2e, small_primal = {}, {}
    for where in ("cuda", "cpu"):
        def replay(H_, where=where):
            return ReplayIndices(streams[H_], device=where)

        sw = sweep_H(As, bs, cfg_s, SMALL_SWEEP_GRID, eps=args.eps,
                     max_rounds=SMALL_SWEEP_ROUNDS, measure=False,
                     device=where, index_source_for=replay)
        small_r2e[where] = [p_.rounds_to_eps for p_ in sw.points]
        small_primal[where] = {H_: make_trainer(
            "cocoa", dataclasses.replace(cfg_s, H=H_), As, bs, device=where,
            index_source=replay(H_)).run(SMALL_SWEEP_ROUNDS,
                                         target_eps=args.eps).primal
            for H_ in SMALL_SWEEP_GRID}
    small_rel = {str(H_): float(np.max(
        np.abs(np.array(small_primal["cuda"][H_]) - small_primal["cpu"][H_])
        / np.abs(small_primal["cpu"][H_]))) if len(
            small_primal["cuda"][H_]) == len(small_primal["cpu"][H_])
        else "rounds differ" for H_ in SMALL_SWEEP_GRID}
    phase_done(torch, "tradeoff_card_vs_cpu", t0, grid=SMALL_SWEEP_GRID,
               rounds_to_eps=small_r2e, primal_rel_max=small_rel,
               tolerance="rtol 1e-4",
               tradeoff_seconds=time.perf_counter() - t9,
               setup_seconds=setup9_s)
    if small_r2e["cuda"] != small_r2e["cpu"] or not all(
            isinstance(r, float) and r <= 1e-4 for r in small_rel.values()):
        raise SystemExit("chip_smoke: the small sweep's card and CPU runs "
                         "disagree (see the tradeoff_card_vs_cpu line)")

    # -- 10. the transformer local-updates path: tinyllama on K shards --
    t10 = time.perf_counter()
    lm_entries = transformer_phase(torch, counters)
    lm_card_vs_cpu_phase(torch)
    emit(phase="transformer", seconds=time.perf_counter() - t10,
         paths=[f"{arch} {codec}" for arch, _, codec, _ in LM_ROWS])

    # -- 11. serving: greedy generation at full width -----------------
    t11 = time.perf_counter()
    free(torch)
    serve_phase(torch, counters)
    emit(phase="serve", seconds=time.perf_counter() - t11,
         paths=[arch for arch, *_ in SERVE_PATHS])

    # 14d's dry-run runs in a child on the host from here on, while the
    # card works through phases 12 to 14c (stopped at exit, whatever
    # happens before)
    dry_work = os.path.join(ROOT, "build", "chip_smoke_dry")
    shutil.rmtree(dry_work, ignore_errors=True)
    os.makedirs(dry_work)
    dry = start_mesh_dry(dry_work)

    # -- 12. local-update rounds across ranks: 1-rank NCCL, gloo ranks --
    t12 = time.perf_counter()
    work = os.path.join(ROOT, "build", "chip_smoke_lu")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    try:
        lu_nccl = lu_nccl_phase(torch, counters, work)
        lu_gloo = lu_gloo_phase(torch, counters, work)
        emit(phase="local_updates_dist", seconds=time.perf_counter() - t12)

        # -- 13. the analysis sweep over the recorded logs --------------
        t13 = time.perf_counter()
        analysis_phase(torch, work)
        emit(phase="analysis_sweep", seconds=time.perf_counter() - t13)

        # -- 14. the partitioned paths: meshes, DTensors, the dry-run ---
        mesh_l = mesh_phase(torch, counters, work, dry,
                            lu_nccl.get("int8", {}).get("hashes"))
    finally:
        stop_process(dry[0])
        shutil.rmtree(work, ignore_errors=True)
        shutil.rmtree(dry_work, ignore_errors=True)

    # -- 15. the bench harness: K1, K2 and K3 (int8) and K4 as specs -----
    tr = CoCoATrainer(cfg, A, b)
    alpha0, w0 = tr.init_state()
    idx1 = tr.index_source(1)
    dv15, _ = scd_solve(tr.A_T, tr.col_sq, alpha0, w0, idx1, **kw)
    p15, s15 = enc["int8"](dv15)
    calls = {"scd_solve": (lambda: scd_solve(
        tr.A_T, tr.col_sq, alpha0, w0, idx1, **kw), args.reps),
        "int8": (lambda: enc["int8"](dv15), 4 * args.reps),
        "decode_int8": (lambda: dec["int8"](p15, s15, m, mean=False),
                        4 * args.reps),
        "topk": (lambda: topk_select(dv15, k_main), 4 * args.reps)}
    bench_phase(torch, calls, kernel_bounds(idx1, n_pad, m, k_main)[0],
                dev_ms, card)
    del tr, calls, dv15, p15, s15
    free(torch)

    src = "src/repro_torch/kernels/csrc/"
    # the paths that launch each codec's kernels: CoCoA's, then the
    # baselines' (which never launch K1)
    uses = {c: [ex for ex, c_ in PATHS if c_ == c] for c in CODECS + ("topk",)}
    uses["int8"].append("minibatch_scd compressed:int8")
    for name, ex, _, _, _, c in SGD_PATHS:
        uses[c].append(f"{name} {ex}")
    rows = [("scd_solve", "scd_solve", src + "scd.cu",
             "src/repro/kernels/scd.py:137", [ex for ex, _ in PATHS])]
    for c, q_line, d_line in zip(CODECS, (90, 110, 130), (123, 144, 165)):
        rows.append((c, f"quantize_pack_{c}", src + "quant.cu",
                     f"src/repro/kernels/quant.py:{q_line}", uses[c]))
        rows.append((f"decode_{c}", f"decode_reduce_{c}", src + "dequant.cu",
                     f"src/repro/kernels/dequant.py:{d_line}", uses[c]))
    rows.append(("topk", "topk_select", src + "topk.cu",
                 "src/repro/kernels/topk.py:83", uses["topk"]))
    # the batched products replace no pallas_call: the reference's XLA
    # dots of SGD's partial gradient (and of mini-batch SCD's solve,
    # src/repro/core/solvers.py:97)
    bmv_uses = ["minibatch_scd compressed:int8"] + [
        f"{name} {ex}" for name, ex, *_ in SGD_PATHS]
    rows.append(("matvec", "batched_matvec", src + "bmv.cu",
                 "src/repro/core/baselines.py:112", bmv_uses))
    rows.append(("vecmat", "batched_vecmat", src + "bmv.cu",
                 "src/repro/core/baselines.py:113", bmv_uses))
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
    by_key = dict(zip([r[0] for r in rows], kernels))
    by_key["topk"].update(k=k_main, k_eq_L=dict(
        k=L, ms=ms["topk_k_eq_L"], device_ms=dev_ms["topk_k_eq_L"],
        bound_ms=bounds["topk_k_eq_L"][0]))
    for key in ("matvec", "vecmat"):
        by_key[key].update(shape=bmv_row[key]["shape"],
                           per_worker_loop_ms=bmv_row[key][
                               "per_worker_loop_ms"],
                           sgd_blocks=bmv_row[f"{key}_sgd"])
    for entry, key in zip(kernels, [r[0] for r in rows]):
        entry["long_row"] = long_row.get(key, "not on the long-row path")
        if key in sgd_row:
            entry["sgd_stack"] = sgd_row[key]
        # phase 8: launches per rank per round over the gloo paths that
        # launch it, and rank 0's device time at the sharded shape
        name = entry["name"]
        n_l = sum(p_["launches_rank0"][name] for p_ in gloo_paths)
        n_r = sum(p_["rounds"] for p_ in gloo_paths
                  if p_["launches_rank0"][name])
        entry["sharded"] = (dict(launches_per_rank_per_round=n_l / n_r,
                                 **ranks[0]["kernels"][name])
                            if n_l else "not on the sharded paths")
        # phase 9: launches over the sweep_H call at the main shape
        entry["tradeoff_launches"] = sweep_launches[name]
        # phase 10: launches over the local-updates paths that run it, and
        # its times at the largest leaf of that path's model
        entry["transformer"] = lm_entries.get(
            name, "not on the transformer paths")
        # phase 12: launches by path (12a on the NCCL rank, 12b on gloo
        # rank 0) and 12a's times at the largest leaf, one (1, L) row
        dist_l = {f"nccl {c_}": v["launches"][name]
                  for c_, v in lu_nccl.items() if v["launches"][name]}
        dist_l.update({f"gloo rank 0 {c_}": v["launches"].get(name, 0)
                       for c_, v in lu_gloo.items()
                       if v["launches"].get(name, 0)})
        tkey = {"topk_select": "topk"}.get(name, name.replace(
            "quantize_pack_", "").replace("decode_reduce_", "decode_"))
        timed = {c_: v["timing"][tkey] for c_, v in lu_nccl.items()
                 if tkey in v["timing"]}
        entry["local_updates_dist"] = (
            dict(launches=dist_l, at_largest_leaf=timed) if dist_l
            else "not on the local-update paths")
        # phase 14a: launches in the local-updates round on the (1, 1)
        # mesh (lower_train_local_updates, int8)
        entry["mesh"] = (dict(launches=mesh_l[name]) if mesh_l.get(name)
                         else "not on the partitioned paths")
    by_key["scd_solve"]["tradeoff_device_ms_by_H"] = {
        str(H_): t for H_, t in k1_by_H.items()}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
