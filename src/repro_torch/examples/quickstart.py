"""Quickstart: the paper's workload end to end, on the card (or, with
``--device cpu``, the plain PyTorch versions on the host).

Trains elastic-net ridge regression with CoCoA (kernel K1 as the local
solver on the card), compares the communication schemes, shows the H
trade-off under two framework-overhead profiles, walks the three
algorithms x the exchange schemes, flips the staleness knob
(``exchange="stale"``), and runs the straggler / elastic membership
regimes and the collective-backend axis through the same one-string
``ExchangeConfig`` spec.

CoCoA's local solver is K1 (``solver="scd_kernel"``; its plain version
on the CPU) throughout, also where the reference's example takes
``scd_ref``: on the card the plain version is a loop of small launches a
step.

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.bench.timing import synthetic_link
from repro_torch.core import (COMM_TRANSPORTS, PROFILES, CoCoAConfig,
                              CoCoATrainer, MinibatchSCD, MinibatchSGD,
                              SGDConfig)
from repro_torch.core.glm import ridge_exact
from repro_torch.core.tradeoff import HSweep, HSweepPoint, TimeModel, optimal_H
from repro_torch.data import make_glm_data

SOLVER = "scd_kernel"      # K1 on the card, its plain version on the CPU


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    dev = ap.parse_args(argv).device

    # 1. synthetic webspam-like data, column-partitioned over 8 workers
    A, b, _ = make_glm_data(m=384, n=1024, density=0.15, seed=0)
    print(f"data: A {A.shape}, 8 workers, lam=1.0 (ridge)")

    # 2. CoCoA with kernel K1 as the local solver
    cfg = CoCoAConfig(K=8, H=256, lam=1.0, eta=1.0, solver=SOLVER)
    tr = CoCoATrainer(cfg, A, b, device=dev)
    hist = tr.run(rounds=100, record_every=10, target_eps=1e-3)
    print("suboptimality trace:", [f"{s:.1e}" for s in hist.subopt])

    # 3. verify against the closed-form ridge solution
    alpha_star = ridge_exact(tr.A, tr.b, 1.0).cpu().numpy()
    rel = (np.linalg.norm(tr.alpha_final - alpha_star)
           / np.linalg.norm(alpha_star))
    print(f"||alpha - alpha*|| / ||alpha*|| = {rel:.2e}")

    # 4. the paper's point: optimal H depends on the framework's overhead
    sweep = HSweep(eps=1e-3, n_local=128, t_ref_s=0.05)
    for H in (8, 32, 128, 512, 2048):
        c = CoCoAConfig(K=8, H=H, solver=SOLVER)
        h = CoCoATrainer(c, A, b, device=dev).run(800, record_every=1,
                                                  target_eps=1e-3)
        sweep.points.append(HSweepPoint(H, h.rounds_to(1e-3), H * 4e-4))
    for name in ("E_mpi", "B_spark_c", "D_pyspark_c"):
        h_opt, t_opt = optimal_H(PROFILES[name], sweep)
        print(f"{name:14s} optimal H = {h_opt:5d}  "
              f"time-to-1e-3 = {t_opt:7.2f}s")
    print("=> higher framework overhead pushes the optimum toward more "
          "local computation — the paper's central result.")

    # 5. all three algorithms (§5.4) under the exchange schemes plus the
    #    packed-int4 codec, each round's traffic sized to what the
    #    collectives move. CoCoA all-reduces an m-vector, mini-batch SGD
    #    an n-vector: more bytes whenever n > m.
    print(f"\n{'algorithm':14s} {'scheme':15s} {'eps':>5s} {'rounds':>7s} "
          f"{'bytes/round':>12s}")
    for algo in ("cocoa", "minibatch_scd", "minibatch_sgd"):
        for scheme in COMM_TRANSPORTS + ("compressed:int4",):
            # int4's coarser grid plateaus above 1e-2 here, so it runs at
            # a coarse eps
            eps = 1e-1 if scheme.endswith("int4") else 1e-2
            if algo == "minibatch_sgd":
                tr = MinibatchSGD(SGDConfig(step_size=0.1, K=8, lam=1.0,
                                            exchange=scheme), A, b,
                                  device=dev)
                h = tr.run_workers(300, record_every=1, target_eps=eps)
            else:
                cls = MinibatchSCD if algo == "minibatch_scd" else CoCoATrainer
                tr = cls(CoCoAConfig(K=8, H=128, exchange=scheme,
                                     solver=SOLVER), A, b, device=dev)
                h = tr.run(300, record_every=1, target_eps=eps)
            print(f"{algo:14s} {scheme:15s} {eps:>5g} "
                  f"{str(h.rounds_to(eps)):>7s} "
                  f"{tr.comm_bytes_per_round():>12d}")
    print("=> same math per algorithm under every scheme; `compressed` "
          "(int8) moves ~4x fewer bytes, `compressed:int4` ~8x, "
          "`spark_faithful` pays for shipping alpha.")

    # 6. the staleness knob: `stale` applies each aggregate one round
    #    late (`stale:k=2`: two) — same wire bytes, a convergence tax,
    #    and an exchange that can hide behind the next rounds' compute
    for mode in ("sync", "stale", "stale:k=2"):
        tr = CoCoATrainer(CoCoAConfig(K=8, H=128, exchange=mode,
                                      solver=SOLVER), A, b, device=dev)
        h = tr.run(300, record_every=1, target_eps=1e-2)
        print(f"cocoa/{mode:9s}: rounds->1e-2 = {h.rounds_to(1e-2)}, "
              f"bytes/round = {tr.comm_bytes_per_round()}")
    print("=> same wire bytes either way, but stale rounds never wait on "
          "the wire — the paper's scheduling-delay regime as a knob.")

    # 7. stragglers and elastic membership in the same spec: a straggler
    #    profile never changes the math (the barrier makes it a
    #    wall-clock effect the TimeModel charges as E[max over K]); a
    #    `drop:w@d-r` event removes worker w's updates for rounds d..r
    base = CoCoATrainer(CoCoAConfig(K=8, H=128, solver=SOLVER), A, b,
                        device=dev)
    slow = CoCoATrainer(CoCoAConfig(
        K=8, H=128, exchange="persistent/straggler:mix(p=0.25,slow=8)",
        solver=SOLVER), A, b, device=dev)
    h_base = base.run(300, record_every=1, target_eps=1e-2)
    h_slow = slow.run(300, record_every=1, target_eps=1e-2)
    assert h_base.rounds_to(1e-2) == h_slow.rounds_to(1e-2)  # time-only
    link = synthetic_link(1e9, 1e-4)
    for tr, tag in ((base, "no stragglers"), (slow, "mix(p=0.25,slow=8)")):
        tm = TimeModel(PROFILES["E_mpi"], tr.comm_bytes_per_round(), link,
                       exchange=tr.exchange, workers=8)
        print(f"cocoa {tag:20s}: barrier x{tm.barrier_mult:5.2f}, "
              f"round_time(50ms solver) = "
              f"{tm.round_time(0.05, 0.05) * 1e3:6.1f} ms")
    el = CoCoATrainer(CoCoAConfig(K=8, H=128, solver=SOLVER,
                                  exchange="persistent/drop:3@2-4"), A, b,
                      device=dev)
    h = el.run(300, record_every=1, target_eps=1e-2)
    print(f"cocoa elastic drop:3@2-4: rounds->1e-2 = {h.rounds_to(1e-2)}, "
          f"bytes full = {el.comm_bytes_per_round()}, "
          f"at t=2 (7/8 live) = {el.comm_bytes_per_round(t=2)}")
    print("=> one grammar for the whole exchange: transport:codec / "
          "backend / stale:k / straggler:kind(...) / drop:w@d-r")

    # 8. the collective-backend axis: the same exchange on another
    #    fabric. `ring` (explicit neighbour hops on the sharded driver,
    #    python -m repro_torch.launch.dist) pays the link latency per
    #    hop, 2(K-1) times for the sum transports
    for spec in ("persistent", "persistent/ring", "compressed:int4/ring"):
        tr = CoCoATrainer(CoCoAConfig(K=8, H=128, exchange=spec,
                                      solver=SOLVER), A, b, device=dev)
        tm = TimeModel(PROFILES["E_mpi"], tr.comm_bytes_per_round(), link,
                       exchange=tr.exchange, workers=8)
        print(f"cocoa {spec:20s}: bytes/round = "
              f"{tr.comm_bytes_per_round():6d}, "
              f"comm = {tm.comm_time_s() * 1e3:6.2f} ms")
    print("=> same update, different fabric: the backend segment swaps "
          "the collective without touching the algorithm.")


if __name__ == "__main__":
    main()
