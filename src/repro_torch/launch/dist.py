"""Real multi-process execution of the sharded driver (the port of
``repro.launch.dist``).

Every process runs this same script with the same arguments except
``--process-id``; ``torch.distributed.init_process_group`` joins them
into one group of ``--num-processes`` ranks, one worker per rank, and
the unchanged sharded driver (``CoCoATrainer.run_sharded``,
``MinibatchSGD.run_sharded``) runs across them::

    # terminal 1                                  # terminal 2
    PYTHONPATH=src python -m repro_torch.launch.dist \\    ... same ... \\
        --coordinator 127.0.0.1:9876 \\
        --num-processes 2 --process-id 0 \\        --process-id 1 \\
        --algorithm cocoa --exchange compressed:int8/ring \\
        --device cpu --rounds 5 --out /tmp/r0.json    --out /tmp/r1.json

``--coordinator`` is ``host:port`` (rank 0 binds it) or an init-method
URL (``file:///path/to/a/new/file``). ``--backend gloo`` (the default)
runs anywhere, staging device tensors through the host; ``nccl`` needs
one card per rank. ``--device`` defaults to the card (rank ``r`` on card
``r mod count``); ``--device cpu`` runs the plain PyTorch versions.

The problem is rebuilt from ``--seed`` on every process and each rank
places only its own worker's block on its device. The result JSON holds
the per-round primal objectives, SHA-256 hashes of the final shared and
(gathered) local state, which is how runs are compared bit for bit, and
the bytes each round moved, derived from the recorded collective log
(``repro_torch.analysis.traffic``). With ``--calibrate`` it also holds
``link``, this rank's fit of the exchange's collective over the group
(``repro_torch.bench.timing.calibrate_link``), which differs by rank.

:func:`spawn` starts a whole group from one process (the tests and
``chip_smoke.py`` use it).
"""
from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import multiprocessing
import os
import pickle
import sys
import time
import traceback
from typing import Callable

import numpy as np
import torch
import torch.distributed as tdist

from repro_torch.utils.device import resolve_device

DEFAULT_TIMEOUT_S = 300.0


def init_group(backend: str, init_method: str, world: int, rank: int,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the default process group; a collective that waits longer
    than ``timeout_s`` raises instead of hanging."""
    tdist.init_process_group(backend, init_method=init_method,
                             world_size=world, rank=rank,
                             timeout=datetime.timedelta(seconds=timeout_s))


def rank_device(device, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cuda`` (the default) is card ``rank mod
    count``, so ranks share the cards there are."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


def sha256(a) -> str:
    """SHA-256 of an array's f32 bytes (a tensor goes to the host)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


# ---------------------------------------------------------------------------
# spawn: a whole group from one process
# ---------------------------------------------------------------------------
def _spawned_rank(job_path, rank, world, backend, device, init_file,
                  timeout_s, out_path) -> None:
    torch.set_num_threads(1)
    try:
        with open(job_path, "rb") as f:
            fn, args = pickle.load(f)
        dev = rank_device(device, rank)
        init_group(backend, f"file://{init_file}", world, rank, timeout_s)
        try:
            payload = ("ok", fn(rank, world, dev, *args))
        finally:
            tdist.destroy_process_group()
    except Exception:            # the process's boundary: report and exit
        payload = ("error", traceback.format_exc())
    with open(out_path, "wb") as f:
        pickle.dump(payload, f)
    sys.exit(0 if payload[0] == "ok" else 1)


def spawn(world: int, fn: Callable, *, backend: str = "gloo", device=None,
          init_file: str, args: tuple = (),
          timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(rank, world, device, *args)`` in ``world`` fresh processes
    joined into one process group (``init_method=file://init_file``, a
    path that does not exist yet, so that concurrent groups never share a
    port), each with one CPU thread; returns the results by rank.

    ``fn`` and its results travel by pickle (``fn`` by import path). A
    rank that raises, or a group that has not finished after
    ``timeout_s``, stops every rank and raises here; each collective
    also times out after ``timeout_s``."""
    ctx = multiprocessing.get_context("spawn")
    # fn and args go to the ranks through a file, not each process's
    # start pipe: a pickle past the pipe's buffer holds the start of the
    # next rank until this one has imported torch, one rank at a time
    job = f"{init_file}.job"
    with open(job, "wb") as f:
        pickle.dump((fn, args), f)
    outs = [f"{init_file}.rank{r}" for r in range(world)]
    procs = [ctx.Process(target=_spawned_rank, args=(
        job, r, world, backend, device, init_file, timeout_s, outs[r]))
        for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.is_alive() for p in procs):
            failed = [r for r, p in enumerate(procs)
                      if p.exitcode not in (None, 0)]
            if failed:
                raise RuntimeError(f"rank {failed[0]} of {world} failed:\n"
                                   + _read(outs[failed[0]], "error"))
            if time.monotonic() > deadline:
                raise TimeoutError(f"the {world}-rank group did not finish "
                                   f"in {timeout_s} s")
            time.sleep(0.05)
        for r, p in enumerate(procs):
            if p.exitcode != 0:
                raise RuntimeError(f"rank {r} of {world} failed:\n"
                                   + _read(outs[r], "error"))
        return [_read(o, "ok") for o in outs]
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()


def _read(path: str, want: str):
    """A rank's result file (written by :func:`_spawned_rank`)."""
    if not os.path.exists(path):
        return f"(no result from {path})" if want == "error" else None
    with open(path, "rb") as f:
        kind, value = pickle.load(f)
    if want == "ok" and kind != "ok":
        raise RuntimeError(value)
    return value


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------
def build_trainer(args, device):
    from repro_torch.core import (CoCoAConfig, CoCoATrainer, MinibatchSCD,
                                  MinibatchSGD, SGDConfig)
    from repro_torch.data import make_glm_data

    trainers = {"cocoa": CoCoATrainer, "minibatch_scd": MinibatchSCD,
                "minibatch_sgd": MinibatchSGD}
    A, b, _ = make_glm_data(m=args.m, n=args.n, density=args.density,
                            zipf_a=1.1, seed=args.seed)
    if args.algorithm == "minibatch_sgd":
        cfg = SGDConfig(K=args.workers, H=args.H, lam=args.lam,
                        step_size=0.1, exchange=args.exchange, seed=0)
    else:
        cfg = CoCoAConfig(K=args.workers, H=args.H, lam=args.lam,
                          solver=args.solver, exchange=args.exchange, seed=0)
    return trainers[args.algorithm](cfg, A, b, device=device)


def run(args, device) -> dict:
    """This rank's part of the run, in an initialized default group."""
    from repro_torch.analysis.traffic import derived_round_traffic
    from repro_torch.comm.collectives import recording

    K = tdist.get_world_size()
    args.workers = K
    tr = build_trainer(args, device)
    with recording() as log:
        hist = tr.run_sharded(args.rounds, record_every=1)
    if args.algorithm == "minibatch_sgd":
        shared, local = tr.alpha_final, np.zeros((K, 0), np.float32)
    else:
        shared, local = tr.w_final, tr.alpha
    result = {
        "workers": K,
        "num_processes": args.num_processes,
        "algorithm": args.algorithm,
        "exchange": tr.exchange.spec,
        "rounds": args.rounds,
        "primals": hist.primal,
        "final_shared_sha256": sha256(shared),
        "final_local_sha256": sha256(local),
        "bytes_recorded": [derived_round_traffic(log.of_round(t),
                                                 tr.exchange, K)
                           for t in log.rounds()],
    }
    if args.calibrate:
        from repro_torch.bench.timing import TimingPolicy, calibrate_link

        # this rank's fit of the exchange's collective over the group
        link = calibrate_link(tr.exchange, policy=TimingPolicy(warmup=1,
                                                               reps=3),
                              device=device)
        result["link"] = {"bandwidth_Bps": link.bandwidth_Bps,
                          "latency_s": link.latency_s,
                          "source": link.source}
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="run the sharded driver across real processes")
    ap.add_argument("--coordinator", default="127.0.0.1:9876",
                    help="host:port (process 0 binds it) or an init-method "
                         "URL (file:///path)")
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--algorithm", default="cocoa",
                    choices=("cocoa", "minibatch_scd", "minibatch_sgd"))
    ap.add_argument("--exchange", default="persistent", metavar="SPEC",
                    help="full exchange spec incl. backend segment "
                         "(e.g. 'compressed:int4/ring')")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--H", type=int, default=16)
    ap.add_argument("--solver", default="scd_ref")
    ap.add_argument("--m", type=int, default=96)
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--density", type=float, default=0.2)
    ap.add_argument("--lam", type=float, default=1.0)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--backend", default="gloo", choices=("gloo", "nccl"),
                    help="the process group's backend (nccl: one card a "
                         "rank)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--calibrate", action="store_true",
                    help="also calibrate the link over the real transport "
                         "(calibrate_link; each rank writes its own fit)")
    ap.add_argument("--out", default=None,
                    help="write the result JSON here (every process "
                         "writes — compare them bit-for-bit)")
    args = ap.parse_args(argv)

    device = rank_device(args.device, args.process_id)
    url = (args.coordinator if "://" in args.coordinator
           else f"tcp://{args.coordinator}")
    init_group(args.backend, url, args.num_processes, args.process_id)
    try:
        result = run(args, device)
    finally:
        tdist.destroy_process_group()
    line = json.dumps(result, indent=2, sort_keys=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
