"""The port's multi-process entry (``python -m repro_torch.launch.dist``):
a 2-process gloo run on the CPU gives the same per-round primals and the
same SHA-256 of the final shared and local state as the virtual driver
at K = 2 in this process — a sum of two addends is exact in either
order — for the fused ``xla`` fabric and the explicit ``ring``; with
``--calibrate`` each rank also writes its link fit. The counterpart of
``tests/test_dist_launch.py``."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from repro_torch.core import CoCoAConfig, CoCoATrainer
from repro_torch.data import make_glm_data
from repro_torch.launch.dist import sha256

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, N, H, ROUNDS = 64, 128, 8, 3


def _launch(spec: str, tmp_path, *extra: str) -> list:
    init = tmp_path / "init"
    outs = [tmp_path / f"p{pid}.json" for pid in (0, 1)]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dist",
         "--coordinator", f"file://{init}", "--num-processes", "2",
         "--process-id", str(pid), "--algorithm", "cocoa",
         "--exchange", spec, "--rounds", str(ROUNDS), "--H", str(H),
         "--m", str(M), "--n", str(N), "--device", "cpu",
         "--out", str(outs[pid]), *extra], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for pid in (0, 1)]
    try:
        for p in procs:
            out, err = p.communicate(timeout=120)
            assert p.returncode == 0, out + "\n" + err
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return [json.loads(o.read_text()) for o in outs]


@pytest.mark.parametrize("spec", ["persistent", "compressed:int8/ring"])
def test_two_processes_match_the_virtual_driver(spec, tmp_path):
    p0, p1 = _launch(spec, tmp_path)
    A, b, _ = make_glm_data(m=M, n=N, density=0.2, zipf_a=1.1, seed=42)
    tr = CoCoATrainer(CoCoAConfig(K=2, H=H, lam=1.0, solver="scd_ref",
                                  exchange=spec, seed=0), A, b, device="cpu")
    hist = tr.run(ROUNDS)
    assert p0["workers"] == p1["workers"] == 2
    assert p0["num_processes"] == 2 and p0["exchange"] == spec
    for key in ("primals", "final_shared_sha256", "final_local_sha256",
                "bytes_recorded"):
        assert p0[key] == p1[key], key
    assert p0["primals"] == hist.primal
    assert p0["final_shared_sha256"] == sha256(tr.w_final)
    assert p0["final_local_sha256"] == sha256(tr.alpha)
    assert p0["bytes_recorded"] == [tr.comm_bytes_per_round()] * ROUNDS


def test_calibrate_writes_each_ranks_link_fit(tmp_path):
    """``--calibrate`` adds this rank's fit of the exchange's collective
    over the group (``calibrate_link``) as ``link``; the rest of the JSON
    is the same on both ranks."""
    p0, p1 = _launch("compressed:int8", tmp_path, "--calibrate")
    for p in (p0, p1):
        link = p.pop("link")
        assert link["source"] == "measured"
        assert 0 < link["bandwidth_Bps"] < float("inf")
        assert link["latency_s"] >= 0
    assert p0 == p1
