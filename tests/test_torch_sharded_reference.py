"""The port's sharded driver against the reference's, round for round:
a subprocess runs ``repro``'s ``run_sharded`` over 4 faked host devices
(as ``tests/test_distributed.py`` does) and a 4-rank gloo group runs the
port's ``run_sharded`` on the reference's own index stream
(``carry.ReplayIndices``), recomputed here by the reference's key
splits. CoCoA under ``persistent``, ``compressed:int8/ring`` and
``compressed:ef:int4/stale:k=2/drop:1@2-3``, and mini-batch SGD (H = 1)
under ``compressed:int8``, at the drivers benchmark's smoke shape (m=96,
n=256, K=4, density 0.2). The per-round primal agrees at the tolerances
``tests/test_torch_cocoa.py`` holds the virtual driver to: rtol 1e-5
under ``persistent``, 1e-4 under the quantizing exchanges (another sum
order can move a code at a rounding edge)."""
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.core import CoCoAConfig as RefConfig
from repro.core import CoCoATrainer as RefTrainer
from repro.core import MinibatchSGD as RefSGD
from repro.core import SGDConfig as RefSGDConfig
from repro.data.synthetic import make_glm_data
from repro_torch import carry
from repro_torch.core import (CoCoAConfig, CoCoATrainer, MinibatchSGD,
                              SGDConfig)
from repro_torch.launch.dist import spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
M, N, K, DENSITY, ROUNDS = 96, 256, 4, 0.2, 8
H, SEED = N // K, 1
COCOA = {"persistent": 1e-5, "compressed:int8/ring": 1e-4,
         "compressed:ef:int4/stale:k=2/drop:1@2-3": 1e-4}
SGD_EX, SGD_KW = "compressed:int8", dict(batch_frac=0.5, step_size=0.1, K=K,
                                          seed=0)

REFERENCE = f"""
import json
from repro.core import CoCoAConfig, CoCoATrainer, MinibatchSGD, SGDConfig
from repro.data.synthetic import make_glm_data
A, b, _ = make_glm_data(m={M}, n={N}, density={DENSITY}, zipf_a=1.1,
                        seed=42)
out = {{}}
for ex in {list(COCOA)!r}:
    tr = CoCoATrainer(CoCoAConfig(K={K}, H={H}, lam=1.0, solver="scd_ref",
                                  exchange=ex, seed={SEED}), A, b)
    out[ex] = tr.run_sharded({ROUNDS}).primal
tr = MinibatchSGD(SGDConfig(exchange={SGD_EX!r}, **{SGD_KW!r}), A, b)
out["sgd"] = tr.run_sharded({ROUNDS}, record_every=1).primal
print(json.dumps(out))
"""


def _data():
    A, b, _ = make_glm_data(m=M, n=N, density=DENSITY, zipf_a=1.1, seed=42)
    return A, b


def categorical_stream(mask, seed: int):
    """CoCoA's per-round (K, H) coordinates, as the reference draws them
    in both of its drivers."""
    key = jax.random.key(seed)
    stream = []
    for _ in range(ROUNDS):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, mask.shape[0])
        stream.append(np.stack([
            np.asarray(jax.random.categorical(
                keys[k], jnp.where(mask[k] > 0, 0.0, -jnp.inf), shape=(H,)))
            for k in range(mask.shape[0])]).astype(np.int32))
    return stream


def row_stream(m_local: int, batch: int, seed: int):
    """SGD's per-round (K, 1, batch_local) rows."""
    key = jax.random.key(seed)
    stream = []
    for _ in range(ROUNDS):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, K)
        stream.append(np.stack([np.asarray(jax.random.choice(
            keys[k], m_local, shape=(batch,), replace=False))[None]
            for k in range(K)]).astype(np.int32))
    return stream


def _rank_runs(rank, world, device, cocoa_stream, sgd_stream):
    A, b = _data()
    out = {}
    for ex in COCOA:
        tr = CoCoATrainer(CoCoAConfig(K=K, H=H, lam=1.0, solver="scd_ref",
                                      exchange=ex, seed=SEED), A, b,
                          device=device, index_source=carry.ReplayIndices(
                              cocoa_stream, device=device))
        out[ex] = tr.run_sharded(ROUNDS).primal
    tr = MinibatchSGD(SGDConfig(exchange=SGD_EX, **SGD_KW), A, b,
                      device=device, row_source=carry.ReplayIndices(
                          sgd_stream, device=device))
    out["sgd"] = tr.run_sharded(ROUNDS, record_every=1).primal
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    A, b = _data()
    ref_tr = RefTrainer(RefConfig(K=K, H=H, lam=1.0, exchange="persistent",
                                  seed=SEED), A, b)
    ref_sgd = RefSGD(RefSGDConfig(exchange=SGD_EX, **SGD_KW), A, b)
    streams = (categorical_stream(np.asarray(ref_tr.mask), SEED),
               row_stream(ref_sgd.m_local, ref_sgd.batch_local, 0))
    env = dict(os.environ,
               XLA_FLAGS=f"--xla_force_host_platform_device_count={K}",
               PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen([sys.executable, "-c", REFERENCE], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        init = tmp_path_factory.mktemp("sharded_ref") / "init"
        ours = spawn(K, _rank_runs, device="cpu", init_file=str(init),
                     args=streams, timeout_s=180)
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, out + "\n" + err
    return json.loads(out.strip().splitlines()[-1]), ours


@pytest.mark.parametrize("ex", list(COCOA))
def test_cocoa_run_sharded_follows_the_reference(runs, ex):
    ref, ours = runs
    assert len(ref[ex]) == ROUNDS
    for r in range(K):
        np.testing.assert_allclose(ours[r][ex], ref[ex], rtol=COCOA[ex])


def test_sgd_run_sharded_follows_the_reference(runs):
    ref, ours = runs
    assert len(ref["sgd"]) == ROUNDS
    for r in range(K):
        np.testing.assert_allclose(ours[r]["sgd"], ref["sgd"], rtol=1e-4)
