"""The paper's two baselines on the port's virtual driver against a live
run of the reference, round by round, on the CPU at the drivers
benchmark's smoke shape (m=96, n=256, density 0.2, data seed 42), with
K = 4 and K = 3 (a K whose reciprocal is not exact).

The reference draws with ``jax.random``, which PyTorch cannot
reproduce, so the port replays the reference's own streams, recomputed
here by the reference's key splits:
  * mini-batch SCD: the masked categorical draw of CoCoA's round;
  * mini-batch SGD, ``run_workers``: the round key split per worker and
    ``choice(keys[k], m_local, (batch_local,), replace=False)`` (for
    H > 1 on ``split(keys[k], H)`` first);
  * mini-batch SGD, ``run``: ``choice(sub, m, (batch,), replace=False)``.
The per-round primal agrees at rtol 1e-5 under the exact transports and
1e-4 under the quantizing ones (another sum order can move a code at a
rounding edge). Rounds-to-eps is pinned from the live reference.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CoCoAConfig as RefCoCoAConfig
from repro.core import CoCoATrainer as RefCoCoA
from repro.core import MinibatchSCD as RefSCD
from repro.core import MinibatchSGD as RefSGD
from repro.core import SGDConfig as RefSGDConfig
from repro.data.synthetic import make_glm_data
from repro_torch import carry
from repro_torch.core import (CoCoAConfig, CoCoATrainer, MinibatchSCD,
                              MinibatchSGD, SGDConfig, UniformRows, solvers)

M, N, DENSITY, EPS = 96, 256, 0.2, 1e-3
SEED = 0                     # the trainer seed: every SCD exchange reaches EPS
SCD_ROUNDS, SGD_ROUNDS = 40, 12
TOPK_REGIME = "compressed:ef:topk(r=0.125)/stale:k=2/drop:1@2-4"


@pytest.fixture(scope="module")
def data():
    A, b, _ = make_glm_data(m=M, n=N, density=DENSITY, zipf_a=1.1, seed=42)
    return A, b


def categorical_stream(mask, rounds: int, seed: int, H: int):
    """Mini-batch SCD's per-round (K, H) coordinates, as the reference's
    CoCoA round draws them."""
    key = jax.random.key(seed)
    stream = []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, mask.shape[0])
        stream.append(np.stack([
            np.asarray(jax.random.categorical(
                keys[k], jnp.where(mask[k] > 0, 0.0, -jnp.inf), shape=(H,)))
            for k in range(mask.shape[0])]).astype(np.int32))
    return stream


def worker_row_stream(K: int, H: int, m_local: int, batch: int,
                      rounds: int, seed: int):
    """``run_workers``' per-round (K, H, batch_local) rows."""
    key = jax.random.key(seed)
    stream = []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, K)
        per = []
        for k in range(K):
            subs = [keys[k]] if H == 1 else list(jax.random.split(keys[k], H))
            per.append(np.stack([np.asarray(jax.random.choice(
                kh, m_local, shape=(batch,), replace=False)) for kh in subs]))
        stream.append(np.stack(per).astype(np.int32))
    return stream


def global_row_stream(m: int, batch: int, rounds: int, seed: int):
    """``run``'s per-round (batch,) rows."""
    key = jax.random.key(seed)
    stream = []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        stream.append(np.asarray(jax.random.choice(
            sub, m, shape=(batch,), replace=False)).astype(np.int32))
    return stream


def replay(stream):
    return carry.ReplayIndices(stream, device="cpu")


# -- mini-batch SCD ------------------------------------------------------
@pytest.mark.parametrize("K,ex,rtol,r2e,nbytes", [
    (4, "persistent", 1e-5, 32, 3072),
    (4, "compressed:int8", 1e-4, 28, 800),
    (4, "compressed:ef:int4", 1e-4, 32, 416),
    (4, TOPK_REGIME, 1e-4, 36, 800),
    (3, "persistent", 1e-5, 21, 2304),
    (3, "compressed:int8", 1e-4, 20, 600),
    (3, "compressed:ef:int4", 1e-4, 21, 312),
    (3, TOPK_REGIME, 1e-4, 29, 600)])
def test_minibatch_scd_per_round_primal_matches_live_reference(
        data, K, ex, rtol, r2e, nbytes):
    A, b = data
    H = -(-N // K)
    ref = RefSCD(RefCoCoAConfig(K=K, H=H, lam=1.0, exchange=ex, seed=SEED),
                 A, b)
    ref_hist = ref.run(SCD_ROUNDS, target_eps=EPS)
    stream = categorical_stream(np.asarray(ref.mask), len(ref_hist.rounds),
                                SEED, H)
    tr = MinibatchSCD(CoCoAConfig(K=K, H=H, lam=1.0, exchange=ex, seed=SEED),
                      A, b, device="cpu", index_source=replay(stream))
    hist = tr.run(SCD_ROUNDS, target_eps=EPS)
    assert hist.rounds == ref_hist.rounds
    np.testing.assert_allclose(hist.primal, ref_hist.primal, rtol=rtol)
    assert hist.rounds_to(EPS) == ref_hist.rounds_to(EPS) == r2e
    for t in (None, 1, 2, 3):
        assert tr.comm_bytes_per_round(t) == ref.comm_bytes_per_round(t)
    assert tr.comm_bytes_per_round() == nbytes
    np.testing.assert_allclose(tr.alpha_final, ref.alpha_final,
                               rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("solver", ["scd_ref", "scd_kernel", "scd_fixed"])
def test_minibatch_scd_forces_the_batched_fixed_point_solve(data, solver):
    A, b = data
    tr = MinibatchSCD(CoCoAConfig(K=4, H=8, solver=solver), A, b,
                      device="cpu")
    assert tr.cfg.solver == "scd_fixed"
    assert tr._algo.solver is solvers.scd_steps_fixed_point_batched
    with pytest.raises(RuntimeError, match="repro_torch.launch.dist"):
        tr.run_sharded(2)


# -- mini-batch SGD: the legacy loop -------------------------------------
@pytest.mark.parametrize("batch_frac,eta", [(0.5, 1.0), (0.5, 0.5),
                                            (1.0, 1.0)])
def test_sgd_run_matches_live_reference(data, batch_frac, eta):
    """The legacy loop over global rows; a batch of all m rows is A
    itself, not a gathered copy."""
    A, b = data
    kw = dict(batch_frac=batch_frac, step_size=0.1, lam=1.0, eta=eta, K=4,
              seed=SEED)
    ref = RefSGD(RefSGDConfig(**kw), A, b)
    ref_hist = ref.run(SGD_ROUNDS, record_every=1)
    stream = global_row_stream(M, ref.batch, SGD_ROUNDS, SEED)
    tr = MinibatchSGD(SGDConfig(**kw), A, b, device="cpu",
                      global_row_source=replay(stream))
    hist = tr.run(SGD_ROUNDS, record_every=1)
    np.testing.assert_allclose(tr.p_star, ref.p_star, rtol=1e-5)
    np.testing.assert_allclose(tr.p_zero, ref.p_zero, rtol=1e-6)
    assert hist.rounds == ref_hist.rounds
    np.testing.assert_allclose(hist.primal, ref_hist.primal, rtol=1e-5)
    np.testing.assert_allclose(tr.alpha_final, ref.alpha_final,
                               rtol=1e-4, atol=1e-6)


# -- mini-batch SGD: the virtual driver ----------------------------------
def _sgd_pair(data, K, H, ex, batch_frac, rounds=SGD_ROUNDS):
    A, b = data
    kw = dict(batch_frac=batch_frac, step_size=0.1, lam=1.0, K=K, H=H,
              seed=SEED, exchange=ex)
    ref = RefSGD(RefSGDConfig(**kw), A, b)
    ref_hist = ref.run_workers(rounds, record_every=1)
    stream = worker_row_stream(K, H, ref.m_local, ref.batch_local, rounds,
                               SEED)
    tr = MinibatchSGD(SGDConfig(**kw), A, b, device="cpu",
                      row_source=replay(stream))
    hist = tr.run_workers(rounds, record_every=1, p_star=ref.p_star,
                          p_zero=ref.p_zero)
    return ref, ref_hist, tr, hist


@pytest.mark.parametrize("ex,rtol", [
    ("persistent", 1e-5), ("compressed:int8", 1e-4),
    ("compressed:ef:topk(r=0.125)", 1e-4),
    ("persistent/drop:1@3-5", 1e-5),
    ("compressed:int8/stale:k=2", 1e-4)])
@pytest.mark.parametrize("K,batch_frac", [(4, 1.0), (3, 0.5)])
def test_sgd_h1_per_round_primal_matches_live_reference(data, ex, rtol, K,
                                                         batch_frac):
    """MLlib's H = 1 round; under ``drop:`` the driver's reweight branch
    rescales the mean over the live workers."""
    ref, ref_hist, tr, hist = _sgd_pair(data, K, 1, ex, batch_frac)
    assert hist.rounds == ref_hist.rounds
    np.testing.assert_allclose(hist.primal, ref_hist.primal, rtol=rtol)
    assert np.all(np.isfinite(hist.primal))
    np.testing.assert_allclose(tr.alpha_final, ref.alpha_final,
                               rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("ex,rtol", [("persistent", 1e-5),
                                     ("compressed:ef:int4", 1e-4)])
@pytest.mark.parametrize("K", [4, 3])
def test_sgd_local_h4_per_round_primal_matches_live_reference(data, ex,
                                                              rtol, K):
    """Local SGD: four proximal steps on each worker's copy, the model
    delta averaged by an IEEE quotient by K."""
    ref, ref_hist, tr, hist = _sgd_pair(data, K, 4, ex, 0.5)
    assert hist.rounds == ref_hist.rounds
    np.testing.assert_allclose(hist.primal, ref_hist.primal, rtol=rtol)
    np.testing.assert_allclose(tr.alpha_final, ref.alpha_final,
                               rtol=1e-3, atol=1e-6)


def test_sgd_padded_row_blocks_match_live_reference(data):
    """K = 5 pads the 96 rows to 5 blocks of 20: the padded rows are
    drawn like any other and add nothing."""
    ref, ref_hist, tr, hist = _sgd_pair(data, 5, 2, "compressed:int8", 0.5)
    assert tr.m_local == ref.m_local == 20
    np.testing.assert_allclose(hist.primal, ref_hist.primal, rtol=1e-4)


@pytest.mark.parametrize("ex", [
    "persistent", "spark_faithful", "reduce_scatter", "compressed",
    "compressed:int8", "compressed:int4", "compressed:int2",
    "compressed:topk(r=0.125)", "compressed:ef:int4",
    "compressed:ef:topk(r=0.125)", "compressed:int8/drop:1@2-3",
    "spark_faithful/drop:0@2/drop:2@3"])
@pytest.mark.parametrize("K", [4, 3])
def test_comm_bytes_per_round_match_the_reference(data, ex, K):
    """The n-vector byte model of SGD (and mini-batch SCD's m-vector)
    equals the reference's for every transport and codec, round by
    round under ``drop:``."""
    A, b = data
    tr = MinibatchSGD(SGDConfig(K=K, exchange=ex), A, b, device="cpu")
    ref = RefSGD(RefSGDConfig(K=K, exchange=ex), A, b)
    scd = MinibatchSCD(CoCoAConfig(K=K, H=8, exchange=ex), A, b,
                       device="cpu")
    ref_scd = RefSCD(RefCoCoAConfig(K=K, H=8, exchange=ex), A, b)
    for t in (None, 1, 2, 3, 4):
        assert tr.comm_bytes_per_round(t) == ref.comm_bytes_per_round(t)
        assert scd.comm_bytes_per_round(t) == ref_scd.comm_bytes_per_round(t)


# -- record_every ---------------------------------------------------------
def _runs(data, which, record_every, target_eps):
    """(port history, reference history) of one 25-round run."""
    A, b = data
    if which == "cocoa":
        cfg = dict(K=4, H=64, lam=1.0, seed=1)
        ref = RefCoCoA(RefCoCoAConfig(**cfg), A, b)
        stream = categorical_stream(np.asarray(ref.mask), 25, 1, 64)
        tr = CoCoATrainer(CoCoAConfig(**cfg), A, b, device="cpu",
                          index_source=replay(stream))
        return (tr.run(25, record_every, target_eps),
                ref.run(25, record_every, target_eps))
    kw = dict(batch_frac=0.5, step_size=0.1, K=4, seed=SEED)
    ref = RefSGD(RefSGDConfig(**kw), A, b)
    if which == "sgd_run":
        tr = MinibatchSGD(SGDConfig(**kw), A, b, device="cpu",
                          global_row_source=replay(global_row_stream(
                              M, ref.batch, 25, SEED)))
        return (tr.run(25, record_every=record_every, target_eps=target_eps),
                ref.run(25, record_every=record_every, target_eps=target_eps))
    tr = MinibatchSGD(SGDConfig(**kw), A, b, device="cpu",
                      row_source=replay(worker_row_stream(
                          4, 1, ref.m_local, ref.batch_local, 25, SEED)))
    return (tr.run_workers(25, record_every, target_eps),
            ref.run_workers(25, record_every, target_eps))


@pytest.mark.parametrize("which", ["cocoa", "sgd_run", "sgd_workers"])
def test_record_every_records_the_reference_rounds(data, which):
    """Rounds 10, 20 and the last; with a target reached in round 13 the
    run stops at the next recorded round, 20. ``span`` counts the rounds
    each record's time covers."""
    full, ref_full = _runs(data, which, 1, None)
    np.testing.assert_allclose(full.primal, ref_full.primal, rtol=1e-4)
    assert full.span == [1] * 25 and len(full.seconds) == 25
    eps = 0.5 * (ref_full.subopt[12] + ref_full.subopt[11])
    for target, rounds in ((None, [10, 20, 25]), (eps, [10, 20])):
        hist, ref_hist = _runs(data, which, 10, target)
        assert hist.rounds == ref_hist.rounds == rounds
        assert hist.span == [10, 10, 5][:len(rounds)]
        assert len(hist.seconds) == len(rounds)
        np.testing.assert_allclose(hist.primal, ref_hist.primal, rtol=1e-4)


def test_record_every_under_stale_flushes_after_an_unrecorded_round(data):
    """``record_every`` does not move what ``finish_run`` absorbs: the
    final iterate of a stale run equals the reference's."""
    A, b = data
    kw = dict(batch_frac=0.5, step_size=0.1, K=4, seed=SEED,
              exchange="compressed:int8/stale:k=2")
    ref = RefSGD(RefSGDConfig(**kw), A, b)
    ref_hist = ref.run_workers(13, record_every=5)
    tr = MinibatchSGD(SGDConfig(**kw), A, b, device="cpu",
                      row_source=replay(worker_row_stream(
                          4, 1, ref.m_local, ref.batch_local, 13, SEED)))
    hist = tr.run_workers(13, record_every=5)
    assert hist.rounds == ref_hist.rounds == [5, 10, 13]
    np.testing.assert_allclose(hist.primal, ref_hist.primal, rtol=1e-4)
    np.testing.assert_allclose(tr.alpha_final, ref.alpha_final,
                               rtol=1e-3, atol=1e-6)


# -- refusals and defaults -----------------------------------------------
def test_sgd_refuses_what_the_reference_refuses(data):
    A, b = data
    with pytest.raises(ValueError, match="H must be >= 1"):
        SGDConfig(H=0)
    tr = MinibatchSGD(SGDConfig(K=4, exchange="persistent/stale"), A, b,
                      device="cpu")
    with pytest.raises(ValueError, match="stale"):
        tr.run(3)
    with pytest.raises(RuntimeError, match="repro_torch.launch.dist"):
        tr.run_sharded(3)
    with pytest.raises(ValueError, match="record_every"):
        tr.run_workers(3, record_every=0)
    with pytest.raises(ValueError):
        SGDConfig(exchange="compressed:int9")


def test_uniform_rows_draw_distinct_rows_deterministically():
    src = UniformRows(24, (4, 3, 10), seed=5, device=torch.device("cpu"))
    draws = [src(t) for t in (1, 2)]
    for rows in draws:
        assert rows.shape == (4, 3, 10) and rows.dtype == torch.int32
        assert bool((rows >= 0).all()) and bool((rows < 24).all())
        flat = rows.reshape(-1, 10)
        assert all(len(set(r.tolist())) == 10 for r in flat)
    assert not torch.equal(draws[0], draws[1])
    again = UniformRows(24, (4, 3, 10), seed=5, device=torch.device("cpu"))
    assert torch.equal(again(2), draws[1])
    # the whole pool is a permutation
    assert sorted(UniformRows(7, (7,), 0, torch.device("cpu"))(1).tolist()) \
        == list(range(7))
    with pytest.raises(ValueError):
        UniformRows(5, (6,), 0, torch.device("cpu"))


def test_default_sources_converge_and_with_h(data):
    A, b = data
    tr = MinibatchSGD(SGDConfig(batch_frac=0.5, step_size=0.1, K=4,
                                exchange="compressed:int8"), A, b,
                      device="cpu")
    hist = tr.run_workers(20, record_every=5)
    assert hist.rounds == [5, 10, 15, 20] and hist.subopt[-1] < 0.5
    assert tr.run(20).subopt[-1] < 0.5
    tr4 = tr.with_H(4)
    assert tr4.cfg.H == 4 and tr4.cfg.exchange == tr.cfg.exchange
    assert tr4.row_source(1).shape == (4, 4, tr.batch_local)
    state = tr.init_state()
    assert state[0].shape == (4, 0) and state[1].shape == (N,)
    ef = MinibatchSGD(SGDConfig(K=4, exchange="compressed:ef:int4/stale:k=2"),
                      A, b, device="cpu").init_state()
    assert ef[0][0].shape == (4, 0) and ef[0][1].shape == (4, N)
    assert ef[1][0].shape == (N,) and ef[1][1].shape == (2, N)
