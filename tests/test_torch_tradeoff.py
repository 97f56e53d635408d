"""The port's trade-off layer against the reference on the CPU: the
overhead profiles, the byte model, the straggler timing model, the
``TimeModel``, ``optimal_H`` / ``autotune_H`` (exactly equal: pure
Python on the same constants), ``sweep_H`` on the reference's replayed
per-H index streams (rounds-to-eps per point equal), the timing
discipline and ``calibrate_link`` over a gloo group.

The reference samples with ``jax.random``, which PyTorch cannot
reproduce, so the sweeps replay the reference's own per-H streams
through ``index_source_for``, recomputed here by the reference's key
splits; the straggler draws of ``barrier_mults`` match the reference in
distribution only (``none`` and ``det`` exactly)."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.bench import timing as ref_timing
from repro.core import CoCoAConfig as RefCoCoAConfig
from repro.core import SGDConfig as RefSGDConfig
from repro.core import CoCoATrainer as RefCoCoA
from repro.core import overheads as ref_overheads
from repro.core import tradeoff as ref_tradeoff
from repro.core.distributed import StragglerProfile as RefStraggler
from repro.data.synthetic import make_glm_data
from repro_torch import carry
from repro_torch.bench import timing
from repro_torch.core import (PROFILES, CoCoAConfig, CoCoATrainer, SGDConfig,
                              StragglerProfile, overheads, tradeoff)
from repro_torch.core.tradeoff import (HSweep, HSweepPoint,
                                       NoConvergedPointError, TimeModel,
                                       autotune_H, compute_fraction_at,
                                       optimal_H, sweep_H, time_to_eps)
from repro_torch.launch.dist import init_group, spawn

M, N, K, DENSITY = 96, 256, 4, 0.2


@pytest.fixture(scope="module")
def data():
    A, b, _ = make_glm_data(m=M, n=N, density=DENSITY, zipf_a=1.1, seed=42)
    return A, b


# -- the profiles and the byte model -------------------------------------
@pytest.mark.parametrize("name", sorted(ref_overheads.PROFILES))
def test_profiles_equal_reference(name):
    ref, port = ref_overheads.PROFILES[name], PROFILES[name]
    assert sorted(PROFILES) == sorted(ref_overheads.PROFILES)
    for f in ("name", "description", "compute_mult", "overhead_units",
              "persistent_alpha"):
        assert getattr(port, f) == getattr(ref, f), f
    for ts, tr in ((1.0, 1.0), (0.0123, 0.5), (3e-4, 2.0)):
        assert port.round_time(ts, tr, 0.1) == ref.round_time(ts, tr, 0.1)
        assert port.compute_fraction(ts, tr) == ref.compute_fraction(ts, tr)


@pytest.mark.parametrize("scheme", [
    None, "persistent", "spark_faithful", "compressed", "compressed:int8",
    "compressed:int4", "compressed:int2", "compressed:ef:int4",
    "compressed:topk(r=0.125)", "reduce_scatter"])
def test_communicated_bytes_equal_reference(scheme):
    for m, n, K_ in ((1000, 100000, 8), (96, 257, 4), (16384, 32768, 8),
                     (5, 7, 3)):
        for persistent in (True, False):
            args = (m, n, K_, persistent)
            assert (overheads.communicated_bytes_per_round(*args,
                                                           scheme=scheme)
                    == ref_overheads.communicated_bytes_per_round(
                        *args, scheme=scheme)), (args, scheme)


def test_communicated_bytes_rejects_an_unknown_scheme():
    for fn in (overheads.communicated_bytes_per_round,
               ref_overheads.communicated_bytes_per_round):
        with pytest.raises(ValueError, match="unknown comm scheme"):
            fn(10, 20, 2, True, scheme="quantised")


# -- the straggler timing model -----------------------------------------
STRAGGLERS = ["straggler:none", "straggler:det(slow=4)",
              "straggler:mix(p=0.1,slow=8)", "straggler:mix(p=0.5,slow=16)",
              "straggler:lognormal(sigma=0.5)", "straggler:lognormal(sigma=1)"]


@pytest.mark.parametrize("spec", STRAGGLERS)
def test_expected_barrier_mult_equals_reference(spec):
    port, ref = StragglerProfile.parse(spec), RefStraggler.parse(spec)
    for K_ in (1, 3, 4, 8, 64):
        assert port.expected_barrier_mult(K_) == ref.expected_barrier_mult(K_)
    for s in (port, ref):
        with pytest.raises(ValueError, match="K >= 1"):
            s.expected_barrier_mult(0)


@pytest.mark.parametrize("spec", ["straggler:none", "straggler:det(slow=4)"])
def test_deterministic_multipliers_equal_reference(spec):
    port, ref = StragglerProfile.parse(spec), RefStraggler.parse(spec)
    g = torch.Generator().manual_seed(0)
    for K_ in (1, 5, 8):
        np.testing.assert_array_equal(
            port.multipliers(g, K_).numpy(),
            np.asarray(ref.multipliers(jax.random.key(3), K_)))
        np.testing.assert_array_equal(
            port.barrier_mults(g, K_, 7).numpy(),
            np.asarray(ref.barrier_mults(jax.random.key(3), K_, 7)))


@pytest.mark.parametrize("spec", ["straggler:mix(p=0.25,slow=8)",
                                  "straggler:lognormal(sigma=0.5)"])
def test_sampled_barrier_mults_match_in_distribution(spec):
    """The mean of 4096 sampled barrier factors lies within 3 standard
    errors of ``expected_barrier_mult``. For ``lognormal`` the expected
    value is itself a Monte Carlo mean of 8192 draws, so its error adds
    in; a fixed seed gives the same draws again."""
    s, K_, rounds = StragglerProfile.parse(spec), 8, 4096
    draws = s.barrier_mults(torch.Generator().manual_seed(0), K_, rounds)
    again = s.barrier_mults(torch.Generator().manual_seed(0), K_, rounds)
    assert torch.equal(draws, again)
    assert draws.shape == (rounds,) and draws.dtype == torch.float32
    x = draws.double().numpy()
    mc = 1 / 8192 if s.kind == "lognormal" else 0.0
    se = x.std(ddof=1) * math.sqrt(1 / rounds + mc)
    want = RefStraggler.parse(spec).expected_barrier_mult(K_)
    assert abs(x.mean() - want) <= 3 * se, (x.mean(), want, se)
    one = s.multipliers(torch.Generator().manual_seed(1), K_)
    assert one.shape == (K_,) and bool((one > 0).all())


# -- the time model -------------------------------------------------------
TM_EXCHANGES = ["persistent", "compressed:int4/ring", "reduce_scatter",
                "persistent/stale:k=2", "persistent/straggler:det(slow=4)",
                "persistent/straggler:mix(p=0.25,slow=8)",
                "persistent/straggler:lognormal(sigma=0.5)"]


@pytest.mark.parametrize("spec", TM_EXCHANGES)
@pytest.mark.parametrize("link", [(1e9, 1e-4), (2.5e7, 1e-3)])
@pytest.mark.parametrize("workers", [1, 4, 8])
def test_time_model_equals_reference(spec, link, workers):
    for name in sorted(PROFILES):
        for nbytes in (0, 800, 10 ** 6):
            port = TimeModel(PROFILES[name], nbytes,
                             timing.synthetic_link(*link), exchange=spec,
                             workers=workers)
            ref = ref_tradeoff.TimeModel(
                ref_overheads.PROFILES[name], nbytes,
                ref_timing.synthetic_link(*link), exchange=spec,
                workers=workers)
            assert port.name == ref.name
            assert port.exchange.spec == ref.exchange.spec
            assert port.barrier_mult == ref.barrier_mult
            for t in (0.0, 1e-3, 0.5):
                assert port.comm_time_s(t) == ref.comm_time_s(t)
            for ts, tr in ((1.0, 1.0), (2e-4, 5e-3), (0.03, 0.0)):
                assert port.round_time(ts, tr) == ref.round_time(ts, tr)
                assert (port.compute_fraction(ts, tr)
                        == ref.compute_fraction(ts, tr))


def test_time_model_refuses_what_the_reference_refuses():
    E = PROFILES["E_mpi"]
    link = timing.synthetic_link(1e9)
    with pytest.raises(ValueError, match="workers"):
        TimeModel(E, exchange="persistent/straggler:det(slow=4)")
    with pytest.raises(ValueError, match="needs workers=K"):
        TimeModel(E, 10, link, exchange="persistent/ring")
    with pytest.raises(ValueError, match="unknown exchange"):
        TimeModel(E, exchange="async")
    # no link, or nothing to move: the bare profile
    assert TimeModel(E, 10 ** 9).round_time(1.0, 1.0) == E.round_time(1.0, 1.0)
    assert TimeModel(E, 0, link).comm_time_s() == 0.0


# -- optimal_H, compute_fraction_at and autotune_H -----------------------
def _toy_sweeps(**kw):
    """The reference tests' toy sweep (rounds ~ c/H, t_solver linear in
    H), built in both packages."""
    out = []
    for mod in (tradeoff, ref_tradeoff):
        sweep = mod.HSweep(eps=1e-3, n_local=1024, t_ref_s=1.0, **kw)
        for H in (16, 64, 256, 1024, 4096):
            rounds = int(np.ceil(20000 / H)) + 5
            sweep.points.append(mod.HSweepPoint(H, rounds,
                                                t_solver_s=H / 1024.0))
        out.append(sweep)
    return out


@pytest.mark.parametrize("kw", [
    dict(), dict(comm_bytes_per_round=10 ** 9),
    dict(comm_bytes_per_round=10 ** 9, mode="stale"),
    dict(comm_bytes_per_round=4 << 20, exchange="compressed:int4/ring",
         workers=8),
    dict(comm_bytes_per_round=1 << 10, exchange="persistent/ring",
         workers=8),
    dict(comm_bytes_per_round=10 ** 6, workers=4,
         exchange="persistent/straggler:mix(p=0.5,slow=16)"),
    dict(comm_bytes_per_round=10 ** 6, workers=8,
         exchange="compressed:int8/stale:k=2/straggler:det(slow=64)")])
def test_optimal_H_and_compute_fraction_equal_reference(kw):
    port, ref = _toy_sweeps(**kw)
    assert port.exchange == ref.exchange
    links = [(l_, timing.synthetic_link(*l_), ref_timing.synthetic_link(*l_))
             for l_ in ((1e9, 1e-4), (100e6, 0.0), (1e9, 0.2))]
    for name in sorted(PROFILES):
        models = [(PROFILES[name], ref_overheads.PROFILES[name])]
        for _, lp, lr in links:
            models.append((TimeModel(PROFILES[name], link=lp,
                                     workers=8).for_sweep(port),
                           ref_tradeoff.TimeModel(ref_overheads.PROFILES[name],
                                                  link=lr,
                                                  workers=8).for_sweep(ref)))
        for mp, mr in models:
            h, t = optimal_H(mp, port)
            assert (h, t) == ref_tradeoff.optimal_H(mr, ref)
            assert (compute_fraction_at(mp, port, h)
                    == ref_tradeoff.compute_fraction_at(mr, ref, h))
            for pp, pr in zip(port.points, ref.points):
                assert (time_to_eps(mp, pp, port.t_ref_s)
                        == ref_tradeoff.time_to_eps(mr, pr, ref.t_ref_s))


def test_h_sweep_folds_the_display_pair_as_the_reference_does():
    for kw in (dict(mode="stale"), dict(scheme="compressed:int4"),
               dict(scheme="compressed", mode="stale:k=2"), dict()):
        assert (HSweep(eps=1e-3, n_local=8, **kw).exchange
                == ref_tradeoff.HSweep(eps=1e-3, n_local=8, **kw).exchange)


def test_no_converged_point_and_unknown_H_raise_as_the_reference_does():
    sweeps = []
    for mod in (tradeoff, ref_tradeoff):
        sweep = mod.HSweep(eps=1e-9, n_local=64, t_ref_s=1.0,
                           algorithm="cocoa", scheme="persistent")
        for H in (4, 16):
            sweep.points.append(mod.HSweepPoint(H, None, t_solver_s=0.1))
        sweeps.append(sweep)
    msgs = []
    for mod, sweep, prof in ((tradeoff, sweeps[0], PROFILES),
                             (ref_tradeoff, sweeps[1],
                              ref_overheads.PROFILES)):
        with pytest.raises(RuntimeError) as e:
            mod.optimal_H(prof["E_mpi"], sweep)
        assert e.value.sweep is sweep
        msgs.append(str(e.value))
        assert mod.time_to_eps(prof["E_mpi"], sweep.points[0],
                               1.0) == float("inf")
        with pytest.raises(KeyError, match=r"H=3 is not a sweep grid point"):
            mod.compute_fraction_at(prof["E_mpi"], sweep, 3)
    assert isinstance(NoConvergedPointError(sweeps[0]), RuntimeError)
    assert msgs[0] == msgs[1] and "no H in [4, 16]" in msgs[0]


@pytest.mark.parametrize("rounds_fn,time_fn,lo,hi", [
    (lambda H: 10, lambda H: H + 1e-3, 1, 4096),
    (lambda H: int(np.ceil(1e6 / H)) + 1, lambda H: 1.0, 1, 4096),
    (lambda H: None if H < 50 else int(np.ceil(5000 / H)) + 3,
     lambda H: 1e-3 * H + 0.5, 4, 4096),
    (lambda H: int(np.ceil(7000 / H)) + 2, lambda H: 2e-4 * H + 3.1e-3,
     256, 16384)])
def test_autotune_H_equals_reference(rounds_fn, time_fn, lo, hi):
    assert (autotune_H(rounds_fn, time_fn, lo, hi)
            == ref_tradeoff.autotune_H(rounds_fn, time_fn, lo, hi))


@settings(max_examples=20, deadline=None)
@given(c=st.floats(100.0, 50000.0), slope=st.floats(1e-4, 1e-1),
       ovh=st.floats(1e-4, 10.0))
def test_autotune_H_finds_convex_minimum_as_the_reference(c, slope, ovh):
    """The reference's property, through both packages."""
    def rounds_fn(H):
        return int(np.ceil(c / H)) + 3

    def time_fn(H):
        return slope * H + ovh

    h = autotune_H(rounds_fn, time_fn, 1, 8192)
    assert h == ref_tradeoff.autotune_H(rounds_fn, time_fn, 1, 8192)
    grid = [2 ** i for i in range(14)]
    best = min(rounds_fn(g) * time_fn(g) for g in grid)
    assert rounds_fn(h) * time_fn(h) <= 2.05 * best


# -- sweep_H on the reference's replayed streams -------------------------
def _categorical_stream(mask, rounds: int, seed: int, H: int):
    """CoCoA's (and mini-batch SCD's) per-round (K, H) coordinates, as
    the reference's round draws them."""
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


def _row_stream(K_, H, m_local, batch, rounds, seed):
    """Mini-batch SGD ``run_workers``' per-round (K, H, batch_local) rows."""
    key = jax.random.key(seed)
    stream = []
    for _ in range(rounds):
        key, sub = jax.random.split(key)
        keys = jax.random.split(sub, K_)
        per = []
        for k in range(K_):
            subs = [keys[k]] if H == 1 else list(jax.random.split(keys[k], H))
            per.append(np.stack([np.asarray(jax.random.choice(
                kh, m_local, shape=(batch,), replace=False)) for kh in subs]))
        stream.append(np.stack(per).astype(np.int32))
    return stream


SWEEPS = [
    # (algorithm, exchange, seed, grid, eps, max_rounds, rounds-to-eps)
    ("cocoa", "persistent", 1, (16, 32, 64), 1e-3, 60, [31, 17, 10]),
    ("cocoa", "compressed:int8", 1, (16, 32, 64), 1e-3, 60, [25, 16, 11]),
    ("minibatch_scd", "compressed:int8", 0, (32, 64), 1e-3, 60, [None, 28]),
    ("minibatch_sgd", "compressed:int8", 0, (1, 2), 1e-2, 40, [None, 29])]


@pytest.mark.parametrize("algo,ex,seed,grid,eps,rounds,r2e", SWEEPS,
                         ids=[f"{s[0]}-{s[1]}" for s in SWEEPS])
def test_sweep_H_equals_reference_on_replayed_streams(data, algo, ex, seed,
                                                      grid, eps, rounds, r2e):
    A, b = data
    if algo == "minibatch_sgd":
        kw = dict(step_size=0.1, K=K, H=1, lam=1.0, exchange=ex, seed=seed)
        ref_cfg, cfg = RefSGDConfig(**kw), SGDConfig(**kw)
    else:
        kw = dict(K=K, H=N // K, lam=1.0, solver="scd_ref", exchange=ex,
                  seed=seed)
        ref_cfg, cfg = RefCoCoAConfig(**kw), CoCoAConfig(**kw)
    ref = ref_tradeoff.sweep_H(A, b, ref_cfg, grid, eps=eps,
                               max_rounds=rounds, measure=False,
                               algorithm=algo)
    assert [p.rounds_to_eps for p in ref.points] == r2e
    streams = {}
    for p in ref.points:
        n_rounds = p.rounds_to_eps or rounds
        if algo == "minibatch_sgd":
            m_local = -(-M // K)
            streams[p.H] = _row_stream(K, p.H, m_local, m_local, n_rounds,
                                       seed)
        else:
            mask = np.asarray(RefCoCoA(RefCoCoAConfig(**kw), A, b).mask)
            streams[p.H] = _categorical_stream(mask, n_rounds, seed, p.H)
    port = sweep_H(A, b, cfg, grid, eps=eps, max_rounds=rounds,
                   measure=False, algorithm=algo, device="cpu",
                   index_source_for=lambda H: carry.ReplayIndices(
                       streams[H], device="cpu"))
    assert [p.H for p in port.points] == list(grid)
    assert [p.rounds_to_eps for p in port.points] == r2e
    assert all(math.isnan(p.t_solver_s) for p in port.points)
    for f in ("eps", "n_local", "algorithm", "scheme", "mode",
              "comm_bytes_per_round", "exchange", "workers"):
        assert getattr(port, f) == getattr(ref, f), f
    assert math.isnan(port.t_ref_s) and math.isnan(ref.t_ref_s)


@pytest.mark.parametrize("algo", ["cocoa", "minibatch_scd", "minibatch_sgd"])
def test_sweep_H_measures_finite_positive_times_on_the_cpu(data, algo):
    A, b = data
    cfg = (SGDConfig(step_size=0.1, K=K, exchange="compressed:int8")
           if algo == "minibatch_sgd" else
           CoCoAConfig(K=K, H=8, exchange="compressed:ef:int4/stale:k=2"))
    sweep = sweep_H(A, b, cfg, (2, 8), eps=1e-3, max_rounds=3,
                    algorithm=algo, device="cpu")
    times = [p.t_solver_s for p in sweep.points] + [sweep.t_ref_s]
    assert all(math.isfinite(t) and t > 0 for t in times), times
    assert sweep.workers == K and sweep.n_local == N // K


def test_make_trainer_refuses_what_the_reference_refuses(data):
    A, b = data
    with pytest.raises(TypeError, match="SGDConfig"):
        tradeoff.make_trainer("minibatch_sgd", CoCoAConfig(K=K), A, b,
                              device="cpu")
    with pytest.raises(ValueError, match="unknown algorithm"):
        tradeoff.make_trainer("adam", CoCoAConfig(K=K), A, b, device="cpu")
    src = carry.ReplayIndices([np.zeros((K, 3), np.int32)], device="cpu")
    tr = tradeoff.make_trainer("minibatch_scd", CoCoAConfig(K=K), A, b,
                               device="cpu", index_source=src)
    assert tr.cfg.solver == "scd_fixed" and tr.index_source is src


def test_with_H_shares_the_data_and_rebuilds_the_round(data):
    """``measure_solver_time`` times ``with_H(H)``: a trainer at the new
    H on the same data, which it shares instead of placing it again."""
    A, b = data
    tr = CoCoATrainer(CoCoAConfig(K=K, H=8), A, b, device="cpu")
    tr.run(2)
    t2 = tr.with_H(32)
    assert t2.A_T is tr.A_T and t2.p_star == tr.p_star and t2.part is tr.part
    assert t2.cfg.H == 32 and t2.index_source(1).shape == (K, 32)
    assert t2._round_fn is not tr._round_fn
    assert not hasattr(t2, "w_final")
    fresh = CoCoATrainer(CoCoAConfig(K=K, H=32), A, b, device="cpu")
    assert t2.run(4).primal == fresh.run(4).primal


def test_time_callable_applies_its_policy():
    calls = []
    for reduce in ("min", "median", "mean"):
        t = timing.time_callable(calls.append, 1,
                                 policy=timing.TimingPolicy(2, 3, reduce))
        assert t >= 0
    assert len(calls) == 15
    with pytest.raises(ValueError, match="unknown reduce"):
        timing.TimingPolicy(reduce="max").combine([1.0])


# -- the end-to-end H trade-off (the port of tests/test_system.py) -------
def test_end_to_end_h_tradeoff_flips_with_framework():
    """Measured rounds-to-eps over an H grid and the calibrated overhead
    profiles: the optimal H moves up from MPI to pySpark."""
    A, b, _ = make_glm_data(m=160, n=320, density=0.3, seed=5)
    sweep = HSweep(eps=1e-3, n_local=80, t_ref_s=0.08)
    for H in (8, 32, 128, 512):
        tr = CoCoATrainer(CoCoAConfig(K=4, H=H, seed=2), A, b, device="cpu")
        hist = tr.run(rounds=600, record_every=1, target_eps=1e-3)
        sweep.points.append(
            HSweepPoint(H, hist.rounds_to(1e-3), t_solver_s=H * 1e-3))
    h_mpi, _ = optimal_H(PROFILES["E_mpi"], sweep)
    h_py, _ = optimal_H(PROFILES["D_pyspark_c"], sweep)
    assert h_py >= h_mpi
    assert h_py >= 128


# -- calibrate_link ------------------------------------------------------
@pytest.mark.parametrize("spec", ["persistent", "spark_faithful",
                                  "compressed:int4/ring"])
def test_fake_bandwidth_equals_the_reference_synthetic_link(spec):
    port = timing.calibrate_link(spec, fake_bandwidth_Bps=2e9,
                                 fake_latency_s=1e-4)
    ref = ref_timing.calibrate_link(spec, fake_bandwidth_Bps=2e9,
                                    fake_latency_s=1e-4)
    fields = ("bandwidth_Bps", "latency_s", "source")
    assert ([getattr(port, f) for f in fields]
            == [getattr(ref, f) for f in fields])
    for nbytes, overlap, hops in ((2e9, 0.0, 1), (1e6, 3e-4, 6), (0, 1.0, 2)):
        assert (port.seconds_for(nbytes, overlap, hops)
                == ref.seconds_for(nbytes, overlap, hops))
    slow, slow_ref = port.scaled(0.01), ref.scaled(0.01)
    assert ([getattr(slow, f) for f in fields]
            == [getattr(slow_ref, f) for f in fields])
    with pytest.raises(ValueError, match="bandwidth"):
        timing.synthetic_link(0.0)
    with pytest.raises(ValueError, match="latency"):
        timing.LinkCalibration(1e9, -1.0)


CALIBRATED = ("persistent", "compressed:int8", "persistent/ring")


def _calibrate_rank(rank, world, device):
    return [timing.calibrate_link(ex, device=device,
                                  policy=timing.TimingPolicy(1, 3))
            for ex in CALIBRATED]


def test_calibrate_link_fits_a_two_rank_gloo_group(tmp_path):
    fits = spawn(2, _calibrate_rank, device="cpu",
                 init_file=str(tmp_path / "init"), timeout_s=120)
    for rank_fits in fits:
        for ex, link in zip(CALIBRATED, rank_fits):
            assert link.source == "measured", ex
            assert math.isfinite(link.bandwidth_Bps), ex
            assert link.bandwidth_Bps > 0 and link.latency_s >= 0, ex


def test_calibrate_link_on_one_rank_gives_an_infinite_bandwidth(tmp_path):
    import torch.distributed as tdist

    init_group("gloo", f"file://{tmp_path / 'init'}", 1, 0, 60)
    try:
        links = [timing.calibrate_link(ex, device="cpu",
                                       policy=timing.TimingPolicy(1, 2))
                 for ex in CALIBRATED]
    finally:
        tdist.destroy_process_group()
    for link in links:
        assert link.bandwidth_Bps == float("inf") and link.latency_s >= 0
        assert link.seconds_for(10 ** 9) == link.latency_s
