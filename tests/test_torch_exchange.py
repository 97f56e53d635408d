"""The port's exchange surface on the virtual driver against the
reference: the ``ExchangeConfig`` grammar (stale, drop, straggler and
backend segments), the straggler profiles, the config's exchange,
membership masks and live-worker bytes, the
bounded-stale queue against a serial replay and the reference's driver,
and CoCoA trajectories under the topk and regime cells of
``repro.analysis.cells`` on the reference's replayed index stream.

Trajectories (m=96, n=256, K=4, H = n_local, trainer seed 1, as
``test_torch_cocoa.py``) hold the per-round primal at rtol 1e-5 and
rounds-to-eps exactly; a straggler profile leaves the port's run bit for
bit that of plain ``persistent``. A run carried over from the
reference's round-4 state under ``ef:topk`` + ``stale:k=2`` + ``drop:``
follows the reference from round 5 on.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import CoCoAConfig as RefConfig
from repro.core import CoCoATrainer as RefTrainer
from repro.core import distributed as dist_ref
from repro.data.synthetic import make_glm_data
from repro_torch import carry
from repro_torch.core import CoCoAConfig, CoCoATrainer
from repro_torch.core import distributed as dist

M, N, K, DENSITY, EPS = 96, 256, 4, 0.2, 1e-3
H = N // K
SEED = 1
ROUNDS = 20
TOPK = "compressed:ef:topk(r=0.125)/stale:k=2/drop:1@2-4"
# (exchange, rounds-to-eps at trainer seed 1; None: not within 20)
CELLS = {
    "compressed:topk(r=0.125)": None,
    "compressed:ef:topk(r=0.125)": 12,
    "persistent/straggler:mix(p=0.25,slow=8)": 10,
    "persistent/stale:k=2": 12,
    "persistent/drop:1@2-4": 11,
    "compressed:ef:int4/stale:k=2": 9,
    "compressed:ef:int4/drop:1@2-4": 13,
    TOPK: 16,
}


# ------------------------------------------------------------- grammar
ROUNDTRIP_SPECS = (
    "persistent",
    "compressed:int4",
    "persistent/stale",
    "compressed:int4/stale:k=2",
    "spark_faithful/straggler:det(slow=4)",
    "persistent/straggler:mix(p=0.1,slow=8)",
    "reduce_scatter/straggler:lognormal(sigma=0.5)",
    "persistent/drop:1@5",
    "compressed:int8/stale:k=3/straggler:mix(p=0.1,slow=8)/drop:1@5-9",
    "persistent/drop:1@5-9/drop:3@7",
    "compressed:ef:topk(r=0.125)/stale:k=2/straggler:det(slow=4)/drop:1@5-9",
)


@pytest.mark.parametrize("spec", ROUNDTRIP_SPECS)
def test_exchange_spec_roundtrips_like_reference(spec):
    ex = dist.ExchangeConfig.parse(spec)
    assert ex.spec == spec == dist_ref.ExchangeConfig.parse(spec).spec
    assert dist.ExchangeConfig.parse(ex.spec) == ex
    assert str(ex) == spec


def test_exchange_spec_segments_are_order_independent():
    a = dist.ExchangeConfig.parse("compressed:int4/stale:k=2/drop:1@5")
    b = dist.ExchangeConfig.parse("drop:1@5/stale:k=2/compressed:int4")
    assert a == b and b.spec == "compressed:int4/stale:k=2/drop:1@5"
    c = dist.ExchangeConfig.parse(
        "straggler:det(slow=4)/drop:1@5-9/stale:k=2/xla/"
        "compressed:ef:topk(r=0.125)")
    assert c.spec == ("compressed:ef:topk(r=0.125)/stale:k=2/"
                      "straggler:det(slow=4)/drop:1@5-9")


def test_exchange_spec_defaults_elided_and_typed_values_pass():
    assert dist.ExchangeConfig.parse("persistent/sync").spec == "persistent"
    assert dist.ExchangeConfig().spec == "persistent"
    assert dist.ExchangeConfig.parse("persistent/xla").spec == "persistent"
    ex = dist.ExchangeConfig.parse("stale:k=2")
    assert ex.scheme.name == "persistent" and ex.mode.k == 2
    assert dist.ExchangeConfig.parse(ex) is ex
    assert dist.ExchangeConfig.parse(
        dist.ExchangeMode.parse("stale:k=2")).mode.k == 2
    ex2 = dist.ExchangeConfig(scheme="compressed:int4", mode="stale:k=2",
                              straggler="mix(p=0.1,slow=8)",
                              membership="drop:1@5")
    assert ex2.spec == ("compressed:int4/stale:k=2/"
                        "straggler:mix(p=0.1,slow=8)/drop:1@5")


ERRORS = [
    (lambda m: m.ExchangeConfig.parse("persistant"),
     ValueError, "unknown exchange spec segment"),
    (lambda m: m.ExchangeConfig.parse("persistent/async"),
     ValueError, "the grammar is"),
    (lambda m: m.ExchangeConfig.parse("compressed:int3"),
     ValueError, "unknown update codec"),
    (lambda m: m.ExchangeConfig.parse("persistent/compressed"),
     ValueError, "duplicate comm-scheme"),
    (lambda m: m.ExchangeConfig.parse("sync/stale"),
     ValueError, "duplicate exchange-mode"),
    (lambda m: m.ExchangeConfig.parse("straggler:det/straggler:mix"),
     ValueError, "duplicate straggler"),
    (lambda m: m.ExchangeMode.parse("stale:k=x"),
     ValueError, "unknown exchange mode"),
    (lambda m: m.ExchangeMode.parse("stale:k=0"),
     ValueError, "k must be >= 1"),
    (lambda m: m.ExchangeMode("sync", k=2),
     ValueError, "'sync' takes no staleness"),
    (lambda m: m.StragglerProfile.parse("pareto"),
     ValueError, "unknown straggler profile"),
    (lambda m: m.StragglerProfile.parse("det(p=0.5)"),
     ValueError, "takes .* parameters"),
    (lambda m: m.StragglerProfile.parse("mix(p=lots)"),
     ValueError, "is not a number"),
    (lambda m: m.StragglerProfile.parse("mix(p=2)"),
     ValueError, "must be in"),
    (lambda m: m.MembershipSchedule.parse("drop:1@"),
     ValueError, "malformed membership segment"),
    (lambda m: m.MembershipSchedule.parse("drop:1@9-5"),
     ValueError, "last >= first"),
    (lambda m: m.MembershipSchedule.parse("drop:1@0"),
     ValueError, "rounds are 1-based"),
    (lambda m: m.ExchangeConfig.parse("persistent/nccl"),
     ValueError, "the grammar is"),
    (lambda m: m.ExchangeConfig.parse("persistent/ring:fast"),
     ValueError, "takes no parameters"),
    (lambda m: m.ExchangeConfig.parse("persistent/xla/xla"),
     ValueError, "duplicate collective-backend"),
    (lambda m: m.ExchangeConfig(backend="nccl"),
     ValueError, "unknown collective backend"),
    (lambda m: m.StragglerProfile("pareto"),
     ValueError, "unknown straggler profile kind"),
    (lambda m: m.StragglerProfile("det", slow=0.5),
     ValueError, "slow multiplier must be >= 1"),
    (lambda m: m.StragglerProfile("lognormal", sigma=-1.0),
     ValueError, "sigma must be >= 0"),
]


@pytest.mark.parametrize("i", range(len(ERRORS)))
def test_exchange_typed_errors_match_reference(i):
    make, exc, match = ERRORS[i]
    with pytest.raises(exc, match=match):
        make(dist_ref)
    with pytest.raises(exc, match=match):
        make(dist)


@pytest.mark.parametrize("spec", ["persistent/ring",
                                  "compressed:int4/ring/stale:k=2",
                                  "ring/persistent"])
def test_ring_backend_parses_like_the_reference(spec):
    """The ``ring`` segment reaches the fabric: it parses to the
    reference's backend and canonical spec, which round-trips."""
    ref = dist_ref.ExchangeConfig.parse(spec)
    ours = dist.ExchangeConfig.parse(spec)
    assert ours.backend == ref.backend == "ring"
    assert ours.spec == ref.spec
    assert dist.ExchangeConfig.parse(ours.spec) == ours
    assert dist.ExchangeConfig(backend="ring").backend == "ring"


# ------------------------------------------------------------ the config
def test_config_replace_moves_the_exchange():
    A, b, _ = make_glm_data(m=32, n=64, density=0.4, seed=0)
    cfg = CoCoAConfig(K=4, H=8, exchange="compressed:int4/stale:k=2")
    assert cfg.exchange == dist.ExchangeConfig.parse(
        "compressed:int4/stale:k=2")
    cfg2 = dataclasses.replace(cfg, H=16)
    assert cfg2.exchange == cfg.exchange and cfg2.H == 16
    cfg3 = dataclasses.replace(cfg, exchange="compressed:ef:topk/drop:1@2")
    assert cfg3.exchange.spec == "compressed:ef:topk/drop:1@2"
    assert cfg3.exchange.scheme.codec.name == "ef:topk(r=0.01)"
    with pytest.raises(ValueError, match="only K=4 workers"):
        CoCoATrainer(CoCoAConfig(K=4, H=8, exchange="persistent/drop:7@2"),
                     A, b, device="cpu")


class _ToyAlgo:
    """The reference test's toy algorithm with round-index-dependent
    applies (a slot applied under the wrong index, dropped or applied
    twice shifts the result), batched over workers."""

    def __init__(self, reweight=False):
        self.live_reweight = reweight

    def local_step(self, data, local, shared, idx, t):
        upd = 0.5 * (data - shared)
        return upd, local + upd

    def apply_update(self, shared, total, t):
        return shared + total / (4.0 * t)

    def local_metric(self, data, local, shared_new):
        return torch.sum((data - shared_new) ** 2, dim=1)

    def finalize_metric(self, shared_new, metric_sum):
        return metric_sum


class _RefToyAlgo:
    def __init__(self, reweight=False):
        self.live_reweight = reweight

    def local_step(self, data_k, local_k, shared, key, t):
        upd = 0.5 * (data_k - shared)
        return upd, local_k + upd

    def apply_update(self, shared, total, t):
        return shared + total / (4.0 * t)

    def local_metric(self, data_k, local_k, shared_new):
        return jnp.sum((data_k - shared_new) ** 2)

    def finalize_metric(self, shared_new, metric_sum):
        return metric_sum


def _toy_replay(data, shared0, local0, rounds, k, membership):
    """Plain-Python bounded-stale contract: round t's aggregate applies
    in round t+k under index t, dropped workers add exact zero and keep
    their state, and the flush absorbs what is still pending."""
    shared = shared0.astype(np.float64).copy()
    local = local0.astype(np.float64).copy()
    pending = [(np.zeros_like(shared), 0)] * k
    for t in range(1, rounds + 1):
        mask = membership.live_mask(t, data.shape[0]).numpy()
        upd = 0.5 * (data - shared[None, :]) * mask[:, None]
        local = np.where(mask[:, None] > 0, local + upd, local)
        agg, idx = pending[0]
        if idx >= 1:
            shared = shared + agg / (4.0 * idx)
        pending = pending[1:] + [(upd.sum(axis=0), t)]
    for agg, idx in pending:
        if idx >= 1:
            shared = shared + agg / (4.0 * idx)
    return shared, local


@pytest.mark.parametrize("spec,k", [
    ("persistent/stale", 1),
    ("persistent/stale:k=2", 2),
    ("persistent/stale:k=3", 3),
    ("persistent/stale:k=2/drop:1@2-3", 2),
    ("persistent/stale:k=3/drop:0@1-2/drop:2@4", 3),
])
def test_bounded_stale_matches_serial_replay_and_reference(spec, k):
    rng = np.random.default_rng(5)
    data = rng.standard_normal((K, 6)).astype(np.float32)
    shared0 = rng.standard_normal(6).astype(np.float32)
    local0 = np.zeros((K, 6), np.float32)
    ex = dist.ExchangeConfig.parse(spec)
    assert ex.mode.k == k
    for rounds in (1, k, k + 2, 7):
        rf = dist.build_virtual_round(_ToyAlgo(), ex, torch.tensor(data), K=K)
        ex_ref = dist_ref.ExchangeConfig.parse(spec)
        rf_ref = dist_ref.build_virtual_round(_RefToyAlgo(), ex_ref,
                                              jnp.asarray(data), K=K)
        local, shared = torch.tensor(local0), dist.init_exchange_state(
            ex, torch.tensor(shared0))
        local_r = jnp.asarray(local0)
        shared_r = dist_ref.init_exchange_state(ex_ref, jnp.asarray(shared0))
        idx = torch.zeros((K, 1), dtype=torch.int32)
        for t in range(1, rounds + 1):
            local, shared, metric = rf(local, shared, idx, t)
            local_r, shared_r, metric_r = rf_ref(local_r, shared_r,
                                                 jax.random.key(t), t)
            np.testing.assert_allclose(float(metric), float(metric_r),
                                       rtol=1e-6)
        got = dist.finish_run(rf, shared, rounds).numpy()
        want, want_local = _toy_replay(data, shared0, local0, rounds, k,
                                       ex.membership)
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(local.numpy(), want_local, atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(
            got, np.asarray(dist_ref.finish_run(rf_ref, shared_r, rounds)),
            atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("spec", ["persistent/drop:1@2-3",
                                  "persistent/stale:k=2/drop:0@1-2/drop:2@4",
                                  "persistent/drop:0@1/drop:1@1/drop:2@1/"
                                  "drop:3@1"])
def test_live_reweight_matches_reference(spec):
    """An averaging algorithm's aggregate is rescaled by K / K_live (and
    by K / 1 when nobody is live, which leaves an exact zero)."""
    rng = np.random.default_rng(9)
    data = rng.standard_normal((K, 5)).astype(np.float32)
    shared0 = rng.standard_normal(5).astype(np.float32)
    ex, ex_ref = (dist.ExchangeConfig.parse(spec),
                  dist_ref.ExchangeConfig.parse(spec))
    rf = dist.build_virtual_round(_ToyAlgo(True), ex, torch.tensor(data),
                                  K=K)
    rf_ref = dist_ref.build_virtual_round(_RefToyAlgo(True), ex_ref,
                                          jnp.asarray(data), K=K)
    local, shared = torch.zeros((K, 5)), dist.init_exchange_state(
        ex, torch.tensor(shared0))
    local_r = jnp.zeros((K, 5))
    shared_r = dist_ref.init_exchange_state(ex_ref, jnp.asarray(shared0))
    for t in range(1, 6):
        local, shared, _ = rf(local, shared, torch.zeros((K, 1)), t)
        local_r, shared_r, _ = rf_ref(local_r, shared_r, jax.random.key(t), t)
    np.testing.assert_allclose(dist.finish_run(rf, shared, 5).numpy(),
                               np.asarray(dist_ref.finish_run(rf_ref,
                                                              shared_r, 5)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(local.numpy(), np.asarray(local_r), rtol=1e-6)


def test_round_fn_carries_mode_and_flush():
    """``finish_run`` reads ``round_fn.mode`` and ``round_fn.flush``; the
    builder takes a spec string or a typed scheme and checks the
    membership schedule against K."""
    data = torch.zeros((K, 3))
    rf = dist.build_virtual_round(_ToyAlgo(), "compressed:ef:int4/stale:k=2",
                                  data, K=K)
    assert rf.mode == dist.ExchangeMode("stale", 2)
    queue = torch.stack([torch.full((3,), 4.0), torch.full((3,), 8.0)])
    # the pending aggregates of rounds 2 and 3 apply under their own index
    got = dist.finish_run(rf, (torch.zeros(3), queue), 3)
    np.testing.assert_allclose(got.numpy(), np.full(3, 4.0 / 8 + 8.0 / 12))
    assert torch.equal(dist.finish_run(rf, (torch.ones(3), queue), 0),
                       torch.ones(3))
    sync = dist.build_virtual_round(_ToyAlgo(), dist.CommScheme("persistent"),
                                    data, K=K)
    assert not sync.mode.stale
    assert torch.equal(dist.finish_run(sync, torch.ones(3), 5), torch.ones(3))
    with pytest.raises(ValueError, match=f"only K={K}"):
        dist.build_virtual_round(_ToyAlgo(), "persistent/drop:5@1", data, K=K)


# ------------------------------------------------------------ stragglers
@pytest.mark.parametrize("spec", ["none", "det(slow=16)", "mix(p=0.5,slow=16)",
                                  "mix(p=0.25,slow=8)", "lognormal(sigma=0.5)",
                                  "lognormal(sigma=1)"])
@pytest.mark.parametrize("form", ["bare", "prefixed", "in_exchange"])
def test_straggler_profile_parses_like_reference(spec, form):
    def parse(m):
        if form == "bare":
            return m.StragglerProfile.parse(spec)
        if form == "prefixed":
            return m.StragglerProfile.parse(f"straggler:{spec}")
        return m.ExchangeConfig.parse(
            f"straggler:{spec}/compressed:int8").straggler
    ours, ref = parse(dist), parse(dist_ref)
    assert (ours.kind, ours.slow, ours.p, ours.sigma) == (
        ref.kind, ref.slow, ref.p, ref.sigma)
    assert ours.spec == ref.spec and ours.active == ref.active
    assert dist.StragglerProfile.parse(ours.spec) == ours


# ------------------------------------------------------------ membership
def test_membership_masks_and_live_count():
    ms = dist.MembershipSchedule.parse("drop:1@2-4/drop:3@5")
    ref = dist_ref.MembershipSchedule.parse("drop:1@2-4/drop:3@5")
    assert ms.spec == ref.spec == "drop:1@2-4/drop:3@5"
    for t in (1, 2, 4, 5, 9):
        mask = ms.live_mask(t, 4)
        assert mask.dtype == torch.float32 and mask.shape == (4,)
        np.testing.assert_array_equal(mask.numpy(),
                                      np.asarray(ref.live_mask(t, 4)))
        assert ms.live_count(t, 4) == ref.live_count(t, 4) == int(mask.sum())
    forever = dist.MembershipSchedule.parse("drop:0@3")
    assert forever.live_count(2, 4) == 4 and forever.live_count(100, 4) == 3
    with pytest.raises(ValueError, match="only K=2"):
        ms.check_workers(2)


@pytest.mark.parametrize("scheme", ["persistent", "spark_faithful",
                                    "reduce_scatter", "compressed:int8",
                                    "compressed:ef:topk(r=0.125)"])
@pytest.mark.parametrize("K_live", [None, 0, 3, 8])
def test_bytes_per_round_prices_live_workers(scheme, K_live):
    ours = dist.CommScheme(scheme).bytes_per_round(16384, 8, 8 * 4096,
                                                   K_live=K_live)
    ref = dist_ref.CommScheme(scheme).bytes_per_round(
        16384, 8, local_state_len=8 * 4096, K_live=K_live)
    assert ours == ref


# ---------------------------------------- CoCoA trajectories on the regimes
@pytest.fixture(scope="module")
def data():
    A, b, _ = make_glm_data(m=M, n=N, density=DENSITY, zipf_a=1.1, seed=42)
    return A, b


def reference_stream(mask, rounds, seed, H):
    """The reference trainer's per-round (K, H) coordinates (the key
    splits of its record loop and driver, the masked categorical draw of
    its local step); a dropped or stale round draws the same."""
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


@pytest.fixture(scope="module")
def ref_runs(data):
    A, b = data
    runs = {}
    for ex in CELLS:
        tr = RefTrainer(RefConfig(K=K, H=H, lam=1.0, solver="scd_ref",
                                  exchange=ex, seed=SEED), A, b)
        hist = tr.run(ROUNDS, target_eps=EPS)
        runs[ex] = (tr, hist, reference_stream(np.asarray(tr.mask),
                                               ROUNDS, SEED, H))
    return runs


def _port(data, ex, stream, solver="scd_ref"):
    A, b = data
    cfg = CoCoAConfig(K=K, H=H, lam=1.0, solver=solver, exchange=ex,
                      seed=SEED)
    return CoCoATrainer(cfg, A, b, device="cpu",
                        index_source=carry.ReplayIndices(stream, device="cpu"))


@pytest.mark.parametrize("ex", list(CELLS))
@pytest.mark.parametrize("solver", ["scd_ref", "scd_kernel"])
def test_regime_trajectory_matches_live_reference(data, ref_runs, ex, solver):
    ref_tr, ref_hist, stream = ref_runs[ex]
    tr = _port(data, ex, stream, solver)
    hist = tr.run(ROUNDS, target_eps=EPS)
    assert hist.rounds == ref_hist.rounds
    np.testing.assert_allclose(hist.primal, ref_hist.primal, rtol=1e-5)
    assert hist.rounds_to(EPS) == ref_hist.rounds_to(EPS) == CELLS[ex]
    for t in [None] + hist.rounds:
        assert tr.comm_bytes_per_round(t) == ref_tr.comm_bytes_per_round(t)
    np.testing.assert_allclose(tr.w_final, ref_tr.w_final, rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tr.alpha_final, ref_tr.alpha_final,
                               rtol=1e-3, atol=1e-5)


def test_drop_round_bytes_price_live_workers(data, ref_runs):
    ref_tr, _, stream = ref_runs[TOPK]
    tr = _port(data, TOPK, stream)
    # 96 entries keep 12: 8*12 + 4 = 100 B per worker each way
    assert [tr.comm_bytes_per_round(t) for t in range(1, 6)] == \
        [800, 600, 600, 600, 800]


def test_straggler_run_is_bit_equal_to_persistent(data, ref_runs):
    stream = ref_runs["persistent/straggler:mix(p=0.25,slow=8)"][2]
    runs = {}
    for ex in ("persistent", "persistent/straggler:mix(p=0.25,slow=8)"):
        tr = _port(data, ex, stream)
        runs[ex] = (tr.run(ROUNDS, target_eps=EPS).primal, tr.alpha_final,
                    tr.w_final)
    (p0, a0, w0), (p1, a1, w1) = runs.values()
    assert p0 == p1
    assert np.array_equal(a0, a1) and np.array_equal(w0, w1)


def test_carry_stale_ef_drop_state_and_resume_mid_run(data, ref_runs):
    """The reference's state after round 4 under ``ef:topk`` +
    ``stale:k=2`` + ``drop:1@2-4`` is ``((alpha, residual), (w, queue))``;
    the port takes it over and follows the reference from round 5."""
    ref_tr, ref_hist, stream = ref_runs[TOPK]
    local, shared = ref_tr.init_state()
    key = jax.random.key(SEED)
    for t in range(1, 5):
        key, sub = jax.random.split(key)
        local, shared, _ = ref_tr._round_fn(local, shared, sub, t)
    local_np = jax.tree_util.tree_map(np.asarray, local)
    shared_np = jax.tree_util.tree_map(np.asarray, shared)
    state = carry.state_from_reference(local_np, shared_np, device="cpu")
    (alpha, residual), (w, queue) = state
    assert residual.shape == (K, M) and queue.shape == (2, M)
    assert float(queue.abs().max()) > 0 and float(residual.abs().max()) > 0
    back_local, back_shared = carry.state_to_numpy(*state)
    for got, want in zip(jax.tree_util.tree_leaves((back_local, back_shared)),
                         jax.tree_util.tree_leaves((local_np, shared_np))):
        np.testing.assert_array_equal(got, want)
    tr = _port(data, TOPK, stream)
    rest = len(ref_hist.rounds) - 4
    hist = tr.run(rest, state=state, first_round=5)
    assert hist.rounds == ref_hist.rounds[4:]
    np.testing.assert_allclose(hist.primal, ref_hist.primal[4:], rtol=1e-5)
    np.testing.assert_allclose(tr.w_final, ref_tr.w_final, rtol=1e-4,
                               atol=1e-5)


def test_carry_refuses_a_queue_of_the_wrong_shape():
    alpha, w = np.zeros((2, 3), np.float32), np.zeros(5, np.float32)
    with pytest.raises(ValueError, match="queue"):
        carry.state_from_reference(alpha, (w, np.zeros((2, 4))), device="cpu")
    with pytest.raises(ValueError, match="pair"):
        carry.state_from_reference(alpha, (w, w, w), device="cpu")


def test_stale_run_without_rounds_unwraps_the_shared_state(data):
    A, b = data
    tr = CoCoATrainer(CoCoAConfig(K=K, H=H, exchange="persistent/stale:k=2"),
                      A, b, device="cpu")
    local, shared = tr.init_state()
    assert shared[1].shape == (2, M) and not bool(shared[1].any())
    hist = tr.run(0)
    assert hist.rounds == [] and tr.w_final.shape == (M,)
    np.testing.assert_array_equal(tr.w_final, -b)
