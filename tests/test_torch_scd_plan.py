"""K1's launch plan (``repro_torch.kernels.scd.scd_plan``), which is pure
Python, and ``scd_solve`` on CPU tensors, which takes the plain version
and matches the reference's SCD solve at the kernel's own tolerance
(rtol 1e-4, atol 1e-5: the dot products are summed in another order)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import scd_steps_ref
from repro_torch.core.solvers import scd_steps
from repro_torch.kernels.scd import (CLUSTERS, RING_MAX, RING_MIN,
                                     SHARED_LIMIT, SLAB_MAX, STAGE_ROWS,
                                     ScdPlan, scd_layout, scd_plan,
                                     scd_solve, shared_bytes, slab_rows)

MS = [1, 3, 4, 5, 33, 96, 1025, 4096, 16383, 16384, 20000, 60000, 65537]


def _all_resident(plan):
    return 1 << 20


@pytest.mark.parametrize("m", MS)
@pytest.mark.parametrize("cluster", CLUSTERS)
def test_slabs_cover_the_rows_exactly(m, cluster):
    S = slab_rows(m, cluster)
    assert S % 4 == 0 and S >= -(-m // cluster)
    assert S - -(-m // cluster) < 4                  # rounded up to 4 only
    bounds = [(min(r * S, m), min((r + 1) * S, m)) for r in range(cluster)]
    rows = [i for lo, hi in bounds for i in range(lo, hi)]
    assert rows == list(range(m))                    # each row once, in order
    # every slab but the last non-empty one is whole, so a bulk copy of it
    # is a multiple of 16 bytes when m is a multiple of 4
    full = [hi - lo for lo, hi in bounds if hi - lo]
    assert all(n == S for n in full[:-1])
    if m % 4 == 0:
        assert all(n % 4 == 0 for n in full)


@pytest.mark.parametrize("m,n_pad", [(16384, 4096), (60000, 8), (33, 5),
                                     (1025, 17), (20000, 40)])
def test_plan_takes_the_largest_cluster_that_fits(m, n_pad):
    plan = scd_plan(8, m, n_pad, _all_resident)
    cands = [c for c in CLUSTERS if scd_layout(m, n_pad, c) is not None
             and (c - 1) * slab_rows(m, c) < m]
    assert plan.cluster == max(cands)
    assert plan == scd_layout(m, n_pad, plan.cluster)
    assert RING_MIN <= plan.ring <= RING_MAX
    assert plan.shared_bytes <= SHARED_LIMIT
    # the ring is the deepest that fits
    if plan.ring < RING_MAX:
        assert shared_bytes(plan.slab, plan.ring + 1, n_pad) > SHARED_LIMIT


def test_plan_at_the_main_path_shape():
    plan = scd_plan(8, 16384, 4096, _all_resident)
    assert plan == ScdPlan(cluster=16, slab=1024, ring=8,
                           shared_bytes=shared_bytes(1024, 8, 4096))
    # ring 8 x 1024 floats, alpha 4096 floats, 48 partials, 40 stage
    # scalars, 18 mbarriers
    assert plan.shared_bytes == 4 * (8 * 1024 + 4096 + 48 + 40) + 8 * 18


def test_plan_needs_every_cluster_resident():
    # 16-CTA clusters: only 7 resident, so 8 workers would run in two
    # waves; 8-CTA clusters: 16 resident
    seen = []

    def active(plan):
        seen.append(plan.cluster)
        return {16: 7, 8: 16}.get(plan.cluster, 100)

    plan = scd_plan(8, 16384, 4096, active)
    assert plan.cluster == 8 and seen == [16, 8]
    assert scd_plan(7, 16384, 4096, active).cluster == 16


def test_plan_respects_the_shared_memory_limit():
    # m = 60000 at n_pad = 8: C = 2 and C = 1 need slabs over 16384 rows;
    # C = 4 fits with 3 stages only
    assert scd_layout(60000, 8, 1) is None and scd_layout(60000, 8, 2) is None
    four = scd_layout(60000, 8, 4)
    assert four.slab == 15000 and four.ring == 3
    assert shared_bytes(15000, 4, 8) > SHARED_LIMIT
    plan = scd_plan(2, 60000, 8, lambda p: 2 if p.cluster == 4 else 0)
    assert plan.cluster == 4


def test_plan_skips_clusters_with_an_empty_cta():
    # m = 33: slabs of 4, 8 and 12 rows leave CTAs without a row
    assert scd_plan(1, 33, 5, _all_resident).cluster == 2
    assert scd_plan(1, 1, 5, _all_resident).cluster == 1
    # forced, a cluster with empty CTAs is still taken
    assert scd_plan(1, 33, 5, _all_resident, cluster=16).slab == 4


def test_forced_cluster():
    plan = scd_plan(8, 16384, 4096, _all_resident, cluster=4)
    assert plan == scd_layout(16384, 4096, 4)
    with pytest.raises(ValueError, match="2 clusters resident, 8 needed"):
        scd_plan(8, 16384, 4096, lambda p: 2, cluster=4)
    with pytest.raises(ValueError, match="cluster must be one of"):
        scd_plan(8, 16384, 4096, _all_resident, cluster=3)


@pytest.mark.parametrize("K,m,n_pad,why", [
    (1, 300000, 8, "a slab of 18752 rows"),          # over 16 x 16384 rows
    (1, 64, 60000, "B of shared memory at ring 2"),  # alpha alone > 227 KB
    (8, 16384, 4096, "0 clusters resident"),
])
def test_plan_raises_when_nothing_fits(K, m, n_pad, why):
    """The register layout's limits (a slab past 16,384 rows, an alpha
    block past shared memory) are passed by the device-memory variants,
    so nothing fits only where no variant's clusters are resident; the
    message gives every reason."""
    with pytest.raises(ValueError, match="no cluster size fits") as exc:
        scd_plan(K, m, n_pad, lambda p: 0)
    assert why in str(exc.value)
    assert "(rho in device, alpha in device): 0 clusters resident" in \
        str(exc.value)
    assert f"m={m}" in str(exc.value) and f"n_pad={n_pad}" in str(exc.value)
    # with the clusters resident the same shape plans
    assert scd_plan(K, m, n_pad, _all_resident).cluster == 16


@pytest.mark.parametrize("m,n_pad", [(2**31, 8), (64, 2**31)])
def test_plan_refuses_past_int32(m, n_pad):
    with pytest.raises(ValueError, match="int32"):
        scd_plan(1, m, n_pad, _all_resident)


def test_plan_refuses_an_empty_problem():
    for K, m, n_pad in [(0, 8, 8), (1, 0, 8), (1, 8, 0)]:
        with pytest.raises(ValueError, match="empty problem"):
            scd_plan(K, m, n_pad, _all_resident)


def test_slab_limit_is_what_one_cta_can_hold():
    """The register layout holds SLAB_MAX rows a CTA; past them rho's
    slab is streamed in stages, in shared memory where it fits beside
    two stages, else in device memory."""
    assert scd_layout(SLAB_MAX, 8, 1).slab == SLAB_MAX
    assert scd_layout(SLAB_MAX + 1, 8, 1) is None
    assert scd_layout(16 * SLAB_MAX, 8, 16).slab == SLAB_MAX
    long = scd_layout(SLAB_MAX + 1, 8, 1, rho="device")
    assert long.slab == SLAB_MAX + 4 and long.stage == STAGE_ROWS
    assert long.shared_bytes == shared_bytes(STAGE_ROWS, long.ring, 8)
    held = scd_layout(SLAB_MAX + 1, 8, 1, rho="shared")
    assert held.stage == STAGE_ROWS and held.ring >= 2
    assert held.shared_bytes == shared_bytes(STAGE_ROWS, held.ring, 8,
                                             SLAB_MAX + 4)
    plan = scd_plan(8, 16 * SLAB_MAX + 1, 8, _all_resident)
    assert (plan.rho, plan.alpha, plan.cluster) == ("shared", "shared", 16)
    # a slab past what shared memory holds beside two stages
    plan = scd_plan(1, 60000, 8, _all_resident, cluster=1)
    assert (plan.rho, plan.alpha) == ("device", "shared")


def _inputs(K, m, n, H, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((K, n, m)).astype(np.float32)
    A[:, -1] = 0.0                                   # a zero column
    colsq = np.sum(A * A, axis=2)
    alpha = (rng.standard_normal((K, n)) * 0.1).astype(np.float32)
    w = rng.standard_normal(m).astype(np.float32)
    idx = rng.integers(0, n, (K, H)).astype(np.int32)
    return A, colsq, alpha, w, idx


@pytest.mark.parametrize("cluster", [None, 16, 1])
def test_scd_solve_on_cpu_is_the_plain_version(cluster):
    A, colsq, alpha, w, idx = _inputs(3, 50, 9, 40, seed=7)
    args = [torch.tensor(x) for x in (A, colsq, alpha, w, idx)]
    kw = dict(sigma=3.0, lam=1.0, eta=0.5)
    before = scd_solve.launches
    dv, a = scd_solve(*args, cluster=cluster, **kw)
    dv_p, a_p = scd_steps(*args, **kw)
    assert scd_solve.launches == before               # no kernel launched
    assert dv.equal(dv_p) and a.equal(a_p)
    for k in range(3):
        dv_r, a_r = scd_steps_ref(jnp.asarray(A[k].T), jnp.asarray(colsq[k]),
                                  jnp.asarray(alpha[k]), jnp.asarray(w),
                                  jnp.asarray(idx[k]), **kw)
        np.testing.assert_allclose(dv[k].numpy(), np.asarray(dv_r),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(a[k].numpy(), np.asarray(a_r),
                                   rtol=1e-4, atol=1e-5)


def test_scd_solve_refuses_a_device_that_is_neither():
    A_T = torch.zeros((1, 4, 8), device="meta")
    with pytest.raises(ValueError, match="CPU .* or on a CUDA device"):
        scd_solve(A_T, A_T[:, :, 0], A_T[:, :, 0], A_T[0, 0], A_T[:, :, 0],
                  sigma=1.0, lam=1.0, eta=1.0)
