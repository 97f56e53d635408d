"""Webspam-length rows on the port: the kernels' launch plans at the
shapes their first designs refused, and the CPU path at m = L = 350,000
(the corpus' example count) against the reference.

The plans are pure Python. At the long shapes each returns a plan and
names the variant it takes (K1: rho's slab streamed, in shared or device
memory, and/or alpha in device memory; K2: the streaming form; K4: the
survivors, and past that the patterns, in device memory), and the main
path's plans stay what they were. The plain versions, which are the kernels' oracles and
their CPU path, hold at L = 350,000: the int8 / int4 / int2 /
topk(r=0.125) encodes and decode+reduce bit-identical to the reference's
eager ``encode_ref`` and ``decode_stacked_ref`` (the jnp references, not
the interpret-mode Pallas top-k, which is O(k*L) there), and
``scd_steps`` against the reference SCD within its tolerance (rtol 1e-4,
atol 1e-5: the dot products are summed in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.codec import get_codec as get_codec_ref
from repro.kernels.ref import decode_stacked_ref as decode_ref
from repro.kernels.ref import scd_steps_ref
from repro_torch.comm.codec import get_codec
from repro_torch.core.solvers import scd_steps
from repro_torch.kernels import dequant, quant, scd, topk
from repro_torch.kernels.quant import QuantPlan, quant_plan
from repro_torch.kernels.scd import ScdPlan, scd_plan, scd_solve
from repro_torch.kernels.topk import TopkPlan, topk_plan

WEBSPAM_M = 350000            # webspam's examples
K_ROWS = 8


def _all_resident(plan):
    return 1 << 20


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


# -- the plans ----------------------------------------------------------------

@pytest.mark.parametrize("K,m,n_pad,cluster,rho,alpha", [
    (8, 262145, 128, 16, "shared", "shared"),     # just past 16 x 16384 rows
    (8, 262148, 8, 16, "shared", "shared"),
    (8, WEBSPAM_M, 128, 16, "shared", "shared"),  # the long-row path
    (8, WEBSPAM_M, 1024, 16, "shared", "shared"),
    (8, WEBSPAM_M, 4096, 16, "shared", "shared"),
    (8, 1000000, 128, 16, "device", "shared"),    # past shared memory too
    (8, 16384, 55995, 16, "registers", "device"),  # alpha past shared memory
    (1, 16384, 56000, 16, "registers", "device"),
    (2, 4096, 65536, 16, "registers", "device"),
])
def test_scd_plan_at_long_shapes(K, m, n_pad, cluster, rho, alpha):
    plan = scd_plan(K, m, n_pad, _all_resident)
    assert (plan.cluster, plan.rho, plan.alpha) == (cluster, rho, alpha)
    assert plan == scd.scd_layout(m, n_pad, cluster, rho, alpha)
    assert plan.variant == f"rho in {rho}, alpha in {alpha}"
    assert plan.shared_bytes <= scd.SHARED_LIMIT
    assert plan.stage == (plan.slab if rho == "registers"
                          else min(plan.slab, scd.STAGE_ROWS))
    # the variant is taken only where the register layout fits no C
    assert all(scd.scd_layout(m, n_pad, c) is None for c in scd.CLUSTERS)


def test_scd_plan_webspam_at_eight_ctas():
    """Where 16-CTA clusters of a CTA an SM are not all resident (seven
    on an H100), webspam's rows take C = 8: a slab of 43,752 rows,
    175,008 B in shared memory beside 3 stages of 4096 rows."""
    def active(plan):
        return 7 if plan.cluster == 16 and plan.shared_bytes > 116000 else 99

    plan = scd_plan(8, WEBSPAM_M, 128, active)
    assert (plan.cluster, plan.slab, plan.rho, plan.stage, plan.ring) == \
        (8, 43752, "shared", 4096, 3)
    assert plan.shared_bytes == scd.shared_bytes(4096, 3, 128, 43752)


def test_scd_plan_takes_both_device_variants_last():
    # one CTA a worker over 60,000 rows and an alpha block of 58,000
    plan = scd_plan(1, 60000, 58000, _all_resident, cluster=1)
    assert (plan.rho, plan.alpha) == ("device", "device")
    for rho, alpha in scd.VARIANTS[:-1]:
        assert scd.scd_layout(60000, 58000, 1, rho, alpha) is None
    # rho's slab in shared memory beside a device-memory alpha
    plan = scd_plan(1, 16388, 60000, _all_resident, cluster=1)
    assert (plan.rho, plan.alpha) == ("shared", "device")


@pytest.mark.parametrize("K,m,n_pad", [(8, 16384, 4096), (8, 16384, 8192),
                                       (4, 96, 64), (8, 4096, 128)])
def test_scd_plan_unchanged_where_the_register_layout_fits(K, m, n_pad):
    plan = scd_plan(K, m, n_pad, _all_resident)
    assert (plan.rho, plan.alpha) == ("registers", "shared")
    if (K, m, n_pad) == (8, 16384, 4096):         # the main path's plan
        assert plan == ScdPlan(cluster=16, slab=1024, ring=8,
                               shared_bytes=scd.shared_bytes(1024, 8, 4096))


@pytest.mark.parametrize("bits", [8, 4, 2])
@pytest.mark.parametrize("L,variant", [(524288, "registers"),
                                       (524289, "stream"),
                                       (524291, "stream"),
                                       (1048579, "stream"),
                                       (WEBSPAM_M, "registers")])
def test_quant_plan_at_long_shapes(bits, L, variant):
    plan = quant_plan(K_ROWS, L, bits)
    per = 8 // bits
    assert plan.cluster == 16 and plan.variant == variant
    assert plan.slab == plan.span * per
    assert (plan.slab > quant.SLAB_MAX) == (variant == "stream")
    # the CTAs' byte ranges still cover the row's bytes once
    W = -(-L // per)
    assert plan.span * (plan.cluster - 1) < W <= plan.span * plan.cluster


@pytest.mark.parametrize("bits", [8, 4, 2])
def test_quant_plan_main_shape_unchanged(bits):
    assert quant_plan(8, 16384, bits) == QuantPlan(
        cluster=8, span=2048 // (8 // bits), slab=2048)


@pytest.mark.parametrize("L,k", [(131073, 16385), (131075, 16385),
                                 (WEBSPAM_M, 43750), (409601, 4097),
                                 (409603, 4097), (1000000, 1),
                                 (200003, 200003)])
def test_topk_plan_at_long_shapes(L, k):
    """The cluster forms' variants at the shapes the shared form refused
    (``grid=False``); the plan itself takes the grid form where
    ``takes_grid`` says so (webspam's row since PR 28)."""
    assert (topk_plan(K_ROWS, L, k).form == "grid") == topk.takes_grid(
        K_ROWS, L, k) == (L == WEBSPAM_M)
    plan = topk_plan(K_ROWS, L, k, grid=False)
    assert plan.survivors == "device" and plan.cluster == 16
    assert plan.patterns == ("device" if L == 1000000 else "shared")
    assert plan.variant == (f"survivors in device, patterns in "
                            f"{plan.patterns}")
    assert topk.shared_bytes(plan.slab, k, plan.cluster) > topk.SHARED_LIMIT
    assert plan.shared_bytes == topk.shared_bytes(plan.slab, k, 16, "device",
                                                  plan.patterns)
    assert plan.shared_bytes <= topk.SHARED_LIMIT
    slots = max(2, 1 << (min(plan.slab, k) - 1).bit_length())
    assert plan.scratch_words == 2 * slots + slots // 2


def test_topk_plan_webspam_row():
    """webspam's ef:topk row: k = ceil(0.125 * 350,000) = 43,750, which
    the shared form would hold in 723,456 B a CTA."""
    k = get_codec("topk(r=0.125)")._k(WEBSPAM_M)
    assert k == 43750
    assert topk.shared_bytes(21876, k, 16) == 723456
    # the cluster form's CTA: the patterns (87,504 B), a sort tile of
    # 8192 keys, 16 peers' histograms in two parities, its own two, the
    # scratch; the plan takes the grid form there (PR 28's timings)
    assert topk_plan(K_ROWS, WEBSPAM_M, k, grid=False).shared_bytes == \
        4 * 21876 + 8 * 8192 + 2 * 16 * 1024 + 2048 + 512
    assert topk_plan(K_ROWS, WEBSPAM_M, k) == topk.grid_layout(
        K_ROWS, WEBSPAM_M, k)


def test_topk_plan_main_shape_unchanged():
    assert topk_plan(8, 16384, 2048) == TopkPlan(
        cluster=8, slab=2048, shared_bytes=topk.shared_bytes(2048, 2048, 8))
    assert topk_plan(8, 16384, 16384).survivors == "shared"


def _resident_below(cluster, count):
    """A device that holds ``count`` clusters of ``cluster`` CTAs at once
    and every cluster of any other size."""
    return lambda plan: count if plan.cluster == cluster else 1 << 20


def test_topk_plan_takes_the_widest_resident_cluster():
    """webspam's ef:topk row in the cluster forms: 8 clusters of 16 CTAs
    of 188 KB do not all fit the card at once (7 do), so the plan takes
    C = 8, its slab's patterns read again from x."""
    k = get_codec("topk(r=0.125)")._k(WEBSPAM_M)
    plan = topk_plan(K_ROWS, WEBSPAM_M, k,
                     max_active_clusters=_resident_below(16, 7), grid=False)
    assert (plan.cluster, plan.survivors, plan.patterns) == (
        8, "device", "device")
    assert plan == topk_plan(K_ROWS, WEBSPAM_M, k, cluster=8)
    # all 8 resident: C = 16, as the pure plan
    assert topk_plan(K_ROWS, WEBSPAM_M, k, max_active_clusters=
                     _resident_below(16, 8), grid=False).cluster == 16


@pytest.mark.parametrize("L,k", [(16384, 2048), (16384, 16384),
                                 (WEBSPAM_M, 43750), (1000000, 1)])
def test_topk_plan_with_none_resident_takes_the_narrowest(L, k):
    plan = topk_plan(K_ROWS, L, k, max_active_clusters=lambda p: K_ROWS - 1,
                     grid=False)
    assert plan == topk_plan(K_ROWS, L, k, cluster=1)


def test_topk_plan_residency_leaves_the_main_shape_and_forced_c_alone():
    every = topk_plan(8, 16384, 2048, max_active_clusters=_all_resident)
    assert every == topk_plan(8, 16384, 2048)
    # a forced C is taken whatever the device holds
    assert topk_plan(8, 16384, 2048, 16,
                     max_active_clusters=lambda p: 0).cluster == 16


def test_topk_plan_forces_the_device_form():
    """The main path's stack in the device-memory form, which the timing
    holds against the shared form the plan takes there."""
    plan = topk_plan(8, 16384, 2048, survivors="device")
    assert (plan.cluster, plan.survivors, plan.patterns) == (
        8, "device", "shared")
    assert plan.shared_bytes == topk.shared_bytes(2048, 2048, 8, "device")
    assert plan.scratch_words == 2 * 2048 + 1024
    assert topk_plan(8, 16384, 2048, survivors="shared") == topk_plan(
        8, 16384, 2048)
    with pytest.raises(ValueError, match="723456 B"):
        topk_plan(K_ROWS, WEBSPAM_M, 43750, survivors="shared")
    with pytest.raises(ValueError, match="survivors"):
        topk_plan(8, 16384, 2048, survivors="registers")


def test_topk_select_on_cpu_takes_a_forced_form():
    x = torch.randn((3, 1001), generator=torch.Generator().manual_seed(0))
    got = topk.topk_select(x, 126, survivors="device")
    want = topk.topk_select_ref(x, 126)
    assert all(a.equal(b) for a, b in zip(got, want))


def test_codecs_on_cpu_take_a_forced_grid_form():
    """grid=True on a CPU tensor is the plain version, as every forced
    form is; no kernel is counted."""
    g = torch.Generator().manual_seed(1)
    x = torch.randn((3, 1001), generator=g)
    x[1] = torch.randint(-3, 4, (1001,), generator=g).float()
    x[2] = 0.0
    before = topk.topk_select.launches
    got = topk.topk_select(x, 126, grid=True)
    assert all(a.equal(b) for a, b in zip(got, topk.topk_select_ref(x, 126)))
    assert topk.topk_select.launches == before
    for name in ("int8", "int4", "int2"):
        enc = getattr(quant, f"quantize_pack_{name}")
        before = enc.launches
        got = enc(x, grid=True)
        want = getattr(quant, f"quantize_pack_{name}_ref")(x)
        assert all(a.equal(b) for a, b in zip(got, want))
        assert enc.launches == before


@pytest.mark.parametrize("K,L", [(4, 22 * 2048 * 5632), (1, 22 * 2048 * 5632),
                                 (4, 2**21)])
def test_topk_plan_at_the_leaf_rows_takes_the_grid_form(K, L):
    """tinyllama's leaf under virtual_round and at one rank, and the
    first length of the grid rule: the grid form, whatever the
    residency of clusters."""
    k = get_codec("topk(r=0.01)")._k(L)
    plan = topk_plan(K, L, k, max_active_clusters=lambda p: 0)
    assert plan == topk.grid_layout(K, L, k)
    assert plan.survivors == plan.patterns == "device"


# -- the CPU path at L = 350,000 against the reference -------------------------

def _rows(kind, K, L, seed):
    rng = np.random.default_rng(seed)
    if kind == "single":                 # one nonzero a row
        x = np.zeros((K, L), np.float32)
        x[np.arange(K), rng.integers(0, L, K)] = -1.7
        return x
    if kind == "ties":                   # integers in [-3, 3]
        return rng.integers(-3, 4, (K, L)).astype(np.float32)
    return rng.standard_normal((K, L)).astype(np.float32)


@pytest.mark.parametrize("name", ["int8", "int4", "int2"])
@pytest.mark.parametrize("kind", ["normal", "single"])
def test_quant_codec_long_rows_bit_identical(name, kind):
    L = WEBSPAM_M
    xs = _rows(kind, K_ROWS, L, seed=len(name) + len(kind))
    ref = get_codec_ref(name)
    parts_r = [ref.encode_ref(jnp.asarray(x)) for x in xs]
    p_r = np.stack([np.asarray(p) for p, _ in parts_r])
    s_r = np.stack([np.asarray(s) for _, s in parts_r])
    p, s = get_codec(name).encode(torch.tensor(xs))
    np.testing.assert_array_equal(p.numpy(), p_r)
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(s_r))
    dec = getattr(dequant, f"decode_reduce_{name}")
    for mean in (False, True):
        got = dec(p, s, L, mean=mean)
        want = decode_ref(name, (jnp.asarray(p_r), jnp.asarray(s_r)), L,
                          mean=mean)
        assert got.shape == (L,)
        np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_topk_codec_long_rows_bit_identical(kind):
    L, name = WEBSPAM_M, "topk(r=0.125)"
    xs = _rows(kind, K_ROWS, L, seed=3 + len(kind))
    ref, codec = get_codec_ref(name), get_codec(name)
    parts_r = [ref.encode_ref(jnp.asarray(x)) for x in xs]
    want = tuple(np.stack([np.asarray(p[i]) for p in parts_r])
                 for i in range(3))
    got = codec.encode(torch.tensor(xs))
    assert got[0].shape == (K_ROWS, 43750)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    total = codec.decode_stacked_sum(got, L)
    np.testing.assert_array_equal(
        _bits(total.numpy()), _bits(ref.decode_stacked_sum(want, L)))
    mean = codec.decode_stacked_mean(got, L)
    np.testing.assert_array_equal(
        _bits(mean.numpy()), _bits(ref.decode_stacked_mean(want, L)))


@pytest.mark.parametrize("eta", [0.5, 1.0])
def test_scd_long_rows_match_reference(eta):
    """scd_steps (and scd_solve, which takes it on the CPU) at m = 350,000,
    n_pad 16, H 8 against the reference's SCD, worker by worker."""
    K, m, n, H = 2, WEBSPAM_M, 16, 8
    rng = np.random.default_rng(16)
    A = rng.standard_normal((K, n, m)).astype(np.float32)
    A[:, -1] = 0.0                                   # a zero column
    colsq = np.sum(A * A, axis=2)
    alpha = (rng.standard_normal((K, n)) * 0.1).astype(np.float32)
    w = rng.standard_normal(m).astype(np.float32)
    idx = rng.integers(0, n, (K, H)).astype(np.int32)
    idx[0, :3] = [n - 1, 2, 2]                       # zero column, repeat
    args = [torch.tensor(x) for x in (A, colsq, alpha, w, idx)]
    kw = dict(sigma=float(K), lam=1.0, eta=eta)
    dv, a = scd_steps(*args, **kw)
    dv_s, a_s = scd_solve(*args, **kw)
    assert dv_s.equal(dv) and a_s.equal(a)
    for k in range(K):
        dv_r, a_r = scd_steps_ref(jnp.asarray(A[k].T), jnp.asarray(colsq[k]),
                                  jnp.asarray(alpha[k]), jnp.asarray(w),
                                  jnp.asarray(idx[k]), **kw)
        np.testing.assert_allclose(dv[k].numpy(), np.asarray(dv_r),
                                   rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(a[k].numpy(), np.asarray(a_r),
                                   rtol=1e-4, atol=1e-5)
    assert a[0, n - 1] == alpha[0, n - 1]            # zero column: no-op
