"""The port's CUDA kernels against their plain PyTorch versions on the
card. Every test here needs a CUDA device and the CUDA toolkit; without
a card each one skips (the ``cuda`` fixture decides, so that every
pytest-xdist worker collects the same tests). Run on the card:

    python -m pytest -m gpu tests/test_torch_gpu.py
"""
import ctypes

import numpy as np
import pytest
import torch

from repro_torch.comm.codec import get_codec
from repro_torch.core.solvers import scd_steps
from repro_torch.kernels import dequant, quant
from repro_torch.kernels.dequant import decode_reduce_int8, decode_reduce_int8_ref
from repro_torch.kernels.quant import quantize_pack_int8, quantize_pack_int8_ref
from repro_torch.kernels import _build, scd, topk
from repro_torch.kernels.scd import scd_solve
from repro_torch.kernels.topk import topk_select, topk_select_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _bits(t):
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _scd_inputs(K, m, n, H, seed, dev):
    rng = np.random.default_rng(seed)
    A_T = torch.tensor(rng.standard_normal((K, n, m)), dtype=torch.float32)
    A_T[:, -1] = 0.0                                    # a zero column
    col_sq = torch.sum(A_T * A_T, dim=2)
    alpha = torch.tensor(rng.standard_normal((K, n)) * 0.1, dtype=torch.float32)
    w = torch.tensor(rng.standard_normal(m), dtype=torch.float32)
    idx = torch.tensor(rng.integers(0, n, (K, H)), dtype=torch.int32)
    return [t.to(dev) for t in (A_T, col_sq, alpha, w, idx)]


def _fits(args, cluster):
    """Whether K1 takes ``cluster`` CTAs a worker for these inputs on this
    card (shared memory and residency of all K clusters)."""
    K, n_pad, m = args[0].shape
    try:
        scd.scd_plan(K, m, n_pad,
                     lambda p: scd.max_active_clusters(args[0].device, p),
                     cluster=cluster)
    except ValueError:
        return False
    return True


def _check_scd(args, kw, cluster, tol=dict(rtol=1e-4, atol=1e-5)):
    """K1 with ``cluster`` CTAs a worker against the plain version, or,
    where that cluster does not fit, a ValueError and no launch."""
    before = scd_solve.launches
    if not _fits(args, cluster):
        with pytest.raises(ValueError, match="no cluster size fits"):
            scd_solve(*args, cluster=cluster, **kw)
        assert scd_solve.launches == before
        return None
    dv_k, a_k = scd_solve(*args, cluster=cluster, **kw)
    torch.cuda.synchronize()
    assert scd_solve.launches == before + 1
    dv_p, a_p = scd_steps(*args, **kw)
    torch.testing.assert_close(dv_k, dv_p, **tol)
    torch.testing.assert_close(a_k, a_p, **tol)
    return dv_k, a_k


CLUSTERS = [None, *scd.CLUSTERS]


@pytest.mark.parametrize("K,m,n,H", [
    (1, 33, 5, 1), (4, 96, 64, 64), (3, 1025, 17, 200), (8, 4096, 128, 512),
    (2, 20000, 40, 50),
])
@pytest.mark.parametrize("eta", [0.3, 1.0])
@pytest.mark.parametrize("cluster", CLUSTERS)
def test_scd_kernel_matches_plain(cuda, K, m, n, H, eta, cluster):
    args = _scd_inputs(K, m, n, H, seed=m + n + H, dev=cuda)
    _check_scd(args, dict(sigma=float(K), lam=1.0, eta=eta), cluster)


@pytest.mark.parametrize("H", [1, 2, 3, 9, 17])
@pytest.mark.parametrize("cluster", [2, 16])
def test_scd_kernel_short_streams_wrap_the_ring(cuda, H, cluster):
    """H below, at and past the ring depth (the stages' barrier phases
    flip every P steps), on 16-byte and 4-byte copies."""
    for m in (64, 67):
        args = _scd_inputs(2, m, 8, H, seed=H + m, dev=cuda)
        _check_scd(args, dict(sigma=2.0, lam=1.0, eta=0.5), cluster)


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_scd_kernel_beyond_one_block(cuda, cluster):
    """m = 60000 was refused while rho had to fit one CTA; the slabs of a
    cluster hold it now."""
    args = _scd_inputs(2, 60000, 8, 40, seed=11, dev=cuda)
    out = _check_scd(args, dict(sigma=2.0, lam=1.0, eta=1.0), cluster)
    if cluster is None:
        assert out is not None and scd_solve.last_plan.cluster > 1


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_scd_kernel_repeated_index_and_zero_column(cuda, cluster):
    A_T, col_sq, alpha, w, _ = _scd_inputs(2, 64, 8, 1, seed=2, dev=cuda)
    kw = dict(sigma=2.0, lam=0.5, eta=0.8)
    tol = dict(rtol=1e-5, atol=1e-6)
    # one index over and over, alternating pairs, and a mix, all inside
    # the ring window; 7 is the zero column
    for row in ([3, 3, 7, 3, 7, 7], [3] * 20, [3, 5] * 10, [7, 3] * 9):
        idx = torch.tensor([row] * 2, dtype=torch.int32, device=cuda)
        out = _check_scd((A_T, col_sq, alpha, w, idx), kw, cluster, tol)
        if out is not None:
            assert out[1][:, 7].equal(alpha[:, 7])   # zero column: no-op


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_scd_kernel_unaligned_columns(cuda, cluster):
    """A_T 4 bytes off a 16-byte boundary with m a multiple of 4: the
    slabs take the 4-byte copies."""
    A_T, col_sq, alpha, w, idx = _scd_inputs(3, 1024, 16, 100, seed=4,
                                             dev=cuda)
    buf = torch.empty(A_T.numel() + 1, device=cuda)
    shifted = buf[1:].view(A_T.shape)
    shifted.copy_(A_T)
    assert shifted.data_ptr() % 16 == 4
    _check_scd((shifted, col_sq, alpha, w, idx),
               dict(sigma=3.0, lam=1.0, eta=0.7), cluster)


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_scd_kernel_two_launches_bit_identical(cuda, cluster):
    args = _scd_inputs(8, 4096, 128, 512, seed=9, dev=cuda)
    kw = dict(sigma=8.0, lam=1.0, eta=1.0)
    if not _fits(args, cluster):
        pytest.skip(f"{cluster} CTAs a worker do not fit on this card")
    dv1, a1 = scd_solve(*args, cluster=cluster, **kw)
    dv2, a2 = scd_solve(*args, cluster=cluster, **kw)
    assert _bits(dv1).equal(_bits(dv2)) and _bits(a1).equal(_bits(a2))


def test_scd_kernel_main_path_shape_plans_the_largest_cluster(cuda):
    """At K = 8, m = 16384, n_pad = 4096 the plan is the largest C whose
    eight clusters are all resident."""
    want = next(c for c in scd.CLUSTERS if scd.max_active_clusters(
        cuda, scd.scd_layout(16384, 4096, c)) >= 8)
    plan = scd.scd_plan(8, 16384, 4096,
                        lambda p: scd.max_active_clusters(cuda, p))
    assert plan.cluster == want and plan.ring == scd.RING_MAX


def test_scd_kernel_refuses_what_it_cannot_take(cuda):
    A_T, col_sq, alpha, w, idx = _scd_inputs(1, 64, 8, 4, seed=3, dev=cuda)
    kw = dict(sigma=1.0, lam=1.0, eta=1.0)
    with pytest.raises(TypeError):
        scd_solve(A_T, col_sq, alpha, w, idx.long(), **kw)
    strided_w = torch.zeros(128, device=cuda)[::2]      # (64,), stride 2
    with pytest.raises(ValueError, match="contiguous"):
        scd_solve(A_T, col_sq, alpha, strided_w, idx, **kw)
    # alpha past shared memory and slabs past the registers run now (the
    # device-memory variants); what is left is residency: more workers
    # than the card holds clusters of any size and variant at once
    before = scd_solve.launches
    K_big = 4096
    with pytest.raises(ValueError, match=f"clusters resident, {K_big} "
                                         f"needed"):
        scd_solve(torch.zeros((K_big, 8, 64), device=cuda),
                  torch.zeros((K_big, 8), device=cuda),
                  torch.zeros((K_big, 8), device=cuda), w,
                  torch.zeros((K_big, 4), dtype=torch.int32, device=cuda),
                  **kw)
    assert scd_solve.launches == before


def test_scd_launch_refuses_a_plan_it_does_not_reproduce(cuda):
    """The C side recomputes the shared bytes and the slab from the same
    inputs and refuses a launch whose plan disagrees."""
    A_T, col_sq, alpha, w, idx = _scd_inputs(1, 64, 8, 4, seed=3, dev=cuda)
    out = torch.empty((1, 64), device=cuda)
    plan = scd.scd_layout(64, 8, 2)
    fn = _build.function("scd_launch", scd._LAUNCH)
    ptrs = [t.data_ptr() for t in (A_T, col_sq, alpha, w, idx, out, out)]
    priv = torch.empty((2, 8), device=cuda)
    # shared bytes, slab, a stage other than the slab (rho in registers),
    # rho streamed with a stage past its slab, alpha in device memory
    # with the shared bytes of alpha in shared memory
    for slab, stage, rho_dev, alpha_priv, smem in (
            (plan.slab, plan.slab, 0, None, plan.shared_bytes + 8),
            (plan.slab + 4, plan.slab + 4, 0, None, plan.shared_bytes),
            (plan.slab, plan.slab - 4, 0, None, plan.shared_bytes),
            (plan.slab, scd.STAGE_ROWS, 2, None, plan.shared_bytes),
            (plan.slab, plan.slab, 0, priv.data_ptr(), plan.shared_bytes)):
        err = fn(*ptrs, alpha_priv, 1, 8, 64, 4, 2, slab, stage, plan.ring,
                 rho_dev, smem, 1.0, 1.0, 0.0, _build.stream_ptr(cuda))
        with pytest.raises(RuntimeError, match="scd_launch"):
            _build.check_launch(err, "scd_launch")


@pytest.mark.parametrize("shape", [(8, 16384), (3, 1), (5, 1001), (1, 128),
                                   (1001,)])
@pytest.mark.parametrize("scale", [1e-6, 1.0, 1e6])
def test_quant_kernel_bit_identical(cuda, shape, scale):
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, device=cuda) * scale
    qk, sk = quantize_pack_int8(x)
    qp, sp = quantize_pack_int8_ref(x)
    assert qk.equal(qp) and _bits(sk).equal(_bits(sp))


def test_quant_kernel_zero_and_single_element_rows(cuda):
    x = torch.zeros((3, 257), device=cuda)
    x[1, 100] = -3.0
    qk, sk = quantize_pack_int8(x)
    qp, sp = quantize_pack_int8_ref(x)
    assert qk.equal(qp) and _bits(sk).equal(_bits(sp))
    assert sk[0].item() == 1.0 and qk[1, 100].item() == -127


@pytest.mark.parametrize("K,L", [(1, 1), (3, 1001), (4, 128), (8, 16384)])
@pytest.mark.parametrize("mean", [False, True])
def test_dequant_kernel_bit_identical(cuda, K, L, mean):
    g = torch.Generator(device=cuda).manual_seed(K * L)
    q, s = quantize_pack_int8(torch.randn((K, L), generator=g, device=cuda))
    out_k = decode_reduce_int8(q, s, L, mean=mean)
    out_p = decode_reduce_int8_ref(q, s, L, mean=mean)
    assert _bits(out_k).equal(_bits(out_p))


LOWBIT_SHAPES = [(8, 16384), (3, 1), (2, 2), (1, 3), (4, 4), (5, 5),
                 (5, 1001), (2, 4097), (1001,)]


@pytest.mark.parametrize("name", ["int4", "int2"])
@pytest.mark.parametrize("shape", LOWBIT_SHAPES)
@pytest.mark.parametrize("scale", [1e-6, 1.0, 1e6])
def test_lowbit_quant_kernel_bit_identical(cuda, name, shape, scale):
    g = torch.Generator(device=cuda).manual_seed(sum(shape))
    x = torch.randn(shape, generator=g, device=cuda) * scale
    pk, sk = getattr(quant, f"quantize_pack_{name}")(x)
    pp, sp = getattr(quant, f"quantize_pack_{name}_ref")(x)
    assert pk.dtype == torch.uint8 and pk.equal(pp)
    assert _bits(sk).equal(_bits(sp))


@pytest.mark.parametrize("name", ["int4", "int2"])
def test_lowbit_quant_kernel_zero_and_single_element_rows(cuda, name):
    x = torch.zeros((3, 257), device=cuda)
    x[1, 200] = 3.0                  # in the upper half / last quarter
    pk, sk = getattr(quant, f"quantize_pack_{name}")(x)
    pp, sp = getattr(quant, f"quantize_pack_{name}_ref")(x)
    assert pk.equal(pp) and _bits(sk).equal(_bits(sp))
    assert sk[0].item() == 1.0
    # the biased zero code (8 or 2) in every slot but the one nonzero
    # element's, the pad included
    zero = 0x88 if name == "int4" else 0xAA
    assert bool((pk[0] == zero).all())
    assert int((pk[1] != zero).sum()) == 1


@pytest.mark.parametrize("name", ["int4", "int2"])
@pytest.mark.parametrize("K,L", [(1, 1), (3, 2), (2, 3), (4, 5), (3, 1001),
                                 (8, 4097), (8, 16384)])
@pytest.mark.parametrize("mean", [False, True])
def test_lowbit_dequant_kernel_bit_identical(cuda, name, K, L, mean):
    g = torch.Generator(device=cuda).manual_seed(K * L)
    x = torch.randn((K, L), generator=g, device=cuda)
    p, s = getattr(quant, f"quantize_pack_{name}")(x)
    out_k = getattr(dequant, f"decode_reduce_{name}")(p, s, L, mean=mean)
    out_p = getattr(dequant, f"decode_reduce_{name}_ref")(p, s, L, mean=mean)
    assert out_k.shape == (L,) and _bits(out_k).equal(_bits(out_p))


@pytest.mark.parametrize("name", ["ef:int4", "ef:int2"])
def test_ef_encode_with_state_card_matches_cpu(cuda, name):
    """Kernels K2/K3 and the eager residual on the card against the CPU
    plain path, bit for bit, over three chained rounds."""
    codec = get_codec(name)
    rng = np.random.default_rng(5)
    K, L = 8, 4097
    st_c, st_g = torch.zeros((K, L)), torch.zeros((K, L), device=cuda)
    for _ in range(3):
        dv = torch.tensor(rng.standard_normal((K, L)), dtype=torch.float32)
        (p_c, s_c), st_c = codec.encode_with_state(dv, st_c)
        (p_g, s_g), st_g = codec.encode_with_state(dv.to(cuda), st_g)
        assert p_g.cpu().equal(p_c) and _bits(s_g.cpu()).equal(_bits(s_c))
        assert _bits(st_g.cpu()).equal(_bits(st_c))
        tot_c = codec.decode_stacked_sum((p_c, s_c), L)
        tot_g = codec.decode_stacked_sum((p_g, s_g), L)
        assert _bits(tot_g.cpu()).equal(_bits(tot_c))


def test_wrappers_count_only_kernel_launches(cuda):
    x = torch.randn((2, 64), device=cuda)
    wrappers = [(getattr(quant, f"quantize_pack_{n}"),
                 getattr(dequant, f"decode_reduce_{n}"))
                for n in ("int8", "int4", "int2")]
    before = [(q.launches, d.launches) for q, d in wrappers]
    for enc, dec in wrappers:
        p, s = enc(x)
        dec(p, s, 64)
        p_cpu, s_cpu = enc(x.cpu())                      # plain versions
        dec(p_cpu, s_cpu, 64)
    assert [(q.launches, d.launches) for q, d in wrappers] == [
        (q + 1, d + 1) for q, d in before]


def _topk_row(kind, L, g, dev):
    if kind == "zeros":
        return torch.zeros(L, device=dev)
    if kind == "single":
        x = torch.zeros(L, device=dev)
        x[L // 2] = -1.7
        return x
    if kind == "ties":          # integers in [-3, 3]: +x and -x of one magnitude
        return torch.randint(-3, 4, (L,), generator=g, device=dev).float()
    if kind == "negzero":       # -0.0 and +0.0, a nonzero every 7th entry
        x = torch.where(torch.rand(L, generator=g, device=dev) < 0.5,
                        torch.tensor(-0.0, device=dev),
                        torch.tensor(0.0, device=dev))
        x[::7] = torch.randn(x[::7].shape, generator=g, device=dev)
        return x
    return torch.randn(L, generator=g, device=dev)


def _assert_topk_equal(got, want):
    for a, b in zip(got, want):
        assert a.shape == b.shape and _bits(a).equal(_bits(b))


@pytest.mark.parametrize("L", [1, 2, 3, 127, 128, 129, 1001, 4097])
@pytest.mark.parametrize("kind", ["normal", "zeros", "single", "ties",
                                  "negzero"])
def test_topk_kernel_bit_identical(cuda, L, kind):
    g = torch.Generator(device=cuda).manual_seed(L)
    x = torch.stack([_topk_row(kind, L, g, cuda) for _ in range(3)])
    for k in sorted({1, -(-L // 8), L}):
        _assert_topk_equal(topk_select(x, k), topk_select_ref(x, k))
        _assert_topk_equal(topk_select(x[0], k), topk_select_ref(x[0], k))


@pytest.mark.parametrize("r", [0.01, 0.125, 1.0])
def test_topk_kernel_bit_identical_at_the_main_path_shape(cuda, r):
    g = torch.Generator(device=cuda).manual_seed(7)
    x = torch.randn((8, 16384), generator=g, device=cuda) * 1e-3
    k = get_codec(f"topk(r={r})")._k(16384)
    _assert_topk_equal(topk_select(x, k), topk_select_ref(x, k))


def test_topk_kernel_all_zero_rows_take_the_first_indices(cuda):
    vals, idx, thr = topk_select(torch.zeros((4, 1001), device=cuda), 126)
    assert idx.equal(torch.arange(126, device=cuda, dtype=torch.int32)
                     .expand(4, 126))
    assert bool((thr == 0).all()) and bool((vals == 0).all())


def test_topk_kernel_refuses_what_it_cannot_take(cuda):
    x = torch.randn((2, 64), device=cuda)
    with pytest.raises(TypeError):
        topk_select(x.double(), 4)
    with pytest.raises(ValueError, match="contiguous"):
        topk_select(torch.randn((64, 2), device=cuda).t(), 4)
    with pytest.raises(ValueError, match="1 <= k <= L"):
        topk_select(x, 65)
    # rows that need more than 227 KB a CTA run now in the device-memory
    # form (a row of 10^6 at k = 1, 20000 keeping all 20000 at C = 1);
    # what is left is the kernel's int32 row index
    before = topk_select.launches
    with pytest.raises(ValueError, match="int32"):
        topk_select(torch.empty((1, topk.INDEX_MAX + 1), device=cuda), 1)
    assert topk_select.launches == before


def test_topk_launch_failure_raises(cuda):
    """A launch the runtime refuses (here zero rows) comes back as a
    RuntimeError, not as a silent no-op."""
    fn = _build.function("topk_launch", topk._LAUNCH)
    out = torch.empty(4, device=cuda)
    scratch = torch.empty(8, dtype=torch.int64, device=cuda)
    plan = topk.topk_plan(1, 4, 1)
    ptrs = [out.data_ptr()] * 4
    # zero rows, then a plan the C side does not reproduce (slab, bytes;
    # the device form with the shared form's bytes)
    for K, slab, smem, scr in (
            (0, plan.slab, plan.shared_bytes, None),
            (1, plan.slab + 4, plan.shared_bytes, None),
            (1, plan.slab, plan.shared_bytes + 16, None),
            (1, plan.slab, plan.shared_bytes, scratch.data_ptr())):
        err = fn(*ptrs, K, 4, 1, plan.cluster, slab, smem, scr, 0,
                 _build.stream_ptr(cuda))
        with pytest.raises(RuntimeError, match="topk_launch"):
            _build.check_launch(err, "topk_launch")


def test_build_failure_raises(cuda, tmp_path, monkeypatch):
    (tmp_path / "broken.cu").write_text("this is not CUDA C++\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc failed"):
        _build.build()


def test_topk_kernel_counts_one_launch_per_stack(cuda):
    x = torch.randn((8, 4097), device=cuda)
    before = topk_select.launches
    topk_select(x, 513)
    topk_select(x.cpu(), 513)                            # the plain version
    get_codec("topk(r=0.125)").encode(x)
    get_codec("topk(r=0.125)").encode_ref(x)             # plain, on the card
    assert topk_select.launches == before + 2


def test_ef_topk_encode_with_state_card_matches_cpu(cuda):
    """K4 and the eager residual and decode on the card against the CPU
    plain path, bit for bit, over three chained rounds."""
    codec = get_codec("ef:topk(r=0.125)")
    rng = np.random.default_rng(6)
    K, L = 8, 4097
    st_c, st_g = torch.zeros((K, L)), torch.zeros((K, L), device=cuda)
    for _ in range(3):
        dv = torch.tensor(rng.standard_normal((K, L)), dtype=torch.float32)
        p_c, st_c = codec.encode_with_state(dv, st_c)
        p_g, st_g = codec.encode_with_state(dv.to(cuda), st_g)
        _assert_topk_equal([t.cpu() for t in p_g], p_c)
        assert _bits(st_g.cpu()).equal(_bits(st_c))
        for reduce in (codec.decode_stacked_sum, codec.decode_stacked_mean):
            assert _bits(reduce(p_g, L).cpu()).equal(_bits(reduce(p_c, L)))


# -- K2 and K4 as clusters of C CTAs a row ---------------------------------

CODEC_CLUSTERS = [None, 16, 8, 4, 2, 1]
WIDTHS = {"int8": 8, "int4": 4, "int2": 2}


def _quant_lengths(cluster):
    """Lengths that straddle the CTAs' byte ranges (C*s +- 1 at the span
    s the plan gives), leave some CTAs of a 16-cluster empty (1, 2, 3, 5),
    are odd or not a multiple of 4, and the main path's 16384."""
    c = cluster or 16
    return sorted({1, 2, 3, 5, 7, 6, 10, 4 * c - 1, 4 * c + 1,
                   1024 * c - 1, 1024 * c, 1024 * c + 1, 4097, 16384})


@pytest.mark.parametrize("name", list(WIDTHS))
@pytest.mark.parametrize("cluster", CODEC_CLUSTERS)
def test_quant_cluster_kernel_bit_identical(cuda, name, cluster):
    enc = getattr(quant, f"quantize_pack_{name}")
    ref = getattr(quant, f"quantize_pack_{name}_ref")
    for L in _quant_lengths(cluster):
        g = torch.Generator(device=cuda).manual_seed(L)
        x = torch.randn((3, L), generator=g, device=cuda)
        x[1] *= 1e-6
        x[2, :] = 0.0                                   # an all-zero row
        x[2, L // 2] = -2.5                             # one nonzero
        before = enc.launches
        pk, sk = enc(x, cluster=cluster)
        assert enc.launches == before + 1
        pp, sp = ref(x)
        assert pk.dtype == pp.dtype and pk.equal(pp), (L, cluster)
        assert _bits(sk).equal(_bits(sp)), (L, cluster)


@pytest.mark.parametrize("name", list(WIDTHS))
@pytest.mark.parametrize("cluster", CODEC_CLUSTERS)
def test_quant_cluster_kernel_unaligned_rows(cuda, name, cluster):
    """x 4 bytes off a 16-byte boundary: the element-by-element loads."""
    enc = getattr(quant, f"quantize_pack_{name}")
    buf = torch.randn(2 * 4096 + 1, device=cuda)
    x = buf[1:].view(2, 4096)
    assert x.data_ptr() % 16 == 4
    pk, sk = enc(x, cluster=cluster)
    pp, sp = getattr(quant, f"quantize_pack_{name}_ref")(x)
    assert pk.equal(pp) and _bits(sk).equal(_bits(sp))


@pytest.mark.parametrize("name", list(WIDTHS))
def test_quant_cluster_kernel_main_shape_plans_a_cluster(cuda, name):
    plan = quant.quant_plan(8, 16384, WIDTHS[name])
    assert plan.cluster > 1
    x = torch.randn((8, 16384), device=cuda)
    enc = getattr(quant, f"quantize_pack_{name}")
    first, second = enc(x), enc(x)                  # two launches
    assert first[0].equal(second[0])
    assert _bits(first[1]).equal(_bits(second[1]))


@pytest.mark.parametrize("name", list(WIDTHS))
def test_quant_cluster_kernel_refuses_a_row_over_its_registers(cuda, name):
    """A row over the registers of 16 CTAs (or of one) streams now; what
    is refused is a row past the kernel's int32 index."""
    enc = getattr(quant, f"quantize_pack_{name}")
    ref = getattr(quant, f"quantize_pack_{name}_ref")
    g = torch.Generator(device=cuda).manual_seed(5)
    for L, cluster in ((16 * quant.SLAB_MAX + 1, None),
                       (quant.SLAB_MAX + 4, 1)):
        x = torch.randn((1, L), generator=g, device=cuda)
        assert quant.quant_plan(1, L, WIDTHS[name], cluster).variant == \
            "stream"
        pk, sk = enc(x, cluster=cluster)
        pp, sp = ref(x)
        assert pk.equal(pp) and _bits(sk).equal(_bits(sp))
    before = enc.launches
    with pytest.raises(ValueError, match="int32"):
        enc(torch.empty((1, quant.INDEX_MAX + 1), device=cuda))
    assert enc.launches == before


def _topk_check(x, k, cluster):
    """K4 at ``cluster`` against the plain version, or, where that cluster
    does not fit, a ValueError and no launch."""
    before = topk_select.launches
    try:
        topk.topk_plan(1, x.shape[-1], k, cluster)
    except ValueError:
        with pytest.raises(ValueError, match="shared memory"):
            topk_select(x, k, cluster=cluster)
        assert topk_select.launches == before
        return
    got = topk_select(x, k, cluster=cluster)
    assert topk_select.launches == before + 1
    _assert_topk_equal(got, topk_select_ref(x, k))


@pytest.mark.parametrize("cluster", CODEC_CLUSTERS)
@pytest.mark.parametrize("kind", ["normal", "zeros", "equal", "pm",
                                  "ties", "negzero"])
def test_topk_cluster_kernel_bit_identical(cuda, cluster, kind):
    """Lengths that straddle the slabs (C*s +- 1) and leave CTAs empty
    (1, 2, 3, 5); rows whose ties straddle the CTAs (all equal, all
    zero, +x/-x pairs, integers in [-3, 3]) and -0.0 entries; k in
    {1, ceil(L/8), L}."""
    c = cluster or 16
    for L in sorted({1, 2, 3, 5, 4 * c - 1, 4 * c + 1, 1024 * c - 1,
                     1024 * c + 1, 4097}):
        g = torch.Generator(device=cuda).manual_seed(L)
        if kind == "equal":
            x = torch.full((2, L), 1.5, device=cuda)
        elif kind == "pm":             # +1.5 and -1.5 alternating
            x = torch.full((2, L), 1.5, device=cuda)
            x[:, 1::2] = -1.5
        else:
            x = torch.stack([_topk_row(kind, L, g, cuda) for _ in range(2)])
        for k in sorted({1, -(-L // 8), L}):
            _topk_check(x, k, cluster)


@pytest.mark.parametrize("cluster", CODEC_CLUSTERS)
def test_topk_cluster_kernel_zero_rows_take_the_first_indices(cuda, cluster):
    x = torch.zeros((3, 4097), device=cuda)
    for k in (1, 513, 4097):
        vals, idx, thr = topk_select(x, k, cluster=cluster)
        assert idx.equal(torch.arange(k, device=cuda, dtype=torch.int32)
                         .expand(3, k))
        assert bool((thr == 0).all()) and bool((vals == 0).all())


@pytest.mark.parametrize("cluster", CODEC_CLUSTERS)
def test_topk_cluster_kernel_beyond_one_block(cuda, cluster):
    """L = 60000 was refused while a row had to fit one CTA's shared
    memory; the slabs of a cluster hold it now."""
    g = torch.Generator(device=cuda).manual_seed(60000)
    x = torch.randn((2, 60000), generator=g, device=cuda)
    x[1] = torch.randint(-3, 4, (60000,), generator=g, device=cuda).float()
    for k in (1, 7500, 60000):
        _topk_check(x, k, cluster)
    assert topk.topk_plan(2, 60000, 7500).cluster == 16


@pytest.mark.parametrize("cluster", CODEC_CLUSTERS)
def test_topk_cluster_kernel_two_launches_bit_identical(cuda, cluster):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn((8, 16384), generator=g, device=cuda)
    for k in (2048, 16384):
        try:
            topk.topk_plan(8, 16384, k, cluster)
        except ValueError:
            continue
        first = topk_select(x, k, cluster=cluster)
        second = topk_select(x, k, cluster=cluster)
        _assert_topk_equal(first, second)
        _assert_topk_equal(first, topk_select_ref(x, k))


def test_topk_cluster_kernel_main_shape_plans_a_cluster(cuda):
    plan = topk.topk_plan(8, 16384, 2048)
    assert plan.cluster > 1
    x = torch.randn((8, 16384), device=cuda)
    before = topk_select.launches
    topk_select(x, 2048)
    assert topk_select.launches == before + 1
    assert topk.topk_plan(8, 1001, 126).cluster == 1


@pytest.mark.parametrize("cluster", CODEC_CLUSTERS)
def test_cluster_kernels_count_one_launch_per_stack(cuda, cluster):
    x = torch.randn((8, 4097), device=cuda)
    wrappers = [getattr(quant, f"quantize_pack_{n}") for n in WIDTHS]
    before = [w.launches for w in wrappers] + [topk_select.launches]
    for w in wrappers:
        w(x, cluster=cluster)
        w(x.cpu(), cluster=cluster)                      # plain versions
    topk_select(x, 513, cluster=cluster)
    topk_select(x.cpu(), 513, cluster=cluster)
    after = [w.launches for w in wrappers] + [topk_select.launches]
    assert after == [n + 1 for n in before]


# -- long rows: the device-memory variants of K1, K2 and K4 ----------------

def _scd_inputs_on_card(K, m, n, H, seed, dev):
    """``_scd_inputs`` made on the card, for shapes whose host copy would
    take long to make: the same kinds of values, a torch generator."""
    g = torch.Generator(device=dev).manual_seed(seed)
    A_T = torch.randn((K, n, m), generator=g, device=dev)
    A_T[:, -1] = 0.0                                    # a zero column
    col_sq = torch.sum(A_T * A_T, dim=2)
    alpha = torch.randn((K, n), generator=g, device=dev) * 0.1
    w = torch.randn((m,), generator=g, device=dev)
    idx = torch.randint(0, n, (K, H), generator=g, device=dev,
                        dtype=torch.int32)
    return [A_T, col_sq, alpha, w, idx]


@pytest.mark.parametrize("m", [262148, 262147])
@pytest.mark.parametrize("cluster", CLUSTERS)
def test_scd_kernel_long_rows_streamed(cuda, m, cluster):
    """m just past the 262,144 rows that 16 CTAs hold in registers:
    every C streams rho's slab, in shared memory at C = 8 and 16 and in
    device memory at C = 1, 2 and 4 (slabs past what shared memory holds
    beside two stages), with 16-byte copies at m = 262,148 and 4-byte
    ones at 262,147."""
    args = _scd_inputs_on_card(2, m, 8, 50, seed=m, dev=cuda)
    out = _check_scd(args, dict(sigma=2.0, lam=1.0, eta=0.7), cluster)
    assert out is not None
    plan = scd_solve.last_plan
    assert plan.rho == ("shared" if plan.cluster >= 8 else "device")
    assert plan.alpha == "shared"


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_scd_kernel_long_alpha_in_device_memory(cuda, cluster):
    """n_pad = 56,000 at m = 16,384: alpha past the shared memory a CTA
    has left beside the ring; each CTA keeps its own copy in device
    memory."""
    args = _scd_inputs_on_card(1, 16384, 56000, 256, seed=56, dev=cuda)
    out = _check_scd(args, dict(sigma=1.0, lam=1.0, eta=1.0), cluster)
    assert out is not None
    assert scd_solve.last_plan.alpha == "device"
    assert scd_solve.last_plan.rho == "registers"


@pytest.mark.parametrize("cluster", [None, 16, 2])
def test_scd_kernel_long_alpha_repeated_index(cuda, cluster):
    """Repeated and alternating indices inside the ring window with alpha
    in device memory: each step reads the latest alpha_j."""
    A_T, col_sq, alpha, w, _ = _scd_inputs_on_card(2, 64, 60000, 1,
                                                   seed=60, dev=cuda)
    kw = dict(sigma=2.0, lam=0.5, eta=0.8)
    zero = 60000 - 1                                    # the zero column
    for row in ([3, 3, zero, 3, zero, zero], [3] * 20, [3, 5] * 10,
                [zero, 3] * 9):
        idx = torch.tensor([row] * 2, dtype=torch.int32, device=cuda)
        out = _check_scd((A_T, col_sq, alpha, w, idx), kw, cluster,
                         dict(rtol=1e-5, atol=1e-6))
        assert scd_solve.last_plan.alpha == "device"
        assert out[1][:, zero].equal(alpha[:, zero])


@pytest.mark.parametrize("m,n,rho", [(16388, 60000, "shared"),
                                     (60000, 58000, "device")])
def test_scd_kernel_long_rows_and_alpha_in_device_memory(cuda, m, n, rho):
    """alpha in device memory beside a streamed slab: one CTA a worker
    over 16,388 rows (held in shared memory) and an alpha block of
    60,000, and over 60,000 rows (in device memory) and 58,000."""
    args = _scd_inputs_on_card(1, m, n, 32, seed=7, dev=cuda)
    _check_scd(args, dict(sigma=1.0, lam=1.0, eta=0.9), 1)
    assert (scd_solve.last_plan.rho, scd_solve.last_plan.alpha) == \
        (rho, "device")


@pytest.mark.parametrize("shape,cluster", [((2, 262148, 8, 50), None),
                                           ((2, 262148, 8, 50), 2),
                                           ((1, 16384, 56000, 64), None)])
def test_scd_kernel_long_variants_two_launches_bit_identical(cuda, shape,
                                                             cluster):
    K, m, n, H = shape
    args = _scd_inputs_on_card(K, m, n, H, seed=1, dev=cuda)
    kw = dict(sigma=float(K), lam=1.0, eta=1.0, cluster=cluster)
    dv1, a1 = scd_solve(*args, **kw)
    dv2, a2 = scd_solve(*args, **kw)
    assert scd_solve.last_plan.variant != "rho in registers, alpha in shared"
    assert _bits(dv1).equal(_bits(dv2)) and _bits(a1).equal(_bits(a2))


@pytest.mark.parametrize("name", list(WIDTHS))
@pytest.mark.parametrize("cluster", CODEC_CLUSTERS)
def test_quant_kernel_long_rows_stream(cuda, name, cluster):
    """L = 524,291, just past the 524,288 elements 16 CTAs hold in
    registers: the CTAs stream their elements twice, bit-identical; also
    4 bytes off a 16-byte boundary (element-by-element loads)."""
    enc = getattr(quant, f"quantize_pack_{name}")
    ref = getattr(quant, f"quantize_pack_{name}_ref")
    L = 524291
    g = torch.Generator(device=cuda).manual_seed(L)
    x = torch.randn((3, L), generator=g, device=cuda)
    x[1] *= 1e-6
    x[2] = 0.0
    x[2, L - 1] = -2.5                          # one nonzero, in the pad's byte
    assert quant.quant_plan(3, L, WIDTHS[name]).variant == "stream"
    pk, sk = enc(x, cluster=cluster)
    pp, sp = ref(x)
    assert pk.equal(pp) and _bits(sk).equal(_bits(sp))
    buf = torch.randn(2 * 524288 + 1, generator=g, device=cuda)
    xu = buf[1:].view(2, 524288)
    pk, sk = enc(xu, cluster=cluster)
    pp, sp = ref(xu)
    assert pk.equal(pp) and _bits(sk).equal(_bits(sp))


@pytest.mark.parametrize("name", list(WIDTHS))
def test_quant_kernel_long_rows_two_launches_bit_identical(cuda, name):
    enc = getattr(quant, f"quantize_pack_{name}")
    x = torch.randn((8, 1048579), device=cuda)
    first, second = enc(x), enc(x)
    assert first[0].equal(second[0])
    assert _bits(first[1]).equal(_bits(second[1]))


@pytest.mark.parametrize("L,k", [(131075, 16385), (409603, 4097)])
@pytest.mark.parametrize("cluster", CODEC_CLUSTERS)
@pytest.mark.parametrize("kind", ["normal", "ties", "negzero"])
def test_topk_kernel_long_rows_device_form(cuda, L, k, cluster, kind):
    """Just past what the shared form holds (L = 131,075 with k =
    16,385, and 409,603 with k = 4097): the survivors in device memory,
    and at the narrower C the patterns as well, bit-identical, at every
    C."""
    g = torch.Generator(device=cuda).manual_seed(L + k)
    x = torch.stack([_topk_row(kind, L, g, cuda) for _ in range(2)])
    plan = topk.topk_plan(2, L, k, cluster)
    if cluster is None:
        assert plan.survivors == "device"
    _topk_check(x, k, cluster)


@pytest.mark.parametrize("L,k", [(8 * 8192 + 5, 8 * 8192 + 5),
                                 (350000, 43750), (1000000, 1)])
def test_topk_kernel_long_rows_large_k(cuda, L, k):
    """A CTA with more survivors than the sort tile (the bitonic
    network over device memory, at C = 1), webspam's ef:topk row, and a
    row of 10^6 keeping one; at C = 1 the patterns are read from x."""
    g = torch.Generator(device=cuda).manual_seed(k)
    x = torch.randn((2, L), generator=g, device=cuda)
    x[1] = torch.randint(-3, 4, (L,), generator=g, device=cuda).float()
    assert topk.topk_plan(2, L, k, 1).patterns == "device"
    for cluster in (None, 1):
        _topk_check(x, k, cluster)


@pytest.mark.parametrize("L,k", [(131075, 16385), (350000, 43750)])
def test_topk_kernel_long_rows_two_launches_bit_identical(cuda, L, k):
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((8, L), generator=g, device=cuda)
    first, second = topk_select(x, k), topk_select(x, k)
    _assert_topk_equal(first, second)
    _assert_topk_equal(first, topk_select_ref(x, k))


@pytest.mark.parametrize("k", [1, 2048, 16384])
def test_topk_kernel_device_form_at_the_main_shape(cuda, k):
    """The main path's stack forced into the device-memory form (which
    the timing holds against the shared form): bit-identical, and twice
    the same."""
    g = torch.Generator(device=cuda).manual_seed(k)
    x = torch.randn((8, 16384), generator=g, device=cuda)
    x[7] = torch.randint(-3, 4, (16384,), generator=g, device=cuda).float()
    first = topk_select(x, k, survivors="device")
    assert topk_select.last_plan.survivors == "device"
    _assert_topk_equal(first, topk_select(x, k, survivors="device"))
    _assert_topk_equal(first, topk_select_ref(x, k))


@pytest.mark.parametrize("L,k", [(16384, 2048), (350000, 43750),
                                 (1000000, 1)])
def test_topk_plan_on_the_card_takes_resident_clusters(cuda, L, k):
    """The cluster forms' C is the widest whose 8 clusters the card holds
    at once (webspam's row: not C = 16 at 188 KB a CTA)."""
    x = torch.randn((8, L), device=cuda)
    topk_select(x, k, grid=False)
    plan = topk_select.last_plan
    assert topk.max_active_clusters(x.device, plan) >= 8
    for wider in topk.CLUSTERS:
        if wider <= plan.cluster:
            break
        p = topk.topk_plan(8, L, k, wider)
        if p.slab >= topk.SLAB_MIN:
            assert topk.max_active_clusters(x.device, p) < 8


# -- the grid forms of K4 and K2 (long rows) ---------------------------------

# a few million elements at most: L not a multiple of 4, one tile or a
# scalar tail alone, and rows of many pass tiles (4096 elements each)
GRID_LENGTHS = [1, 5, 4097, 1000003, 3000001]
GRID_KINDS = ["normal", "ties", "zeros", "single", "negzero"]


def _grid_stack(kind, K, L, g, dev, offset):
    """K rows of ``kind`` ("mixed": row r of ``GRID_KINDS[r % 5]``) in a
    buffer ``offset`` floats past a 16-byte boundary."""
    x = torch.empty(K * L + offset, device=dev)[offset:].view(K, L)
    for r in range(K):
        x[r] = _topk_row(GRID_KINDS[r % 5] if kind == "mixed" else kind, L,
                         g, dev)
    return x


@pytest.mark.parametrize("K", [1, 4, 8])
@pytest.mark.parametrize("kind", GRID_KINDS + ["mixed"])
@pytest.mark.parametrize("offset", [0, 1])
def test_topk_grid_form_bit_identical(cuda, K, kind, offset):
    """K4's grid form forced: integer ties in [-3, 3] across the pass
    tiles, all-zero rows and one nonzero a row (every key in one bin:
    the passes past the candidate cap read x again), -0.0 entries, k = 1,
    ceil(L/100) and L, x offset by one float; one count a stack."""
    g = torch.Generator(device=cuda).manual_seed(K * 10 + offset)
    for L in GRID_LENGTHS:
        x = _grid_stack(kind, K, L, g, cuda, offset)
        for k in sorted({1, -(-L // 100), L}):
            before = topk_select.launches
            got = topk_select(x, k, grid=True)
            assert topk_select.launches == before + 1
            assert topk_select.last_plan.form == "grid"
            _assert_topk_equal(got, topk_select_ref(x, k))


def test_topk_grid_form_two_launches_bit_identical(cuda):
    g = torch.Generator(device=cuda).manual_seed(11)
    x = _grid_stack("mixed", 4, 3000001, g, cuda, 0)
    for k in (30001, 3000001):
        first = topk_select(x, k, grid=True)
        _assert_topk_equal(first, topk_select(x, k, grid=True))
        _assert_topk_equal(first, topk_select_ref(x, k))


@pytest.mark.parametrize("name", list(WIDTHS))
@pytest.mark.parametrize("K", [1, 4, 8])
@pytest.mark.parametrize("offset", [0, 1])
def test_quant_grid_form_bit_identical(cuda, name, K, offset):
    """K2's grid form forced, each width: rows at three scales, an
    all-zero row (scale 1) and one nonzero a row (in the last pad byte's
    slot), L not a multiple of 4, x offset by one float; one count a
    stack."""
    enc = getattr(quant, f"quantize_pack_{name}")
    ref = getattr(quant, f"quantize_pack_{name}_ref")
    g = torch.Generator(device=cuda).manual_seed(K + offset)
    for L in GRID_LENGTHS:
        x = _grid_stack("normal", K, L, g, cuda, offset)
        x[0] *= 1e-6
        if K > 1:
            x[1] = 0.0
        if K > 2:
            x[2] = 0.0
            x[2, L - 1] = -2.5
        if K > 3:
            x[3] *= 1e6
        before = enc.launches
        pk, sk = enc(x, grid=True)
        assert enc.launches == before + 1
        pp, sp = ref(x)
        assert pk.dtype == pp.dtype and pk.equal(pp), (L, K)
        assert _bits(sk).equal(_bits(sp)), (L, K)
        if K > 1:
            assert sk[1].item() == 1.0


@pytest.mark.parametrize("name", list(WIDTHS))
def test_quant_grid_form_nan_and_inf_rows_as_the_cluster_form(cuda, name):
    """A NaN leaves the absmax as fmaxf leaves it (the cluster form's
    rule; the plain version's amax would take the NaN), an inf makes it
    inf: the grid form's bits equal the cluster form's."""
    enc = getattr(quant, f"quantize_pack_{name}")
    g = torch.Generator(device=cuda).manual_seed(9)
    x = torch.randn((5, 1000003), generator=g, device=cuda)
    x[0, 5] = float("nan")
    x[1, 7] = float("inf")
    x[2] = float("nan")
    x[3, 9] = -float("inf")
    x[3, 10] = float("nan")
    x[4, 11] = -0.0
    grid, cl = enc(x, grid=True), enc(x, cluster=16)
    assert grid[0].equal(cl[0]) and _bits(grid[1]).equal(_bits(cl[1]))
    assert torch.isinf(grid[1][1]) and grid[1][2].item() == 1.0
    # the row with a -0.0 and no NaN or inf: the plain version's bits
    pp, sp = getattr(quant, f"quantize_pack_{name}_ref")(x[4:])
    assert grid[0][4:].equal(pp) and _bits(grid[1][4:]).equal(_bits(sp))


@pytest.mark.parametrize("name", list(WIDTHS))
def test_quant_grid_form_two_launches_bit_identical(cuda, name):
    enc = getattr(quant, f"quantize_pack_{name}")
    x = torch.randn((4, 3000001), device=cuda)
    first, second = enc(x, grid=True), enc(x, grid=True)
    assert first[0].equal(second[0])
    assert _bits(first[1]).equal(_bits(second[1]))


def test_grid_launch_failure_raises(cuda):
    """A grid plan the C side does not reproduce (CTAs a row, scratch
    bytes) is refused and raises; nothing falls back."""
    x = torch.randn((2, 5000), device=cuda)
    plan = topk.topk_plan(2, 5000, 50, grid=True)
    fn = _build.function("topk_grid_launch", topk._GRID_LAUNCH)
    out = [torch.empty((2, 50), device=cuda),
           torch.empty((2, 50), dtype=torch.int32, device=cuda),
           torch.empty((2,), device=cuda)]
    scratch = torch.empty((plan.scratch_bytes,), dtype=torch.uint8,
                          device=cuda)
    for ctas, nbytes in ((plan.ctas + 1, plan.scratch_bytes),
                         (plan.ctas, plan.scratch_bytes - 256)):
        err = fn(x.data_ptr(), *(t.data_ptr() for t in out), 2, 5000, 50,
                 ctas, scratch.data_ptr(), nbytes, _build.stream_ptr(cuda))
        with pytest.raises(RuntimeError, match="topk_grid_launch"):
            _build.check_launch(err, "topk_grid_launch")
    qp = quant.quant_plan(2, 5000, 8, grid=True)
    fn = _build.function("quant_grid_launch", quant._GRID_LAUNCH)
    pay = torch.empty((2, 5000), dtype=torch.int8, device=cuda)
    amax = torch.empty((2,), dtype=torch.int32, device=cuda)
    err = fn(x.data_ptr(), pay.data_ptr(), out[2].data_ptr(),
             amax.data_ptr(), 2, 5000, 8, qp.ctas_absmax + 1, qp.ctas_pack,
             _build.stream_ptr(cuda))
    with pytest.raises(RuntimeError, match="quant_grid_launch"):
        _build.check_launch(err, "quant_grid_launch")


def test_leaf_shapes_plan_the_grid_forms(cuda):
    """tinyllama's largest leaf at one and four rows: both kernels take
    the grid form, one count a stack."""
    L = TINYLLAMA_LARGEST
    x = torch.randn((1, L), device=cuda) * 1e-3
    before = (topk_select.launches, quantize_pack_int8.launches)
    topk_select(x, -(-L // 100))
    assert topk_select.last_plan.form == "grid"
    quantize_pack_int8(x)
    assert quant.quant_plan(1, L, 8).variant == "grid"
    assert (topk_select.launches, quantize_pack_int8.launches) == (
        before[0] + 1, before[1] + 1)


# -- K3: 16-byte groups, ragged strides ---------------------------------------

@pytest.mark.parametrize("name", list(WIDTHS))
@pytest.mark.parametrize("K", [1, 3, 8, 17])
@pytest.mark.parametrize("mean", [False, True])
def test_dequant_kernel_ragged_strides(cuda, name, K, mean):
    """Payload rows whose stride W is a multiple of the bytes a thread
    owns (one load a row), of 4 only (4-byte loads) or of neither (byte
    loads), a ragged last group, K past one group of 8 rows in flight,
    in both forms (4 outputs a thread on the short rows, 16 on the
    longest); bit-identical to the plain version."""
    per = 8 // WIDTHS[name]
    enc = getattr(quant, f"quantize_pack_{name}")
    for W in (1, 5, 16, 20, 33, 1000, 1001, 4097, 87500, 350001):
        for L in sorted({per * W, per * W - (per - 1)}):
            g = torch.Generator(device=cuda).manual_seed(K * L)
            x = torch.randn((K, L), generator=g, device=cuda)
            p, s = enc(x)
            assert p.shape == (K, W)
            out_k = getattr(dequant, f"decode_reduce_{name}")(p, s, L,
                                                              mean=mean)
            out_p = getattr(dequant, f"decode_reduce_{name}_ref")(
                p, s, L, mean=mean)
            assert _bits(out_k).equal(_bits(out_p)), (W, L)


@pytest.mark.parametrize("name", list(WIDTHS))
def test_dequant_kernel_two_launches_bit_identical(cuda, name):
    p, s = getattr(quant, f"quantize_pack_{name}")(
        torch.randn((8, 350000), device=cuda))
    dec = getattr(dequant, f"decode_reduce_{name}")
    assert _bits(dec(p, s, 350000)).equal(_bits(dec(p, s, 350000)))


# -- the baselines: mini-batch SCD's batched solve and mini-batch SGD -------

def test_fixed_point_batched_on_card_matches_loop(cuda):
    """Mini-batch SCD's batched exact solve against its step loop on the
    card, H = n_pad uniform draws (about 8-10 passes)."""
    from repro_torch.core.solvers import (scd_steps_fixed_point,
                                          scd_steps_fixed_point_batched)
    args = _scd_inputs(8, 2048, 1024, 1024, seed=17, dev=cuda)
    kw = dict(sigma=8.0, lam=1.0, eta=1.0)
    dv, a = scd_steps_fixed_point_batched(*args, **kw)
    dv_l, a_l = scd_steps_fixed_point(*args, **kw)
    idx = args[4].long()
    cnt = torch.zeros((8, 1024), dtype=torch.int32, device=cuda)
    cnt.scatter_add_(1, idx, torch.ones_like(idx, dtype=torch.int32))
    print(f"max(cnt) = {int(cnt.max())}")
    torch.testing.assert_close(dv, dv_l, rtol=1e-4, atol=1e-5)
    torch.testing.assert_close(a, a_l, rtol=1e-4, atol=1e-5)


def test_uniform_rows_on_card_are_distinct_and_repeat(cuda):
    from repro_torch.core import UniformRows
    src = UniformRows(2048, (8, 4, 205), seed=3, device=cuda)
    rows = src(1)
    assert rows.device.type == "cuda" and rows.shape == (8, 4, 205)
    assert bool((rows >= 0).all()) and bool((rows < 2048).all())
    flat = rows.reshape(-1, 205).sort(dim=1).values
    assert bool((flat[:, 1:] != flat[:, :-1]).all())
    assert torch.equal(UniformRows(2048, (8, 4, 205), 3, cuda)(1), rows)
    assert not torch.equal(src(2), rows)


@pytest.mark.parametrize("H,ex,batch_frac", [
    (1, "compressed:int8", 1.0), (4, "compressed:ef:int4", 0.5)])
def test_sgd_round_on_card_matches_cpu(cuda, H, ex, batch_frac):
    """One mini-batch SGD round (MLlib's H = 1, local SGD at H = 4) on
    the card, through K2 and K3, against the plain versions on the CPU
    on one replayed row stream."""
    from repro_torch.carry import ReplayIndices
    from repro_torch.core import MinibatchSGD, SGDConfig, UniformRows
    from repro_torch.data import make_glm_data
    A, b, _ = make_glm_data(m=96, n=256, density=0.2, zipf_a=1.1, seed=42)
    cfg = SGDConfig(batch_frac=batch_frac, step_size=0.1, K=3, H=H,
                    exchange=ex)
    probe = MinibatchSGD(cfg, A, b, device="cpu")
    stream = [probe.row_source(t).numpy() for t in (1, 2)]
    out = {}
    for where in ("cuda", "cpu"):
        tr = MinibatchSGD(cfg, A, b, device=where,
                          row_source=ReplayIndices(stream, device=where))
        hist = tr.run_workers(2, record_every=1, p_star=0.0, p_zero=1.0)
        out[where] = (np.array(hist.primal), tr.alpha_final)
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    np.testing.assert_allclose(out["cuda"][1], out["cpu"][1], rtol=1e-3,
                               atol=1e-6)


# -- the collective fabric on the card ----------------------------------
@pytest.fixture
def one_rank_group(cuda, tmp_path):
    """A 1-rank process group in this process, by backend name."""
    import torch.distributed as tdist
    from repro_torch.launch.dist import init_group

    def start(backend):
        init_group(backend, f"file://{tmp_path / backend}", 1, 0, 60)
    yield start
    if tdist.is_initialized():
        tdist.destroy_process_group()


def test_fabric_on_a_one_rank_nccl_group(cuda, one_rank_group):
    """NCCL takes the device tensors as they are (no staging) and refuses
    a host tensor; every call of a 1-rank group is the identity."""
    from repro_torch.comm.collectives import Fabric, get_backend, recording
    one_rank_group("nccl")
    fab = Fabric()
    x = torch.randn(97, device=cuda)
    with recording() as log:
        outs = [fab.all_reduce(x), fab.all_gather(x[None])[0],
                fab.reduce_scatter(x), fab.shift(x), fab.broadcast(x),
                get_backend("ring").reduce_scatter_gather(x, fab),
                get_backend("xla").reduce_scatter_gather(x, fab)]
    for out in outs:
        assert out.device == x.device and torch.equal(out, x)
    # a 1-rank hop sends nothing: six calls into the group
    assert not any(c.staged for c in log) and len(log) == 6
    with pytest.raises(ValueError, match="device tensors"):
        fab.all_reduce(x.cpu())


def test_gloo_stages_a_card_tensor_through_the_host(cuda, one_rank_group):
    """A gloo group gets a host copy of a CUDA operand; the result comes
    back to the card with its bits, and the log says it was staged."""
    from repro_torch.comm.collectives import Fabric, recording
    one_rank_group("gloo")
    fab = Fabric()
    x = torch.randn((1, 1001), device=cuda)
    x[0, 3] = -0.0
    q = torch.randint(-127, 128, (1, 1001), dtype=torch.int8, device=cuda)
    with recording() as log:
        got = [fab.all_gather(x), fab.all_gather(q), fab.all_reduce(x[0]),
               fab.broadcast(q)]
    for out, want in zip(got, (x, q, x[0], q)):
        assert out.device == want.device and out.dtype == want.dtype
        assert torch.equal(_bits(out), _bits(want))
    assert [c.staged for c in log] == [True] * 4
    assert [c.dtype for c in log] == ["float32", "int8", "float32", "int8"]


# -- the fixed-order batched products (kernels/bmv.py) ----------------------
def _dot_bound(M, v, along):
    """2 gamma_n sum |products|: two orders of one f32 dot product differ
    by at most this (n the summed length, u = 2^-24)."""
    n = M.shape[along]
    u = 2.0 ** -24
    g = n * u / (1 - n * u)
    if along == 2:
        return 2 * g * torch.einsum("kij,kj->ki", M.abs().double(),
                                    v.abs().double())
    return 2 * g * torch.einsum("ki,kij->kj", v.abs().double(),
                                M.abs().double())


@pytest.mark.parametrize("K,r,c,form", [
    (8, 512, 16384, "vector"), (8, 2048, 4096, "rows"),
    (3, 33, 97, "rows"), (5, 17, 258, "expanded"), (1, 4096, 4099, "vector"),
    (2, 7, 3, "misaligned")])
def test_bmv_kernels_match_plain(cuda, K, r, c, form):
    """Both forms against their plain versions within the dot-product
    bound, on aligned rows (float4 loads), ragged ones (c % 4 != 0),
    one vector, rows, one vector expanded (stride 0) and an x that is not
    16-byte aligned."""
    from repro_torch.kernels.bmv import (batched_matvec, batched_matvec_ref,
                                         batched_vecmat, batched_vecmat_ref)
    g = torch.Generator(device=cuda).manual_seed(K * r + c)
    M = torch.randn((K, r, c), generator=g, device=cuda)
    if form == "vector":
        x = torch.randn((c,), generator=g, device=cuda)
    elif form == "expanded":
        x = torch.randn((c,), generator=g, device=cuda).expand(K, -1)
    elif form == "misaligned":
        x = torch.randn((K, c + 1), generator=g, device=cuda)[:, 1:]
    else:
        x = torch.randn((K, c), generator=g, device=cuda)
    y = torch.randn((K, r), generator=g, device=cuda)
    got, want = batched_matvec(M, x), batched_matvec_ref(M, x)
    xs = x.expand(K, -1) if x.dim() == 1 else x
    assert bool(((got - want).abs().double() <= _dot_bound(M, xs, 2)).all())
    got, want = batched_vecmat(y, M), batched_vecmat_ref(y, M)
    assert bool(((got - want).abs().double() <= _dot_bound(M, y, 1)).all())


@pytest.mark.parametrize("K,r,c", [(8, 256, 16384), (4, 33, 97)])
def test_bmv_kernels_do_not_depend_on_K(cuda, K, r, c):
    """A worker's block alone gives, bit for bit, its rows of the
    K-worker launch: the property the sharded driver's bit-identity
    rests on."""
    from repro_torch.kernels.bmv import batched_matvec, batched_vecmat
    g = torch.Generator(device=cuda).manual_seed(c)
    M = torch.randn((K, r, c), generator=g, device=cuda)
    w = torch.randn((c,), generator=g, device=cuda)
    x = torch.randn((K, c), generator=g, device=cuda)
    y = torch.randn((K, r), generator=g, device=cuda)
    stack = (batched_matvec(M, w), batched_matvec(M, x), batched_vecmat(y, M))
    for k in range(K):
        one = slice(k, k + 1)
        alone = (batched_matvec(M[one].clone(), w),
                 batched_matvec(M[one].clone(), x[one].clone()),
                 batched_vecmat(y[one].clone(), M[one].clone()))
        for s, a in zip(stack, alone):
            assert torch.equal(_bits(s[k]), _bits(a[0]))


def test_bmv_wrappers_count_their_launches(cuda):
    from repro_torch.kernels.bmv import batched_matvec, batched_vecmat
    M = torch.ones((2, 3, 8), device=cuda)
    before = (batched_matvec.launches, batched_vecmat.launches)
    assert torch.equal(batched_matvec(M, torch.ones(8, device=cuda)),
                       torch.full((2, 3), 8.0, device=cuda))
    assert torch.equal(batched_vecmat(torch.ones((2, 3), device=cuda), M),
                       torch.full((2, 8), 3.0, device=cuda))
    assert (batched_matvec.launches, batched_vecmat.launches) == (
        before[0] + 1, before[1] + 1)


# -- the trade-off layer on the card ------------------------------------
def test_measure_solver_time_on_card_covers_k1s_device_time(cuda):
    """``measure_solver_time`` drains the card inside each sample, so a
    round's time is at least the device time of the K1 launch it holds
    (without the drain it would time the launches only)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.bench.timing import measure_solver_time
    from repro_torch.core import CoCoAConfig, CoCoATrainer
    from repro_torch.data import make_glm_data
    A, b, _ = make_glm_data(m=2048, n=4096, density=0.15, zipf_a=1.1,
                            seed=42)
    H = 512
    tr = CoCoATrainer(CoCoAConfig(K=8, H=H, solver="scd_kernel",
                                  exchange="compressed:int8"), A, b,
                      device=cuda)
    t_round = measure_solver_time(tr, H)
    alpha, w = tr.init_state()
    idx = tr.index_source(1)
    call = lambda: scd_solve(tr.A_T, tr.col_sq, alpha, w, idx,  # noqa: E731
                             sigma=8.0, lam=1.0, eta=1.0)
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    k1 = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA
          and "scd_kernel" in e.name]
    assert len(k1) == 5, "the trace holds no K1 launch"
    k1_s = float(np.mean(k1)) * 1e-6
    print(f"t_solver {t_round * 1e3:.3f} ms, K1 device {k1_s * 1e3:.3f} ms")
    assert t_round >= k1_s


def test_small_sweep_on_card_equals_cpu(cuda):
    """``sweep_H`` on the card (K1, K2 and K3) and on the CPU (plain
    versions) on one replayed index stream per H: the same rounds-to-eps
    and bytes at every grid point."""
    from repro_torch.carry import ReplayIndices
    from repro_torch.core import CoCoAConfig, CoCoATrainer
    from repro_torch.core.tradeoff import sweep_H
    from repro_torch.data import make_glm_data
    A, b, _ = make_glm_data(m=96, n=256, density=0.2, zipf_a=1.1, seed=42)
    cfg = CoCoAConfig(K=4, H=64, solver="scd_kernel",
                      exchange="compressed:int8", seed=1)
    probe = CoCoATrainer(cfg, A, b, device="cpu")
    streams = {H: [probe.with_H(H).index_source(t).numpy()
                   for t in range(1, 61)] for H in (16, 64)}
    out = {}
    for where in ("cuda", "cpu"):
        out[where] = sweep_H(A, b, cfg, (16, 64), max_rounds=60,
                             measure=False, device=where,
                             index_source_for=lambda H: ReplayIndices(
                                 streams[H], device=where))
    got, want = out["cuda"], out["cpu"]
    assert ([p.rounds_to_eps for p in got.points]
            == [p.rounds_to_eps for p in want.points])
    assert all(p.rounds_to_eps is not None for p in want.points)
    assert got.comm_bytes_per_round == want.comm_bytes_per_round


# -- the transformer local-updates path (tinyllama) ----------------------

# tinyllama's largest leaf: the stacked w_up / w_gate of its 22 layers
TINYLLAMA_LARGEST = 22 * 2048 * 5632


@pytest.mark.parametrize("codec", ["int8", "ef:topk(r=0.01)"])
def test_exchange_at_the_largest_tinyllama_leaf(cuda, codec):
    """The delta exchange of one (4, 253,755,392) leaf through the
    kernels (K2 and K3, or K4 and the topk decode) against the plain
    versions on the same stack: the parts, the mean and the residual
    bit for bit, one launch of each kernel."""
    from repro_torch.kernels import dequant, quant, topk
    from repro_torch.optim.local_updates import exchange_leaf
    K, L = 4, TINYLLAMA_LARGEST
    g = torch.Generator(device=cuda).manual_seed(0)
    stack = torch.randn((K, L), generator=g, device=cuda) * 1e-3
    c = get_codec(codec)
    state = (torch.randn((K, L), generator=g, device=cuda) * 1e-5
             if c.stateful else None)
    fns = ((topk.topk_select,) if "topk" in codec else
           (quant.quantize_pack_int8, dequant.decode_reduce_int8))
    before = [f.launches for f in fns]
    mean, new_state, parts = exchange_leaf(c, stack, state)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(fns, before)] == [1] * len(fns)
    e = stack if state is None else stack + state
    want = c.encode_ref(e)
    for a, b in zip(parts, want):
        assert torch.equal(_bits(a), _bits(b))
    del want
    if "topk" in codec:
        want_mean = c.decode_stacked_mean(parts, L)
    else:
        want_mean = c.decode_reduce_ref(parts, L, mean=True)
    assert torch.equal(_bits(mean), _bits(want_mean))
    if state is not None:
        want_state = e - c.decode_stacked(parts, L)
        assert torch.equal(_bits(new_state), _bits(want_state))


def test_one_full_width_round_launches_and_bytes(cuda):
    """One K = 4 round of tinyllama at full width (H = 1, batch 1, seq
    64) under ``compressed:int8``: K2 and K3 once a leaf (12 leaves), no
    other kernel, the exchange's bytes equal to ``delta_wire_bytes``,
    every param finite."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import dequant, quant, topk
    from repro_torch.models import build_model
    from repro_torch.optim import (AdamWConfig, LocalUpdatesConfig,
                                   adamw_init, delta_wire_bytes,
                                   virtual_round)
    from repro_torch.train import make_train_step
    from repro_torch.utils.trees import tree_allfinite, tree_leaves
    from repro_torch.utils.device import full_f32_matmul
    full_f32_matmul()
    cfg = get_config("tinyllama-1.1b")
    model = build_model(cfg)
    params = model.init(torch.Generator(device=cuda).manual_seed(0))
    opt_cfg = AdamWConfig(lr=1e-3)
    lc = LocalUpdatesConfig(H=1, codec="int8")
    tok = torch.randint(0, cfg.vocab_size, (4, 1, 1, 64), device=cuda,
                        generator=torch.Generator(device=cuda).manual_seed(1))
    batches = {"tokens": tok, "labels": tok}
    fns = [quant.quantize_pack_int8, dequant.decode_reduce_int8,
           quant.quantize_pack_int4, quant.quantize_pack_int2,
           dequant.decode_reduce_int4, dequant.decode_reduce_int2,
           topk.topk_select]
    before = [f.launches for f in fns]
    p, _, m = virtual_round(make_train_step(model, opt_cfg, remat=True),
                            params, adamw_init(params, opt_cfg), batches, lc)
    torch.cuda.synchronize()
    n = len(tree_leaves(params))
    assert n == 12
    assert [f.launches - b for f, b in zip(fns, before)] == [n, n] + [0] * 5
    assert m["wire_bytes"] == delta_wire_bytes(params, lc, 4)
    assert bool(tree_allfinite(p))


def _reduced_round_inputs(device, K: int, H: int = 2):
    """The reduced tinyllama in f32 (seed 0) on ``device``, its step and
    K shards' H batches (2 x 32 tokens each), all made on the device."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.train import make_train_step
    from repro_torch.utils.device import full_f32_matmul
    full_f32_matmul()
    cfg = get_config("tinyllama-1.1b").reduced()
    model = build_model(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        torch.float32)
    opt_cfg = AdamWConfig(lr=1e-3)
    gen = torch.Generator(device=device).manual_seed(1)
    tok = torch.randint(0, cfg.vocab_size, (K, H, 2, 32), device=device,
                        generator=gen)
    return (make_train_step(model, opt_cfg), params,
            adamw_init(params, opt_cfg), {"tokens": tok, "labels": tok})


def _same_bits(a, b) -> bool:
    from repro_torch.utils.trees import tree_leaves
    return all(torch.equal(_bits(x), _bits(y))
               for x, y in zip(tree_leaves(a), tree_leaves(b)))


def test_local_updates_round_on_a_one_rank_nccl_group(cuda, one_rank_group):
    """One ``int8`` round over a 1-rank NCCL group (K2 and K3 once a
    leaf, no copy staged) equals ``virtual_round`` at K = 1 bit for
    bit."""
    from repro_torch.comm.collectives import Fabric, recording
    from repro_torch.kernels import dequant, quant
    from repro_torch.optim import (LocalUpdatesConfig, local_updates_round,
                                   virtual_round)
    step, params, opt, batches = _reduced_round_inputs(cuda, 1)
    lc = LocalUpdatesConfig(H=2, codec="int8")
    want = virtual_round(step, params, opt, batches, lc)
    one_rank_group("nccl")
    fns = (quant.quantize_pack_int8, dequant.decode_reduce_int8)
    before = [f.launches for f in fns]
    with recording() as log:
        got = local_updates_round(step, params, opt,
                                  {n: v[0] for n, v in batches.items()}, lc,
                                  Fabric())
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(fns, before)] == [12, 12]
    assert _same_bits(got[0], want[0]) and _same_bits(got[1], want[1])
    assert got[2]["wire_bytes"] == want[2]["wire_bytes"]
    assert not any(c.staged for c in log)


def _gloo_ef_topk_rank(rank, world, device):
    """Rank ``rank`` of a 2-rank gloo group on the card: one
    ``ef:topk(r=0.125)`` round of shard ``rank``; rank 0 also runs
    ``virtual_round`` at K = 2 and compares."""
    from repro_torch.comm.collectives import Fabric
    from repro_torch.optim import (LocalUpdatesConfig,
                                   init_delta_codec_state,
                                   local_updates_round, virtual_round)
    from repro_torch.utils.trees import tree_map
    step, params, opt, batches = _reduced_round_inputs(device, world)
    lc = LocalUpdatesConfig(H=2, codec="ef:topk(r=0.125)")
    got = local_updates_round(step, params, opt,
                              {n: v[rank] for n, v in batches.items()}, lc,
                              Fabric(), init_delta_codec_state(params, lc))
    want = virtual_round(step, params, opt, batches, lc,
                         init_delta_codec_state(params, lc, shards=world))
    return dict(params=_same_bits(got[0], want[0]),
                opt=_same_bits(got[1], want[1]),
                residual=_same_bits(got[3], tree_map(lambda x: x[rank],
                                                     want[3])))


def test_local_updates_round_on_two_gloo_ranks_on_the_card(cuda, tmp_path):
    """Two gloo ranks on ``cuda:0`` (every payload through the host),
    ``ef:topk(r=0.125)``: each rank's params, opt state and residual row
    equal ``virtual_round``'s at K = 2 bit for bit."""
    from repro_torch.launch.dist import spawn
    res = spawn(2, _gloo_ef_topk_rank, device="cuda",
                init_file=str(tmp_path / "init"), timeout_s=240)
    assert res == [dict(params=True, opt=True, residual=True)] * 2


def test_launch_train_reduced_runs_on_the_card(cuda, capsys, tmp_path):
    """``python -m repro_torch.launch.train --reduced`` with local rounds
    under ``compressed:int8`` and a checkpoint, on the card by default."""
    from repro_torch.launch import train
    ckpt = str(tmp_path / "ck.npz")
    train.main(["--reduced", "--steps", "4", "--batch", "2", "--seq", "64",
                "--local-H", "2", "--exchange", "compressed:int8",
                "--ckpt", ckpt])
    out = capsys.readouterr().out
    assert "round 1 (H=2)" in out and "saved" in out
    import os
    assert os.path.exists(ckpt) and os.path.exists(ckpt + ".meta.json")


def test_reduced_serving_on_the_card_equals_the_cpu(cuda):
    """The dense, SSM and hybrid archs at ``.reduced()`` in f32 on the
    same params: the same greedy ids, and, with f32 caches, the prefill's
    and every decode step's logits at rtol 1e-4 with atol 1e-5 of the
    largest (the vlm and audio archs:
    ``test_vlm_and_audio_serving_on_the_card_equals_the_cpu``)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import greedy_generate
    from repro_torch.utils.device import full_f32_matmul
    from repro_torch.utils.trees import tree_map
    full_f32_matmul()
    rng = np.random.default_rng(0)
    B, S, n = 4, 24, 12
    for arch in ("tinyllama-1.1b", "nemotron-4-15b", "command-r-35b",
                 "mamba2-2.7b", "recurrentgemma-9b"):
        cfg = get_config(arch).reduced()
        m = build_model(cfg)
        params = m.init(torch.Generator().manual_seed(0), torch.float32)
        prompts = torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                               dtype=torch.int32)
        ids = greedy_generate(m, params, prompts, max_new=n)
        out, logits = {}, {}
        for dev in ("cpu", cuda):
            p = tree_map(lambda a: a.to(dev), params)
            out[str(dev)] = greedy_generate(m, p, prompts.to(dev),
                                            max_new=n).cpu()
            st = m.init_states(p, B, S + n, dtype=torch.float32)
            with torch.inference_mode():
                lg, st = m.prefill(p, {"tokens": prompts.to(dev)}, st)
                rows = [lg[:, -1:]]
                for t in range(n - 1):
                    lg, st = m.decode_step(p, {
                        "tokens": ids[:, t:t + 1].to(dev),
                        "positions": torch.full((B, 1), S + t,
                                                dtype=torch.int32,
                                                device=dev)}, st)
                    rows.append(lg)
            logits[str(dev)] = torch.cat(rows, 1).cpu().numpy()
        assert torch.equal(out["cpu"], out[str(cuda)]), arch
        want = logits["cpu"]
        np.testing.assert_allclose(logits[str(cuda)], want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=arch)


@pytest.mark.parametrize("arch", ["mamba2-2.7b", "recurrentgemma-9b"])
def test_recurrent_decode_matches_teacher_forcing_on_the_card(cuda, arch):
    """The SSM and hybrid families at ``.reduced()`` in bf16 on the card:
    the prefill's last row and every greedy decode step's log-softmax
    within the reference's 0.15 of the full forward over the prompt and
    the ids before it; the ``{h, conv}`` states stay on the card."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import make_serve_step
    B, S, n = 2, 40, 8
    m = build_model(get_config(arch).reduced())
    params = m.init(torch.Generator(device=cuda).manual_seed(0))
    prompts = torch.tensor(np.random.default_rng(1).integers(
        0, m.cfg.vocab_size, (B, S)), dtype=torch.int32, device=cuda)
    step = make_serve_step(m)
    with torch.inference_mode():
        st = m.init_states(params, B, S + n)
        lg, st = m.prefill(params, {"tokens": prompts}, st)
        rows, ids = [lg[:, -1]], []
        for t in range(n):
            ids.append(rows[-1].argmax(-1).to(torch.int32)[:, None])
            lg, st = step(params, st, ids[-1], torch.full(
                (B, 1), S + t, dtype=torch.int32, device=cuda))
            rows.append(lg[:, 0])
        seq = torch.cat([prompts] + ids, 1)
        tf, _ = m.forward_train(params, {"tokens": seq})
    got = torch.log_softmax(torch.stack(rows, 1), -1)
    want = torch.log_softmax(tf[:, S - 1:], -1)
    assert all(v.is_cuda for d in st if "h" in d for v in d.values())
    assert float((got - want).abs().max()) < 0.15


def test_launch_serve_reduced_runs_on_the_card(cuda, capsys):
    """``python -m repro_torch.launch.serve --reduced`` on the card by
    default."""
    from repro_torch.launch import serve
    serve.main(["--reduced", "--batch", "2", "--prompt-len", "16",
                "--max-new", "8"])
    out = capsys.readouterr().out
    assert "generated (2, 8)" in out and "on cuda" in out


def test_cache_fill_with_repeated_slots_on_the_card_equals_the_cpu(cuda):
    """A VLM prompt's patches all write cache slot 0 (t = 0), and a
    prompt past a ring of T slots wraps round it: the bulk fill keeps
    the last write to each slot on the card as on the CPU, bit for bit,
    in every one of 20 repeats (``index_put_`` alone leaves the winner
    of repeated indices undefined on CUDA)."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    cfg = get_config("qwen2-vl-72b")
    B, S, T = 8, 512, 544
    rng = np.random.default_rng(0)
    pos = np.concatenate([np.zeros((B, 256), np.int64),
                          np.broadcast_to(np.arange(256, S), (B, S - 256))],
                         1)
    ring = np.broadcast_to(np.arange(S) % 100 + 3 * (np.arange(S) // 100),
                           (B, S))
    for p in (pos, ring):
        k, v = (torch.tensor(rng.standard_normal(
            (B, S, cfg.num_kv_heads, cfg.head_dim)),
            dtype=torch.bfloat16) for _ in range(2))
        want = L._slots_fill(L.init_attn_cache(cfg, B, T),
                             {"k": k, "v": v}, torch.tensor(p))
        for _ in range(20):
            got = L._slots_fill(L.init_attn_cache(cfg, B, T, device=cuda),
                                {"k": k.to(cuda), "v": v.to(cuda)},
                                torch.tensor(p).to(cuda))
            for name in ("k", "v", "pos_abs"):
                assert torch.equal(got[name].cpu(), want[name]), name


def test_vlm_and_audio_serving_on_the_card_equals_the_cpu(cuda):
    """chatglm3-6b, qwen2-vl-72b (with 8 patch embeddings at the prompt's
    start on a (t = 0, h, w) grid) and whisper-tiny (with its frames) at
    ``.reduced()`` in f32 on the same params: the same greedy ids, and,
    with f32 caches, the prefill's and every decode step's logits at
    rtol 1e-4 with atol 1e-5 of the largest."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.serve import greedy_generate
    from repro_torch.utils.device import full_f32_matmul
    from repro_torch.utils.trees import tree_map
    full_f32_matmul()
    rng = np.random.default_rng(0)
    B, S, n = 4, 24, 12
    for arch in ("chatglm3-6b", "qwen2-vl-72b", "whisper-tiny"):
        cfg = get_config(arch).reduced()
        m = build_model(cfg)
        params = m.init(torch.Generator().manual_seed(0), torch.float32)
        prompts = torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                               dtype=torch.int32)
        extras = {}
        if cfg.family == "audio":
            extras["frame_embeds"] = torch.tensor(rng.standard_normal(
                (B, cfg.encdec.source_len, cfg.d_model)) * 0.02).to(
                    torch.bfloat16)
        if cfg.family == "vlm":
            h, w = np.meshgrid(np.arange(2), np.arange(4), indexing="ij")
            grid = np.stack([np.zeros_like(h), h, w], -1).reshape(1, 8, 3)
            extras["patch_embeds"] = torch.tensor(rng.standard_normal(
                (B, 8, cfg.d_model)) * 0.02).to(torch.bfloat16)
            extras["patch_positions"] = torch.tensor(
                np.repeat(grid, B, 0), dtype=torch.int32)
        ids = greedy_generate(m, params, prompts, max_new=n,
                              batch_extras=extras)
        out, logits = {}, {}
        for dev in ("cpu", cuda):
            p = tree_map(lambda a: a.to(dev), params)
            ex = tree_map(lambda a: a.to(dev), extras)
            out[str(dev)] = greedy_generate(m, p, prompts.to(dev),
                                            max_new=n,
                                            batch_extras=ex).cpu()
            with torch.inference_mode():
                st = m.init_states(p, B, S + n, batch=ex or None,
                                   dtype=torch.float32)
                lg, st = m.prefill(p, {"tokens": prompts.to(dev), **ex}, st)
                rows = [lg[:, -1:]]
                for t in range(n - 1):
                    lg, st = m.decode_step(p, {
                        "tokens": ids[:, t:t + 1].to(dev),
                        "positions": torch.full((B, 1), S + t,
                                                dtype=torch.int32,
                                                device=dev)}, st)
                    rows.append(lg)
            logits[str(dev)] = torch.cat(rows, 1).cpu().numpy()
        assert torch.equal(out["cpu"], out[str(cuda)]), arch
        want = logits["cpu"]
        np.testing.assert_allclose(logits[str(cuda)], want, rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=arch)


def test_moe_combine_at_top8_is_bit_equal_on_the_card_and_the_cpu(cuda):
    """deepseek-v3's routing (256 experts, top 8) at its configured
    capacity, with drops: the dispatch tables and the bf16 combine, each
    token's kept slots summed in expert order, are the same bits in
    every one of 20 repeats on the card and equal to the CPU's (an
    atomic ``index_add_`` leaves the order of a token's eight bf16 adds,
    and so its sum, to the run)."""
    from repro_torch.configs import get_config
    from repro_torch.models import layers as L
    mo = get_config("deepseek-v3-671b").moe
    T, d = 512, 1024
    C = L._capacity(mo, T, False)
    rng = np.random.default_rng(0)
    logits = torch.tensor(rng.standard_normal((T, mo.num_experts)),
                          dtype=torch.float32)
    gates, experts = torch.sort(torch.softmax(logits, -1), dim=-1,
                                descending=True, stable=True)
    gates, experts = gates[:, :mo.top_k], experts[:, :mo.top_k]
    ye = torch.tensor(rng.standard_normal((mo.num_experts * C, d)) * 4,
                      dtype=torch.bfloat16)
    want = L._dispatch_tables(experts, gates, T, mo, C)
    want_y = L._combine(ye, want[2])
    assert bool((want[2] == mo.num_experts * C).any())      # some dropped
    for _ in range(20):
        got = L._dispatch_tables(experts.to(cuda), gates.to(cuda), T, mo, C)
        for g, w in zip(got, want):
            assert torch.equal(g.cpu(), w)
        y = L._combine(ye.to(cuda), got[2]).cpu()
        assert torch.equal(y.view(torch.int16), want_y.view(torch.int16))


def test_mla_decode_step_on_the_card_equals_the_cpu(cuda):
    """deepseek-v3 at ``.reduced()`` in f32 on the same params: the
    prefill into the latent caches and two absorbed-form decode steps,
    logits at rtol 1e-4 (atol 1e-5 of the largest) and each cache's
    ``pos_abs`` equal, on the card and on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.utils.device import full_f32_matmul
    from repro_torch.utils.trees import tree_map
    full_f32_matmul()
    cfg = get_config("deepseek-v3-671b").reduced()
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), torch.float32)
    B, S = 2, 24
    rng = np.random.default_rng(1)
    prompts = torch.tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                           dtype=torch.int32)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (B, 2)),
                        dtype=torch.int32)
    out = {}
    for dev in ("cpu", cuda):
        p = tree_map(lambda a: a.to(dev), params)
        with torch.inference_mode():
            st = m.init_states(p, B, S + 2, dtype=torch.float32)
            lg, st = m.prefill(p, {"tokens": prompts.to(dev)}, st)
            rows = [lg[:, -1:]]
            for t in range(2):
                lg, st = m.decode_step(p, {
                    "tokens": toks[:, t:t + 1].to(dev),
                    "positions": torch.full((B, 1), S + t, dtype=torch.int32,
                                            device=dev)}, st)
                rows.append(lg)
        out[str(dev)] = (torch.cat(rows, 1).cpu().numpy(),
                         [s["pos_abs"].cpu() for s in st])
    want, want_pos = out["cpu"]
    got, got_pos = out[str(cuda)]
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    assert all(torch.equal(a, b) for a, b in zip(got_pos, want_pos))


# -- training every family (phase 10's rows, at .reduced()) -----------------

TRAIN_ARCHS = ("tinyllama-1.1b", "mamba2-2.7b", "recurrentgemma-9b",
               "chatglm3-6b", "whisper-tiny", "qwen2-vl-72b",
               "llama4-maverick-400b-a17b", "deepseek-v3-671b")


def _train_inputs(arch, B=2, S=64):
    """``arch`` at ``.reduced()``: its model, f32 params (seed 0) and one
    batch on the CPU, whisper's frames and qwen2-vl's 16 patch
    embeddings on a (t = 0, h, w) grid included (seed 1)."""
    from repro_torch.configs import get_config
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import build_model
    cfg = get_config(arch).reduced()
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(0), torch.float32)
    batch = {n: torch.tensor(v) for n, v in TokenStream(
        cfg.vocab_size, S, B, seed=0).next_batch().items()}
    rng = np.random.default_rng(1)
    if cfg.family == "audio":
        batch["frame_embeds"] = torch.tensor(rng.standard_normal(
            (B, cfg.encdec.source_len, cfg.d_model)) * 0.02,
            dtype=torch.float32)
    elif cfg.family == "vlm":
        h, w = np.meshgrid(np.arange(4), np.arange(4), indexing="ij")
        grid = np.stack([np.zeros_like(h), h, w], -1).reshape(1, -1, 3)
        batch["patch_embeds"] = torch.tensor(rng.standard_normal(
            (B, 16, cfg.d_model)) * 0.02, dtype=torch.float32)
        batch["patch_positions"] = torch.tensor(np.repeat(grid, B, 0),
                                                dtype=torch.int32)
    return cfg, m, params, batch


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_train_step_on_the_card_equals_the_cpu(cuda, arch):
    """One train step's loss and gradients (``loss_and_grads``, what
    ``make_train_step`` differentiates) in f32 on the same params and
    batch: the loss, CE, aux and MTP terms at rtol 1e-5, every gradient
    leaf within 1e-4 of its largest |CPU| value (floored at 1e-4: a key
    bias's gradient is 0 in exact arithmetic)."""
    from repro_torch.train import loss_and_grads
    from repro_torch.utils.device import full_f32_matmul
    from repro_torch.utils.trees import tree_flatten_with_path, tree_map
    full_f32_matmul()
    cfg, m, params, batch = _train_inputs(arch)
    l_c, m_c, g_c = loss_and_grads(m, params, batch)
    l_d, m_d, g_d = loss_and_grads(m, tree_map(lambda t: t.to(cuda), params),
                                   {n: v.to(cuda) for n, v in batch.items()})
    terms = ("loss", "ce", "aux_loss") + (
        ("mtp_loss",) if cfg.mtp_depth else ())
    for n in terms:
        np.testing.assert_allclose(float(m_d[n]), float(m_c[n]), rtol=1e-5,
                                   err_msg=n)
    for (key, _), a, b in zip(tree_flatten_with_path(params), g_d, g_c):
        scale = max(float(b.abs().max()), 1e-4)
        assert float((a.cpu() - b).abs().max()) <= 1e-4 * scale, key


@pytest.mark.parametrize("arch", TRAIN_ARCHS)
def test_bf16_gradients_repeat_on_the_card(cuda, arch):
    """The same bf16 step twice on the card: the loss and every gradient
    leaf bit for bit (the MoE gathers' and the embedding's backward sum
    their repeated rows in a fixed order)."""
    from repro_torch.train import loss_and_grads
    from repro_torch.utils.trees import tree_map
    _, m, params, batch = _train_inputs(arch)
    p16 = tree_map(lambda t: t.to(cuda, torch.bfloat16), params)
    b16 = {n: v.to(cuda, torch.bfloat16) if v.is_floating_point()
           else v.to(cuda) for n, v in batch.items()}
    (l1, _, g1), (l2, _, g2) = (loss_and_grads(m, p16, b16, remat=True)
                                for _ in range(2))
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1, g2))


@pytest.mark.parametrize("name", ["int8", "int4", "int2"])
@pytest.mark.parametrize("K,L", [(4, 1001), (8, 16384)])
def test_decode_mean_on_the_card_equals_the_plain_version(cuda, name, K, L):
    """``decode_mean_int*`` launch K3 once and give its plain version's
    mean bit for bit."""
    fn = getattr(dequant, f"decode_mean_{name}")
    g = torch.Generator(device=cuda).manual_seed(K + L)
    x = torch.randn((K, L), generator=g, device=cuda)
    q, s = get_codec(name).encode_ref(x)
    kernel = getattr(dequant, f"decode_reduce_{name}")
    before = kernel.launches
    got = fn(q, s, L)
    torch.cuda.synchronize()
    assert kernel.launches - before == 1
    want = getattr(dequant, f"decode_reduce_{name}_ref")(q, s, L, mean=True)
    assert torch.equal(_bits(got), _bits(want))


@pytest.mark.parametrize("arch", ["deepseek-v3-671b", "mamba2-2.7b",
                                  "recurrentgemma-9b", "qwen2-vl-72b"])
def test_launch_train_reduced_runs_every_token_family_on_the_card(
        cuda, capsys, arch):
    """``python -m repro_torch.launch.train --arch <arch> --reduced``
    (moe, ssm, hybrid, and vlm as text: the launcher's batch holds tokens
    only, as the reference's) with local rounds under
    ``compressed:int8``, on the card by default; the loss printed
    finite."""
    from repro_torch.launch import train
    train.main(["--arch", arch, "--reduced", "--steps", "4", "--batch", "2",
                "--seq", "64", "--local-H", "2", "--exchange",
                "compressed:int8"])
    out = capsys.readouterr().out
    losses = [float(line.split("loss=")[1].split()[0])
              for line in out.splitlines() if line.startswith("round ")]
    assert len(losses) == 2 and all(np.isfinite(losses)), out


# -- the partitioned paths on a (1, 1) mesh ---------------------------------
def _mesh_1x1():
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((1, 1), ("data", "model"), "cuda")


def _whole(tree):
    from repro_torch.utils.trees import tree_map
    return tree_map(lambda t: t.full_tensor() if hasattr(t, "full_tensor")
                    else t, tree)


def test_partitioned_train_step_on_a_1x1_mesh_is_bit_identical(
        cuda, one_rank_group):
    """``lower_train`` of the reduced tinyllama on a (1, 1) mesh over a
    1-rank NCCL group (DTensor params, batch and opt state) gives the
    unpartitioned step's loss and params bit for bit, and so does one
    ``lower_train_local_updates`` round under int8 (K2 and K3 launched
    on the whole leaves)."""
    from repro_torch.configs import ShapeConfig, get_config
    from repro_torch.launch import build
    from repro_torch.optim import (AdamWConfig, LocalUpdatesConfig,
                                   local_updates_round)
    from repro_torch.comm.collectives import Fabric
    step, params, opt, batches = _reduced_round_inputs(cuda, 1)
    cfg = get_config("tinyllama-1.1b").reduced()
    one_rank_group("nccl")
    mesh = _mesh_1x1()
    batch = {n: v[0, 0] for n, v in batches.items()}
    p1, o1, m1 = step(params, opt, batch)
    shape = ShapeConfig("gpu_train", 32, 2, "train")
    built = build.lower_train(cfg, shape, mesh, remat=False,
                              opt_cfg=AdamWConfig(lr=1e-3),
                              values=(params, opt, batch))
    p2, o2, m2 = built.run()
    assert torch.equal(_bits(m1["loss"]), _bits(m2["loss"].full_tensor()))
    assert _same_bits(p1, _whole(p2)) and _same_bits(o1, _whole(o2))
    rnd = {n: v[0] for n, v in batches.items()}
    lc = LocalUpdatesConfig(H=2, codec="int8")
    want = local_updates_round(step, params, opt, rnd, lc, Fabric())
    fns = (quant.quantize_pack_int8, dequant.decode_reduce_int8)
    before = [f.launches for f in fns]
    lu = build.lower_train_local_updates(cfg, shape, mesh, H=2, codec="int8",
                                         remat=False,
                                         opt_cfg=AdamWConfig(lr=1e-3),
                                         values=(params, opt, rnd))
    got = lu.run()
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(fns, before)] == [12, 12]
    assert _same_bits(want[0], _whole(got[0]))
    assert _same_bits(want[1], _whole(got[1]))


def test_moe_sharded_on_a_1x1_mesh_is_bit_identical(cuda, one_rank_group):
    """deepseek-v3's MoE block at ``.reduced()`` in bf16 on DTensors of a
    (1, 1) mesh takes ``_moe_sharded`` (its all-to-alls over the 1-rank
    model group) and gives ``moe_apply``'s output and aux loss bit for
    bit."""
    from repro_torch.configs import get_config
    from repro_torch.launch import build
    from repro_torch.launch import sharding as sh
    from repro_torch.models import layers as L
    cfg = get_config("deepseek-v3-671b").reduced()
    p = L.init_moe(torch.Generator(device=cuda).manual_seed(0), cfg)
    x = torch.randn((4, 16, cfg.d_model), device=cuda,
                    generator=torch.Generator(device=cuda).manual_seed(1)
                    ).to(torch.bfloat16)
    y0, aux0 = L.moe_apply(p, cfg, x)
    one_rank_group("nccl")
    mesh = _mesh_1x1()
    dp = sh.distribute(p, sh.param_specs({"channel": p}, mesh,
                                         fsdp=True)["channel"], mesh)
    before = dict(L.MOE_PATHS)
    with build.partitioning(mesh):
        y1, aux1 = L.moe_apply(dp, cfg, sh.distribute(x, ("data", None, None),
                                                      mesh))
    assert L.MOE_PATHS["sharded"] - before["sharded"] == 1
    assert L.MOE_PATHS["global"] == before["global"]
    assert torch.equal(y0, y1.full_tensor())
    assert torch.equal(_bits(aux0), _bits(aux1.full_tensor()))


# -- the bench harness on the card ---------------------------------------------

def test_trace_times_a_kernel_on_the_card(cuda):
    """``bench.trace``: K2's events and device time a call are positive,
    a name no kernel has is "not measured", and the trace keeps its
    markers on both sides."""
    from repro_torch.bench.trace import TRACE_MARKERS, device_ms, device_trace, time_ms
    x = torch.randn((8, 16384), generator=torch.Generator(
        device=cuda).manual_seed(0), device=cuda)
    assert time_ms(lambda: quantize_pack_int8(x), 10) > 0
    guards = []
    got = device_ms(lambda: quantize_pack_int8(x), 10, ("quant_kernel<1,",
                                                       "quant_grid_"), guards)
    assert isinstance(got, float) and got > 0
    assert guards[0]["markers_launched"] == dict(before=TRACE_MARKERS,
                                                 after=TRACE_MARKERS)
    assert device_ms(lambda: quantize_pack_int8(x), 2,
                     "no_such_kernel") == "not measured"
    trace = device_trace(lambda: quantize_pack_int8(x))
    assert trace["device_busy_ms"] > 0 and trace["kernels"]


def test_fingerprint_names_the_card(cuda):
    """``EnvFingerprint.capture`` on the card: its name, nvidia-smi's power
    limit, the toolkit's release line, the kernel library's hash."""
    from repro_torch.bench.schema import EnvFingerprint
    env = EnvFingerprint.capture()
    assert env.device_kind == torch.cuda.get_device_name(0)
    assert env.device_count == torch.cuda.device_count()
    assert env.cuda == torch.version.cuda
    assert env.power_limit.endswith(" W")
    assert "release" in env.nvcc
    assert env.kernels == _build._digest()
