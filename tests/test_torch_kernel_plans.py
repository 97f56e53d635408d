"""The launch plans of K2 (``repro_torch.kernels.quant.quant_plan``) and K4
(``repro_torch.kernels.topk.topk_plan``), which are pure Python, the
launcher cache of ``repro_torch.kernels._build``, and the two wrappers on
CPU tensors, which take their plain versions whatever cluster is asked
for and match the reference's encodes bit for bit."""
import math
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from repro.comm.codec import get_codec as get_codec_ref
from repro_torch.comm.codec import get_codec
from repro_torch.kernels import _build, quant, topk
from repro_torch.kernels.quant import QuantPlan, quant_plan
from repro_torch.kernels.topk import TopkPlan, topk_plan, topk_select

LENGTHS = [1, 2, 3, 5, 7, 31, 1001, 1023, 1024, 1025, 4097, 16383, 16384,
           16385, 60000]
CLUSTERS = [None, 16, 8, 4, 2, 1]
WIDTHS = [8, 4, 2]


def cta_ranges(L, bits, plan):
    """For each CTA rank, as csrc/quant.cu computes them: the output bytes
    it packs, [r*span, (r+1)*span) cut at the row's W bytes, and the
    element ranges it reads (one for int8, the two halves' for int4, the
    four quarters' for int2, cut at L: an index >= L is the zero pad)."""
    per = 8 // bits
    W = -(-L // per)
    out = []
    for r in range(plan.cluster):
        b0 = min(r * plan.span, W)
        b1 = min(b0 + plan.span, W)
        out.append((range(b0, b1), [range(min(b0 + p * W, L),
                                          min(b1 + p * W, L))
                                    for p in range(per)]))
    return out


def _quant_fitting(bits, cluster):
    """The lengths K2 takes at ``cluster``; a forced C whose CTAs would
    hold too many elements raises instead."""
    out = []
    for L in LENGTHS:
        try:
            quant_plan(1, L, bits, cluster)
        except ValueError as exc:
            assert cluster is not None and "at most" in str(exc)
            continue
        out.append(L)
    assert out
    return out


# -- K2 ---------------------------------------------------------------------

@pytest.mark.parametrize("bits", WIDTHS)
@pytest.mark.parametrize("cluster", CLUSTERS)
def test_quant_byte_ranges_cover_each_byte_once(bits, cluster):
    for L in _quant_fitting(bits, cluster):
        plan = quant_plan(8, L, bits, cluster)
        W = -(-L // (8 // bits))
        assert plan.span % 4 == 0 and plan.slab == plan.span * (8 // bits)
        ranges = cta_ranges(L, bits, plan)
        assert len(ranges) == plan.cluster
        written = [j for out, _ in ranges for j in out]
        assert written == list(range(W))             # each byte once, in order
        read = sorted(i for _, parts in ranges for part in parts
                      for i in part)
        assert read == list(range(L))                # each element once


@pytest.mark.parametrize("bits", [4, 2])
@pytest.mark.parametrize("cluster", CLUSTERS)
def test_quant_pairing_partners_lie_in_the_ctas_reads(bits, cluster):
    """Byte j packs elements j, j + W, ... (split-half, split-quarter);
    every one of them below L is read by the CTA that writes byte j."""
    per = 8 // bits
    for L in _quant_fitting(bits, cluster):
        plan = quant_plan(3, L, bits, cluster)
        W = -(-L // per)
        for out, parts in cta_ranges(L, bits, plan):
            reads = {i for part in parts for i in part}
            for j in out:
                partners = {j + p * W for p in range(per)}
                assert {i for i in partners if i < L} <= reads


@pytest.mark.parametrize("bits", WIDTHS)
def test_quant_plan_at_the_main_path_shape(bits):
    plan = quant_plan(8, 16384, bits)
    per = 8 // bits
    assert plan == QuantPlan(cluster=8, span=2048 // per, slab=2048)


@pytest.mark.parametrize("bits", WIDTHS)
@pytest.mark.parametrize("L", [1, 5, 1001, 1023, 2000, 4000])
def test_quant_plan_takes_one_cta_for_a_short_row(bits, L):
    assert quant_plan(8, L, bits).cluster == 1


@pytest.mark.parametrize("bits", WIDTHS)
def test_quant_plan_takes_the_widest_cluster_with_a_full_slab(bits):
    for L in LENGTHS:
        plan = quant_plan(1, L, bits)
        assert plan.slab >= quant.SLAB_MIN or plan.cluster == 1
        wider = [c for c in quant.CLUSTERS if c > plan.cluster]
        assert all(quant_plan(1, L, bits, c).slab < quant.SLAB_MIN
                   for c in wider)


@pytest.mark.parametrize("bits", WIDTHS)
def test_quant_plan_raises_with_the_numbers(bits):
    """A row past the registers of 16 CTAs (or of one) streams now; the
    limit left is the kernel's int32 index."""
    L = 16 * quant.SLAB_MAX + 1
    assert quant_plan(1, L, bits).variant == "stream"
    assert quant_plan(1, quant.SLAB_MAX + 4, bits, cluster=1).variant == \
        "stream"
    assert quant_plan(1, quant.SLAB_MAX, bits, cluster=1).variant == \
        "registers"
    L = quant.INDEX_MAX + 1
    with pytest.raises(ValueError, match=f"a row of L={L}") as exc:
        quant_plan(1, L, bits)
    assert "int32" in str(exc.value) and str(quant.INDEX_MAX) in \
        str(exc.value)
    with pytest.raises(ValueError, match="cluster must be one of"):
        quant_plan(1, 64, bits, cluster=3)
    with pytest.raises(ValueError, match="empty stack"):
        quant_plan(0, 64, bits)


# -- K4 ---------------------------------------------------------------------

@pytest.mark.parametrize("cluster", CLUSTERS)
def test_topk_slabs_cover_the_row_exactly(cluster):
    for L in LENGTHS:
        try:
            plan = topk_plan(2, L, 1, cluster)
        except ValueError as exc:        # 60000 patterns in one CTA
            assert cluster == 1 and "shared memory" in str(exc)
            continue
        S = plan.slab
        assert S % 4 == 0 and S - -(-L // plan.cluster) < 4
        bounds = [(min(r * S, L), min((r + 1) * S, L))
                  for r in range(plan.cluster)]
        assert [i for lo, hi in bounds for i in range(lo, hi)] == \
            list(range(L))


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("ratio", [1, 8, 125])
def test_topk_plan_shared_bytes_fit(cluster, ratio):
    for L in LENGTHS:
        k = -(-L // ratio)
        try:
            plan = topk_plan(8, L, k, cluster)
        except ValueError as exc:
            assert cluster is not None and "shared memory" in str(exc)
            continue
        assert plan.shared_bytes <= topk.SHARED_LIMIT
        assert plan.shared_bytes == topk.shared_bytes(
            plan.slab, k, plan.cluster, plan.survivors, plan.patterns)


def test_topk_shared_bytes_layout():
    # the main path: patterns 8 KB (the gathered 2048 keys and 2048
    # counts overlay them: 24 KB), 2048 survivor slots twice (compacted
    # and sorted), 8 peers' 1 KB histograms in two parities, its own two,
    # 512 B of scratch
    assert topk.shared_bytes(2048, 2048, 8) == (
        8 * 2048 + 4 * 2048 + 2 * 8 * 2048 + 2 * 8 * 1024 + 2048 + 512)
    # one CTA holding a 4097 row and keeping all of it: 4096 keys
    # gathered at a time, the survivor slots a power of two (8192)
    assert topk.shared_bytes(4100, 4097, 1) == (
        8 * 4096 + 4 * 8192 + 2 * 8 * 8192 + 2 * 1024 + 2048 + 512)
    assert topk.shared_bytes(4, 1, 1) == 32 + 2 * 16 + 2048 + 2048 + 512


def test_topk_plan_at_the_main_path_shape():
    plan = topk_plan(8, 16384, 2048)
    assert plan == TopkPlan(cluster=8, slab=2048,
                            shared_bytes=topk.shared_bytes(2048, 2048, 8))
    assert topk_plan(8, 16384, 16384).cluster == 8


@pytest.mark.parametrize("L,k", [(1, 1), (5, 3), (1001, 126), (2000, 2000),
                                 (4000, 500)])
def test_topk_plan_takes_one_cta_for_a_short_row(L, k):
    assert topk_plan(8, L, k).cluster == 1


@pytest.mark.parametrize("L,k,cluster", [
    (2**31, 1, None),                 # past the int32 row index
    (2**31, 2**31, 16),
    (2**31 - 1, 2**31 - 1, 1),        # 2^31 - 1 survivors in one CTA
])
def test_topk_plan_raises_with_the_numbers(L, k, cluster):
    """Rows that need more than 227 KB a CTA take the device form now
    (a row of 10^6 at k = 1, 20000 keeping 20000 at C = 1, 300000
    keeping 300000 at C = 16); what is refused is a row past int32 and
    a CTA with more than 2^30 survivors to sort."""
    for L_, k_, c_ in ((1_000_000, 1, None), (20000, 20000, 1),
                       (300000, 300000, 16)):
        assert topk_plan(1, L_, k_, c_).survivors == "device"
    with pytest.raises(ValueError, match="int32|survivors") as exc:
        topk_plan(1, L, k, cluster)
    msg = str(exc.value)
    assert f"L={L}" in msg and f"k={k}" in msg
    assert str(topk.INDEX_MAX) in msg or str(topk.SURVIVORS_MAX) in msg


def test_topk_plan_refuses_what_it_cannot_take():
    with pytest.raises(ValueError, match="cluster must be one of"):
        topk_plan(1, 64, 4, cluster=32)
    with pytest.raises(ValueError, match="1 <= k <= L"):
        topk_plan(1, 64, 65)
    with pytest.raises(ValueError, match="empty stack"):
        topk_plan(1, 0, 1)


def test_topk_plan_admits_rows_past_the_one_cta_limit():
    """The one-CTA design refused L = 60000; its slabs fit now."""
    for k in (1, 7500, 60000):
        plan = topk_plan(2, 60000, k)
        assert plan.cluster == 16 and plan.shared_bytes <= topk.SHARED_LIMIT


# -- the grid forms (long rows) ---------------------------------------------

LEAF = 22 * 2048 * 5632                   # tinyllama's largest leaf
# (K, L, bits) of the transformer rows' largest leaves: tinyllama's under
# virtual_round and at one NCCL rank, mamba2's int8 and ef:int4 rows,
# deepseek's, whisper's ef:int2
LEAF_ROWS = [(4, LEAF, 8), (1, LEAF, 8), (4, 649789440, 8),
             (4, 433192960, 4), (4, 117440512, 8), (4, 19955712, 2)]
GRID_LENGTHS = [1, 3, 5, 4095, 4097, 8191, 8193, 60001, 100003]


def grid_pass_reads(L, G, tile, offset):
    """The elements each CTA of a grid-form pass over a row reads, as
    csrc/topk_grid.cu's topk_grid_pass and csrc/quant.cu's
    quant_grid_absmax take them (``tile`` 4096 both): a scalar head up
    to the row's first 16-byte boundary (the row starts ``offset``
    floats past one) and a scalar tail of fewer than 4 elements, both by
    CTA 0; then the tiles of ``tile`` elements (float4 loads), tile t by
    CTA t mod G."""
    head = min(L, (4 - offset % 4) % 4)
    nvec = (L - head) // 4
    reads = [list(range(head)) + list(range(head + 4 * nvec, L))]
    reads += [[] for _ in range(G - 1)]
    vec = tile // 4
    for t in range(-(-nvec // vec)):
        q0, q1 = t * vec, min((t + 1) * vec, nvec)
        reads[t % G].extend(range(head + 4 * q0, head + 4 * q1))
    return reads


@pytest.mark.parametrize("K", [1, 4, 8])
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_grid_passes_read_each_element_once(K, offset):
    """K4's passes over x and K2's absmax pass: every element of the row
    once, for any alignment of the row; G at most ceil(4224 / K)."""
    for L in GRID_LENGTHS:
        plan = topk_plan(K, L, 1, grid=True)
        qplan = quant_plan(K, L, 8, grid=True)
        for G, tile in ((plan.ctas, topk.GRID_TILE),
                        (qplan.ctas_absmax, quant.GRID_TILE)):
            assert 1 <= G <= -(-4224 // K) and G <= -(-L // tile)
            reads = grid_pass_reads(L, G, tile, offset)
            assert len(reads) == G
            assert sorted(i for r in reads for i in r) == list(range(L))


@pytest.mark.parametrize("bits", WIDTHS)
@pytest.mark.parametrize("K", [1, 4, 8])
def test_quant_grid_byte_tiles_cover_each_byte_once(bits, K):
    """K2's pack kernel: tile t of 4096 output bytes by CTA t mod G; byte
    j packs elements j, j + W, ... (the cluster form's pairing), so the
    tiles read each element of the row once."""
    per = 8 // bits
    for L in GRID_LENGTHS:
        plan = quant_plan(K, L, bits, grid=True)
        W = -(-L // per)
        assert plan.variant == "grid" and plan.cluster == 0
        assert (plan.span, plan.slab) == (quant.GRID_TILE,
                                          quant.GRID_TILE * per)
        assert plan.ctas_pack == quant.grid_ctas(K, W)
        owned = [[] for _ in range(plan.ctas_pack)]
        for t in range(-(-W // quant.GRID_TILE)):
            owned[t % plan.ctas_pack].extend(
                range(t * quant.GRID_TILE, min((t + 1) * quant.GRID_TILE, W)))
        assert sorted(j for o in owned for j in o) == list(range(W))
        read = sorted(j + p * W for o in owned for j in o for p in range(per)
                      if j + p * W < L)
        assert read == list(range(L))


@pytest.mark.parametrize("K,L,k", [(4, LEAF, 2537554), (1, LEAF, 2537554),
                                   (8, 350000, 43750), (2, 5, 5),
                                   (3, 2**23, 1), (8, 2**23, 2**23)])
def test_topk_grid_scratch_follows_its_formula(K, L, k):
    """256-byte-aligned parts: every row's state and six histograms, k
    survivor keys a row, max(k, 2 cap) keys a row of work space, cap =
    min(L, 2^22); ceil(log2(ceil(k / 4096))) merge rounds."""
    plan = topk_plan(K, L, k, grid=True)

    def up(b):
        return -(-b // 256) * 256
    cap = min(L, 2**22)
    assert (plan.form, plan.cluster, plan.cap) == ("grid", 0, cap)
    assert plan.scratch_bytes == (up(4 * K * (64 + 6 * 2048))
                                  + up(8 * K * k)
                                  + up(8 * K * max(k, 2 * cap)))
    assert plan.merges == max(0, math.ceil(math.log2(-(-k // 4096))))
    assert plan.variant == f"grid of {plan.ctas} CTAs a row"


def test_topk_grid_scratch_at_the_leaf_is_below_a_gigabyte():
    """tinyllama's leaf under virtual_round, k = 2,537,554: 349,835,008
    B of scratch, where the cluster form's was K*C*scratch_words*8 =
    5,368,709,120."""
    k = get_codec("topk(r=0.01)")._k(LEAF)
    assert k == 2537554
    plan = topk_plan(4, LEAF, k)
    assert plan.form == "grid" and plan.scratch_bytes == 349835008
    old = topk_plan(4, LEAF, k, survivors="device")
    assert 4 * old.cluster * old.scratch_words * 8 == 5368709120


@pytest.mark.parametrize("K,L,bits", LEAF_ROWS)
def test_leaf_rows_plan_the_grid_forms(K, L, bits):
    plan = quant_plan(K, L, bits)
    assert plan.variant == "grid"
    assert plan.ctas_absmax == plan.ctas_pack == -(-4224 // K)
    k = -(-L // 100)
    assert topk_plan(K, L, k).form == "grid"
    assert topk_plan(K, L, k).ctas == -(-4224 // K)


@pytest.mark.parametrize("K", [1, 4, 8])
def test_grid_rule_switches_at_the_measured_lengths(K):
    """The cluster forms below ``GRID_MIN_LEN``, the grid forms from it on
    (the card timings in each ``takes_grid``'s docstring)."""
    for L, want in ((topk.GRID_MIN_LEN - 1, "cluster"),
                    (topk.GRID_MIN_LEN, "grid")):
        assert topk_plan(K, L, -(-L // 100)).form == want
    for L, k, want in ((topk.GRID_MIN_LEN_K, topk.GRID_MIN_K - 1, "cluster"),
                       (topk.GRID_MIN_LEN_K, topk.GRID_MIN_K, "grid"),
                       (topk.GRID_MIN_LEN_K - 1, topk.GRID_MIN_K, "cluster")):
        assert topk_plan(K, L, k).form == want
    for L, want in ((quant.GRID_MIN_LEN - 1, False),
                    (quant.GRID_MIN_LEN, True)):
        for bits in WIDTHS:
            assert (quant_plan(K, L, bits).variant == "grid") == want


def test_main_path_keeps_the_cluster_forms_webspam_k4_the_grid():
    """The main path's K2 and K4 and webspam's K2 keep their cluster
    forms; webspam's ef:topk row (k = 43,750) takes K4's grid form,
    which the card timed faster there at K = 1, 4 and 8 (takes_grid)."""
    assert topk_plan(8, 16384, 2048).form == "cluster"
    assert topk_plan(8, 16384, 16384).form == "cluster"
    assert topk_plan(8, 350000, 43750).form == "grid"
    assert topk_plan(8, 350000, 3500).form == "cluster"
    assert topk_plan(8, 349999, 43750).form == "cluster"
    for bits in WIDTHS:
        assert quant_plan(8, 16384, bits).variant == "registers"
        assert quant_plan(8, 350000, bits).variant == "registers"


def test_grid_plans_refuse_what_they_cannot_take():
    with pytest.raises(ValueError, match="grid=True takes no cluster"):
        topk_plan(1, 5000, 50, cluster=16, grid=True)
    with pytest.raises(ValueError, match="grid=True takes no cluster"):
        topk_plan(1, 5000, 50, survivors="device", grid=True)
    with pytest.raises(ValueError, match="grid=True takes no cluster"):
        quant_plan(1, 5000, 8, cluster=16, grid=True)
    with pytest.raises(ValueError, match="at most 65535 rows"):
        topk_plan(65536, 8, 1, grid=True)
    with pytest.raises(ValueError, match="at most 65535 rows"):
        quant_plan(65536, 8, 8, grid=True)
    # grid=False keeps the cluster forms where the rule would not
    assert topk_plan(1, LEAF, 1, grid=False).form == "cluster"
    assert quant_plan(1, LEAF, 8, grid=False).variant == "stream"


# -- the launcher cache -----------------------------------------------------

def test_launcher_is_resolved_once(monkeypatch):
    looked_up = []

    class Lib:
        def __getattr__(self, name):
            looked_up.append(name)
            return types.SimpleNamespace(argtypes=None, restype=None)

    monkeypatch.setattr(_build, "library", lambda: Lib())
    monkeypatch.setattr(_build, "_FUNCTIONS", {})
    first = _build.function("quant_launch", quant._LAUNCH)
    for _ in range(3):
        assert _build.function("quant_launch", quant._LAUNCH) is first
    assert first.argtypes == quant._LAUNCH
    assert _build.function("topk_launch", topk._LAUNCH).argtypes == \
        topk._LAUNCH
    assert looked_up == ["quant_launch", "topk_launch"]


# -- the wrappers on CPU tensors ------------------------------------------

@pytest.mark.parametrize("name", ["int8", "int4", "int2"])
@pytest.mark.parametrize("cluster", [None, 16, 1])
def test_quantize_on_cpu_is_the_reference_encode(name, cluster):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((3, 1001)).astype(np.float32)
    enc = getattr(quant, f"quantize_pack_{name}")
    before = enc.launches
    payload, scale = enc(torch.tensor(x), cluster=cluster)
    assert enc.launches == before                     # no kernel launched
    ref = get_codec_ref(name)
    for k in range(3):
        p_r, s_r = ref.encode_ref(jnp.asarray(x[k]))
        np.testing.assert_array_equal(payload[k].numpy(), np.asarray(p_r))
        assert scale[k].numpy().view(np.int32) == \
            np.asarray(s_r, np.float32).view(np.int32)


@pytest.mark.parametrize("cluster", [None, 16, 1])
def test_topk_select_on_cpu_is_lax_top_k(cluster):
    rng = np.random.default_rng(4)
    x = rng.integers(-3, 4, (3, 1001)).astype(np.float32)   # heavy ties
    before = topk_select.launches
    vals, idx, thr = topk_select(torch.tensor(x), 126, cluster=cluster)
    assert topk_select.launches == before
    mags, order = lax.top_k(jnp.abs(jnp.asarray(x)), 126)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(order))
    np.testing.assert_array_equal(vals.numpy(),
                                  np.take_along_axis(x, np.asarray(order), 1))
    np.testing.assert_array_equal(thr.numpy(), np.asarray(mags)[:, -1])
