"""The port's topk codec (kernel K4's plain version on the CPU) against the
reference, bit for bit.

The encode is held to the reference's ``lax.top_k`` oracle
(``TopKCodec.encode_ref``) and to its Pallas ``topk_select`` run in
interpret mode, on ragged lengths, k = 1, ceil(L/8) and L, and rows with
heavy ties, ``±`` pairs of one magnitude, ``-0.0`` entries, all zeros and
a single nonzero. The decode, its stacked form and the stacked sum are
bit-identical to the reference's; the stacked mean is at K = 8 and within
rtol 1e-6 at K = 3. ``ef:topk`` threads its residual bit for bit over
chained rounds. CoCoA under the topk exchanges is in
``test_torch_exchange.py``.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.codec import TopKCodec as RefTopKCodec
from repro.comm.codec import get_codec as get_codec_ref
from repro.kernels.topk import topk_select as pallas_topk_select
from repro_torch.comm.codec import TopKCodec, get_codec
from repro_torch.kernels import topk_select, topk_select_ref

LENGTHS = [1, 2, 3, 127, 128, 129, 1001, 4097]
KINDS = ["normal", "zeros", "single", "ties", "negzero"]


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _ks(L):
    return sorted({1, math.ceil(L / 8), L})


def _row(kind, L, seed):
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        return np.zeros(L, np.float32)
    if kind == "single":
        x = np.zeros(L, np.float32)
        x[L // 2] = -1.7
        return x
    if kind == "ties":
        # integers in [-3, 3]: few magnitudes, each as +x and -x
        return rng.integers(-3, 4, L).astype(np.float32)
    if kind == "negzero":
        # -0.0 and +0.0 everywhere, a nonzero every 7th entry
        x = np.where(rng.random(L) < 0.5, np.float32(-0.0), np.float32(0.0))
        x[::7] = rng.standard_normal(x[::7].shape)
        return x.astype(np.float32)
    return rng.standard_normal(L).astype(np.float32)


def _ref_encode(x, k):
    """The reference's ``encode_ref`` (``lax.top_k``) at a chosen k."""
    codec = RefTopKCodec(1.0)
    codec._k = lambda length: k
    return codec.encode_ref(jnp.asarray(x))


def _assert_same(got, want):
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_topk_encode_bit_identical_to_lax_top_k(L, kind):
    x = _row(kind, L, seed=L)
    for k in _ks(L):
        want = _ref_encode(x, k)
        got = topk_select(torch.tensor(x), k)
        assert got[0].dtype == torch.float32 and got[1].dtype == torch.int32
        assert got[2].shape == ()
        _assert_same(got, want)
        _assert_same(topk_select_ref(torch.tensor(x), k), want)


@pytest.mark.parametrize("L", [1, 2, 3, 127, 128, 129, 1000])
@pytest.mark.parametrize("kind", ["normal", "ties", "negzero", "zeros"])
def test_topk_encode_bit_identical_to_interpret_kernel(L, kind):
    x = _row(kind, L, seed=L + 1)
    for k in _ks(L):
        want = pallas_topk_select(jnp.asarray(x), k, interpret=True)
        _assert_same(topk_select(torch.tensor(x), k), want)


@pytest.mark.parametrize("r", [0.01, 0.125, 1.0])
def test_topk_codec_encode_of_a_stack_equals_per_row_reference(r):
    """The (K, L) stack goes in one call; each row is the reference's
    per-worker encode (its ``vmap`` written out)."""
    xs = np.stack([_row(kind, 1001, seed=i) for i, kind in enumerate(KINDS)])
    codec, ref = get_codec(f"topk(r={r})"), get_codec_ref(f"topk(r={r})")
    vals, idx, thr = codec.encode(torch.tensor(xs))
    k = ref._k(1001)
    assert vals.shape == (len(KINDS), k) and thr.shape == (len(KINDS),)
    for row, x in enumerate(xs):
        _assert_same((vals[row], idx[row], thr[row]),
                     ref.encode_ref(jnp.asarray(x)))
    _assert_same(codec.encode_ref(torch.tensor(xs)), (vals, idx, thr))


def _ref_stack(name, xs):
    parts = [get_codec_ref(name).encode_ref(jnp.asarray(x)) for x in xs]
    return tuple(np.stack([np.asarray(p[i]) for p in parts])
                 for i in range(3))


@pytest.mark.parametrize("K", [1, 3, 8])
@pytest.mark.parametrize("L", [96, 1001])
@pytest.mark.parametrize("kind", ["normal", "negzero"])
def test_topk_decode_bit_identical(K, L, kind):
    name = "topk(r=0.125)"
    xs = np.stack([_row(kind, L, seed=K * L + i) for i in range(K)])
    v, i, t = _ref_stack(name, xs)
    ref, codec = get_codec_ref(name), get_codec(name)
    parts = (torch.tensor(v), torch.tensor(i), torch.tensor(t))
    np.testing.assert_array_equal(
        _bits(codec.decode((parts[0][0], parts[1][0], parts[2][0]),
                           L).numpy()),
        _bits(ref.decode((v[0], i[0], t[0]), L)))
    np.testing.assert_array_equal(
        _bits(codec.decode_stacked(parts, L).numpy()),
        _bits(ref.decode_stacked((v, i, t), L)))
    total = codec.decode_stacked_sum(parts, L)
    assert total.shape == (L,)
    np.testing.assert_array_equal(
        _bits(total.numpy()), _bits(ref.decode_stacked_sum((v, i, t), L)))
    mean = codec.decode_stacked_mean(parts, L).numpy()
    want = np.asarray(ref.decode_stacked_mean((v, i, t), L))
    if K == 3:
        np.testing.assert_allclose(mean, want, rtol=1e-6)
    else:
        np.testing.assert_array_equal(_bits(mean), _bits(want))


def test_topk_decode_enforces_the_threshold():
    """Values below the advertised threshold decode to zero, as in the
    reference: the threshold is consumed, not only carried."""
    codec, ref = get_codec("topk(r=0.5)"), get_codec_ref("topk(r=0.5)")
    v = np.array([3.0, -0.5, 2.0], np.float32)
    i = np.array([4, 0, 2], np.int32)
    t = np.float32(1.0)
    got = codec.decode((torch.tensor(v), torch.tensor(i), torch.tensor(t)), 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref.decode((v, i, t), 6)))
    assert got[0].item() == 0.0 and got[4].item() == 3.0


@pytest.mark.parametrize("K,L", [(1, 1), (4, 1001), (3, 4097)])
def test_ef_topk_encode_with_state_bit_identical(K, L):
    """Five chained rounds, each feeding its residual into the next,
    against the eager ``vmap`` of the reference's ``encode_with_state``."""
    name = "ef:topk(r=0.125)"
    ref, codec = get_codec_ref(name), get_codec(name)
    rng = np.random.default_rng(K + L)
    state_r = np.zeros((K, L), np.float32)
    state = torch.zeros((K, L))
    for _ in range(5):
        dv = rng.standard_normal((K, L)).astype(np.float32)
        parts_r, state_r = jax.vmap(ref.encode_with_state)(
            jnp.asarray(dv), jnp.asarray(state_r))
        parts, state = codec.encode_with_state(torch.tensor(dv), state)
        _assert_same(parts, parts_r)
        np.testing.assert_array_equal(_bits(state.numpy()), _bits(state_r))
    # a live residual, except where k = L keeps everything
    assert (float(np.abs(np.asarray(state_r)).max()) > 0) == (L > 1)


@pytest.mark.parametrize("name", ["topk", "topk()", "topk(0.5)", "topk(r=1)",
                                  "topk(r=0.125)", "ef:topk(r=0.01)"])
def test_topk_grammar_matches_reference(name):
    ours, ref = get_codec(name), get_codec_ref(name)
    assert ours.name == ref.name
    for L in (1, 7, 96, 16384):
        assert ours.wire_bytes(L) == ref.wire_bytes(L)
    base = getattr(ours, "base", ours)
    assert isinstance(base, TopKCodec)


@pytest.mark.parametrize("name", ["topk(r=0)", "topk(r=1.5)", "topk(-0.1)",
                                  "topk(r=abc)", "topk(r=)", "ef:topk(r=2)",
                                  "topk[0.1]"])
def test_topk_grammar_value_errors(name):
    with pytest.raises(ValueError) as want:
        get_codec_ref(name)
    with pytest.raises(ValueError) as got:
        get_codec(name)
    assert str(got.value) == str(want.value)


def test_topk_wrapper_refuses_bad_arguments():
    x = torch.zeros((2, 5))
    for k in (0, 6):
        with pytest.raises(ValueError, match="1 <= k <= L"):
            topk_select(x, k)
    with pytest.raises(ValueError):
        topk_select(torch.zeros((2, 0)), 1)
    with pytest.raises(ValueError):
        topk_select(torch.zeros((2, 3, 4)), 1)
    with pytest.raises(ValueError, match="CUDA"):
        topk_select(torch.zeros(5, device="meta"), 1)
