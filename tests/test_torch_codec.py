"""The port's int8 codec (kernels K2 and K3's plain versions on the CPU),
its byte model and its exchange grammar against the reference. The
int8 encode and decode+reduce are held bit-identical. The int4, int2 and
``ef:`` codecs are in ``test_torch_codec_lowbit.py``, the topk codec in
``test_torch_topk.py`` and the regimes of the exchange in
``test_torch_exchange.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import collectives as coll_ref
from repro.comm.codec import get_codec as get_codec_ref
from repro.core import distributed as dist_ref
from repro.kernels.ref import decode_stacked_ref as decode_ref
from repro.kernels.ref import quantize_pack_int8_ref as encode_ref
from repro_torch.comm import collectives as coll
from repro_torch.comm.codec import get_codec
from repro_torch.core import distributed as dist
from repro_torch.kernels.dequant import decode_reduce_int8
from repro_torch.kernels.quant import quantize_pack_int8
from repro_torch.kernels.ref import decode_stacked_ref

LENGTHS = [1, 2, 127, 128, 129, 1000, 1001]


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _update(kind, L, seed):
    rng = np.random.default_rng(seed)
    if kind == "zeros":
        return np.zeros(L, np.float32)
    if kind == "single":
        x = np.zeros(L, np.float32)
        x[L // 2] = -1.7
        return x
    scale = {"normal": 1.0, "tiny": 1e-6, "huge": 1e6}[kind]
    return (rng.standard_normal(L) * scale).astype(np.float32)


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("kind", ["normal", "tiny", "huge", "zeros", "single"])
def test_int8_encode_bit_identical(L, kind):
    x = _update(kind, L, seed=L)
    q_r, s_r = encode_ref(jnp.asarray(x))
    q, s = get_codec("int8").encode(torch.tensor(x))
    assert q.dtype == torch.int8 and q.shape == (L,) and s.shape == ()
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(s_r))


def test_int8_encode_batched_rows_equal_per_row_reference():
    xs = np.stack([_update(k, 1001, seed=i) for i, k in
                   enumerate(["normal", "zeros", "tiny", "single"])])
    q, s = quantize_pack_int8(torch.tensor(xs))
    assert q.shape == (4, 1001) and s.shape == (4,)
    for k in range(4):
        q_r, s_r = encode_ref(jnp.asarray(xs[k]))
        np.testing.assert_array_equal(q[k].numpy(), np.asarray(q_r))
        np.testing.assert_array_equal(_bits(s[k].numpy()), _bits(s_r))


@pytest.mark.parametrize("K", [1, 3, 4, 8])
@pytest.mark.parametrize("L", [128, 1001])
@pytest.mark.parametrize("mean", [False, True])
def test_int8_decode_reduce_bit_identical(K, L, mean):
    rng = np.random.default_rng(K * L)
    xs = (rng.standard_normal((K, L)) * rng.uniform(1e-3, 10, (K, 1))
          ).astype(np.float32)
    parts_r = [encode_ref(jnp.asarray(x)) for x in xs]
    q = np.stack([np.asarray(p[0]) for p in parts_r])
    s = np.stack([np.asarray(p[1]) for p in parts_r])
    want = decode_ref("int8", (jnp.asarray(q), jnp.asarray(s)), L, mean=mean)
    codec = get_codec("int8")
    parts = (torch.tensor(q), torch.tensor(s))
    got = (codec.decode_stacked_mean(parts, L) if mean
           else codec.decode_stacked_sum(parts, L))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(
        _bits(decode_stacked_ref("int8", parts, L, mean=mean).numpy()),
        _bits(want))
    np.testing.assert_array_equal(
        _bits(decode_reduce_int8(*parts, L, mean=mean).numpy()), _bits(want))
    ref_codec = get_codec_ref("int8")
    np.testing.assert_array_equal(
        codec.decode_stacked(parts, L).numpy(),
        np.asarray(ref_codec.decode_stacked((q, s), L)))
    np.testing.assert_array_equal(
        codec.decode((parts[0][0], parts[1][0]), L).numpy(),
        np.asarray(ref_codec.decode((q[0], s[0]), L)))


def test_f32_codec_is_the_identity():
    x = torch.tensor(np.random.default_rng(0).standard_normal((3, 50)),
                     dtype=torch.float32)
    codec = get_codec("f32")
    parts = codec.encode(x)
    assert parts[0] is x and codec.lossless
    np.testing.assert_allclose(codec.decode_stacked_sum(parts, 50).numpy(),
                               x.sum(0).numpy())
    np.testing.assert_allclose(codec.decode_stacked_mean(parts, 50).numpy(),
                               x.mean(0).numpy())


@pytest.mark.parametrize("name", ["f32", "int8", "int4", "int2", "ef:int8",
                                  "ef:int4", "ef:int2", "topk",
                                  "topk(r=0.125)", "ef:topk(r=0.125)"])
@pytest.mark.parametrize("L", [1, 2, 3, 5, 96, 1001, 16384])
def test_wire_bytes_equal(name, L):
    assert get_codec(name).wire_bytes(L) == get_codec_ref(name).wire_bytes(L)


@pytest.mark.parametrize("scheme", ["persistent", "spark_faithful",
                                    "reduce_scatter", "compressed",
                                    "compressed:int8", "compressed:f32",
                                    "compressed:int4", "compressed:int2",
                                    "compressed:ef:int4",
                                    "compressed:ef:int2",
                                    "compressed:topk(r=0.125)",
                                    "compressed:ef:topk"])
@pytest.mark.parametrize("m,K,n_pad", [(96, 4, 64), (16384, 8, 4096),
                                       (1001, 3, 17)])
def test_bytes_per_round_equal(scheme, m, K, n_pad):
    ours = dist.CommScheme.parse(scheme)
    ref = dist_ref.CommScheme.parse(scheme)
    assert ours.transport == ref.transport
    assert ours.codec.name == ref.codec.name
    want = ref.bytes_per_round(m, K, local_state_len=K * n_pad)
    assert ours.bytes_per_round(m, K, local_state_len=K * n_pad) == want
    assert coll.wire_bytes(ours.transport, ours.codec, m, K,
                           local_state_len=K * n_pad) == \
        coll_ref.get_backend("xla").wire_bytes(
            ref.transport, ref.codec, m, K, local_state_len=K * n_pad) == want
    assert coll.padded_len(m, K) == coll_ref.padded_len(m, K)


@pytest.mark.parametrize("scheme,nbytes", [
    ("persistent", 3072), ("compressed:int8", 800),
    ("compressed:int4", 416), ("compressed:ef:int4", 416),
    ("compressed:int2", 224), ("compressed:ef:int2", 224),
    ("compressed:topk(r=0.125)", 800), ("compressed:ef:topk(r=0.125)", 800)])
def test_smoke_shape_bytes_per_round(scheme, nbytes):
    """The byte counts at the drivers benchmark's smoke shape (m=96,
    K=4): 2*K*(wire bytes of a 96-element update); topk keeps 12 of the
    96 entries, 8*12 + 4 bytes."""
    assert dist.CommScheme(scheme).bytes_per_round(96, 4, 256) == nbytes
    assert dist_ref.CommScheme(scheme).bytes_per_round(
        96, 4, local_state_len=256) == nbytes


@pytest.mark.parametrize("name", ["topk", "topk(r=0.1)", "ef:topk"])
def test_unported_codecs_raise_not_implemented(name):
    """The codecs the port once refused (it had no topk) are ported:
    each resolves like the reference's, to one cached object, and the
    scheme around it parses."""
    ref, ours = get_codec_ref(name), get_codec(name)
    assert (ours.name, ours.stateful, ours.lossless) == (
        ref.name, ref.stateful, ref.lossless)
    assert get_codec(name) is ours
    base, base_ref = getattr(ours, "base", ours), getattr(ref, "base", ref)
    assert base.r == base_ref.r and base._k(1001) == base_ref._k(1001)
    assert dist.CommScheme(f"compressed:{name}").codec is ours


@pytest.mark.parametrize("name", ["int3", "float16", ""])
def test_unknown_codecs_raise_value_error(name):
    with pytest.raises(ValueError):
        get_codec(name)


@pytest.mark.parametrize("spec", ["persistent", "compressed:int8", "compressed",
                                  "reduce_scatter/sync", "sync/spark_faithful",
                                  "compressed:f32/sync", "compressed:int4",
                                  "sync/compressed:ef:int2"])
def test_exchange_spec_matches_reference(spec):
    ours = dist.ExchangeConfig.parse(spec)
    ref = dist_ref.ExchangeConfig.parse(spec)
    assert ours.spec == ref.spec
    assert dist.ExchangeConfig.parse(ours.spec) == ours
    assert ours.scheme.name == ref.scheme.name
    assert ours.mode.spec == ref.mode.spec


@pytest.mark.parametrize("spec", ["persistent/stale", "compressed:int8/stale:k=2",
                                  "persistent/drop:1@5",
                                  "persistent/straggler:mix(p=0.1,slow=8)",
                                  "persistent/ring"])
def test_exchange_segments_parse_like_the_reference(spec):
    """The stale, drop, straggler and backend segments the port once
    refused parse like the reference's."""
    ref = dist_ref.ExchangeConfig.parse(spec)
    ours = dist.ExchangeConfig.parse(spec)
    assert ours.spec == ref.spec
    assert ours.backend == ref.backend
    assert (ours.mode.name, ours.mode.k) == (ref.mode.name, ref.mode.k)
    assert ours.membership.events == ref.membership.events
    assert ours.straggler.spec == ref.straggler.spec


@pytest.mark.parametrize("spec", ["bogus", "persistent/persistent",
                                  "sync/sync", "persistent:int8"])
def test_bad_exchange_specs_raise_value_error(spec):
    with pytest.raises(ValueError):
        dist.ExchangeConfig.parse(spec)
