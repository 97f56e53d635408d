"""The port's int4 and int2 codecs (kernels K2 and K3's plain versions on
the CPU) and the ``ef:`` error-feedback wrapper against the reference.

The encode is held bit-identical to the reference's EAGER
``encode_ref``. Against the reference's Pallas quantize kernels (run in
interpret mode under ``jax.jit``) the payload is equal and the scale is
held within 1 ulp: under ``jit`` XLA on the CPU rewrites ``absmax / 7.5``
as a multiply by the reciprocal, so the jitted int4 scale can sit one ulp
from the IEEE quotient that the eager reference, the port and its CUDA
kernel all take. decode+reduce is bit-identical to both the eager
``decode_stacked_ref`` and the interpret-mode kernels, and
``encode_with_state`` to the eager ``vmap`` of the reference's
``EFWrapper.encode_with_state``, parts and residual.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm.codec import get_codec as get_codec_ref
from repro.core import distributed as dist_ref
from repro.kernels import dequant as dequant_ref
from repro.kernels import quant as quant_ref
from repro.kernels.ref import decode_stacked_ref as decode_ref
from repro_torch.comm.codec import EFWrapper, get_codec
from repro_torch.core import distributed as dist
from repro_torch.kernels import dequant, quant
from repro_torch.kernels.ref import decode_stacked_ref

LENGTHS = [1, 2, 3, 4, 5, 127, 128, 129, 1000, 1001, 16384]
KINDS = ["normal", "tiny", "huge", "zeros", "single"]
LOWBIT = ["int4", "int2"]


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


def _ref_stack(name, xs):
    """The reference's eager per-worker encode of each row, stacked."""
    parts = [get_codec_ref(name).encode_ref(jnp.asarray(x)) for x in xs]
    return (np.stack([np.asarray(p) for p, _ in parts]),
            np.stack([np.asarray(s) for _, s in parts]))


@pytest.mark.parametrize("name", LOWBIT)
@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("kind", KINDS)
def test_lowbit_encode_bit_identical_to_eager_reference(name, L, kind):
    x = _update(kind, L, seed=L)
    p_r, s_r = get_codec_ref(name).encode_ref(jnp.asarray(x))
    codec = get_codec(name)
    p, s = codec.encode(torch.tensor(x))
    width = -(-L // (2 if name == "int4" else 4))
    assert p.dtype == torch.uint8 and p.shape == (width,) and s.shape == ()
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_r))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(s_r))
    # the round trip through the codec's own decode is the reference's
    np.testing.assert_array_equal(
        _bits(codec.decode((p, s), L).numpy()),
        _bits(get_codec_ref(name).decode((p_r, s_r), L)))


@pytest.mark.parametrize("name", LOWBIT)
@pytest.mark.parametrize("L", [3, 1001])
def test_lowbit_encode_batched_rows_equal_per_row_reference(name, L):
    xs = np.stack([_update(k, L, seed=i) for i, k in enumerate(KINDS)])
    p, s = getattr(quant, f"quantize_pack_{name}")(torch.tensor(xs))
    p_r, s_r = _ref_stack(name, xs)
    assert p.shape == p_r.shape and s.shape == (len(KINDS),)
    np.testing.assert_array_equal(p.numpy(), p_r)
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(s_r))
    np.testing.assert_array_equal(
        _bits(get_codec(name).decode_stacked((p, s), L).numpy()),
        _bits(get_codec_ref(name).decode_stacked((p_r, s_r), L)))


@pytest.mark.parametrize("name", LOWBIT)
@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("kind", ["normal", "single"])
def test_lowbit_encode_against_interpret_kernel(name, L, kind):
    """Payload equal, scale within 1 ulp (the reciprocal rewrite under
    ``jit``; see the module docstring)."""
    x = _update(kind, L, seed=L + 1)
    p_k, s_k = getattr(quant_ref, f"quantize_pack_{name}")(
        jnp.asarray(x), interpret=True)
    p, s = get_codec(name).encode(torch.tensor(x))
    np.testing.assert_array_equal(p.numpy(), np.asarray(p_k))
    assert abs(int(_bits(s.numpy())) - int(_bits(s_k))) <= 1


@pytest.mark.parametrize("name", LOWBIT)
@pytest.mark.parametrize("K", [1, 3, 4, 8])
@pytest.mark.parametrize("L", [5, 1001])
@pytest.mark.parametrize("mean", [False, True])
def test_lowbit_decode_reduce_bit_identical(name, K, L, mean):
    rng = np.random.default_rng(K * L)
    xs = (rng.standard_normal((K, L)) * rng.uniform(1e-3, 10, (K, 1))
          ).astype(np.float32)
    q, s = _ref_stack(name, xs)
    want = decode_ref(name, (jnp.asarray(q), jnp.asarray(s)), L, mean=mean)
    kernel = getattr(dequant_ref, f"decode_reduce_{name}")(
        jnp.asarray(q), jnp.asarray(s), L, mean=mean, interpret=True)
    np.testing.assert_array_equal(_bits(kernel), _bits(want))
    codec = get_codec(name)
    parts = (torch.tensor(q), torch.tensor(s))
    got = (codec.decode_stacked_mean(parts, L) if mean
           else codec.decode_stacked_sum(parts, L))
    assert got.shape == (L,)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    np.testing.assert_array_equal(
        _bits(decode_stacked_ref(name, parts, L, mean=mean).numpy()),
        _bits(want))
    np.testing.assert_array_equal(
        _bits(getattr(dequant, f"decode_reduce_{name}")(
            *parts, L, mean=mean).numpy()), _bits(want))


@pytest.mark.parametrize("base", ["int8", "int4", "int2"])
@pytest.mark.parametrize("K,L", [(1, 1), (4, 1001), (3, 16384)])
def test_ef_encode_with_state_bit_identical(base, K, L):
    """Three chained rounds, each feeding its residual into the next."""
    ref = get_codec_ref(f"ef:{base}")
    codec = get_codec(f"ef:{base}")
    rng = np.random.default_rng(K + L)
    state_r = np.zeros((K, L), np.float32)
    state = torch.zeros((K, L))
    for _ in range(3):
        dv = rng.standard_normal((K, L)).astype(np.float32)
        (p_r, s_r), state_r = jax.vmap(ref.encode_with_state)(
            jnp.asarray(dv), jnp.asarray(state_r))
        (p, s), state = codec.encode_with_state(torch.tensor(dv), state)
        np.testing.assert_array_equal(p.numpy(), np.asarray(p_r))
        np.testing.assert_array_equal(_bits(s.numpy()), _bits(s_r))
        np.testing.assert_array_equal(_bits(state.numpy()), _bits(state_r))
    # one worker's (L,) update takes the same path
    (p1, s1), st1 = codec.encode_with_state(torch.tensor(dv[0]),
                                            torch.zeros(L))
    (p1_r, s1_r), st1_r = ref.encode_with_state(jnp.asarray(dv[0]),
                                                jnp.zeros(L))
    np.testing.assert_array_equal(p1.numpy(), np.asarray(p1_r))
    np.testing.assert_array_equal(_bits(st1.numpy()), _bits(st1_r))


def test_ef_state_protocol_matches_reference():
    for name in ["f32", "int8", "int4", "int2", "ef:int8", "ef:int4",
                 "ef:int2"]:
        ours, ref = get_codec(name), get_codec_ref(name)
        assert (ours.name, ours.stateful, ours.lossless) == (
            ref.name, ref.stateful, ref.lossless)
        assert tuple(ours.init_state(7).shape) == ref.init_state(7).shape
        x = torch.ones((2, 7))
        if not ours.stateful:
            parts, st = ours.encode_with_state(x, torch.zeros((2, 0)))
            assert st.shape == (2, 0)
            assert all(a.equal(b) for a, b in zip(parts, ours.encode(x)))
    ef = get_codec("ef:int4")
    assert isinstance(ef, EFWrapper) and ef.base is get_codec("int4")
    assert get_codec("ef:int4") is ef                   # cached: one object


@pytest.mark.parametrize("name", ["ef:ef:int4", "ef:f32", "ef:bogus", "ef:"])
def test_ef_grammar_value_errors(name):
    """The reference's typed errors; those of ``ef:topk(..)`` with a bad
    argument are in ``test_torch_topk.py``."""
    with pytest.raises(ValueError):
        get_codec_ref(name)
    with pytest.raises(ValueError):
        get_codec(name)


@pytest.mark.parametrize("spec", ["compressed:int4", "compressed:ef:int2",
                                  "persistent"])
def test_local_state_slot_matches_reference(spec):
    alpha = np.arange(6, dtype=np.float32).reshape(2, 3)
    ours = dist.wrap_local_state(spec, torch.tensor(alpha), 5, 2)
    ref = dist_ref.wrap_local_state(spec, jnp.asarray(alpha), 5, 2)
    if isinstance(ref, tuple):
        assert isinstance(ours, tuple)
        for a, b in zip(ours, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        assert ours[1].shape == (2, 5)
    else:
        assert isinstance(ours, torch.Tensor)
        np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    back = dist.unwrap_local_state(spec, ours)
    np.testing.assert_array_equal(back.numpy(), alpha)


@pytest.mark.parametrize("spec", ["compressed:ef:int4", "compressed:ef:int2",
                                  "compressed:int4"])
def test_all_reduce_stacked_with_state_bit_identical(spec):
    rng = np.random.default_rng(3)
    upd = rng.standard_normal((4, 97)).astype(np.float32)
    state = (rng.standard_normal((4, 97)) * 0.1).astype(np.float32)
    ours = dist.CommScheme(spec)
    ref = dist_ref.CommScheme(spec)
    if ours.codec.stateful:
        total, new = ours.all_reduce_stacked(torch.tensor(upd),
                                             torch.tensor(state))
        total_r, new_r = ref.all_reduce_stacked(jnp.asarray(upd),
                                                jnp.asarray(state))
        np.testing.assert_array_equal(_bits(new.numpy()), _bits(new_r))
    else:
        total = ours.all_reduce_stacked(torch.tensor(upd))
        total_r = ref.all_reduce_stacked(jnp.asarray(upd))
    np.testing.assert_array_equal(_bits(total.numpy()), _bits(total_r))


@pytest.mark.parametrize("name", ["int4", "int2"])
def test_lowbit_wrappers_refuse_bad_shapes(name):
    with pytest.raises(ValueError):
        getattr(quant, f"quantize_pack_{name}")(torch.zeros((2, 0)))
    with pytest.raises(ValueError):
        getattr(quant, f"quantize_pack_{name}")(torch.zeros((2, 3, 4)))
    per = 2 if name == "int4" else 4
    with pytest.raises(ValueError, match="payload"):
        getattr(dequant, f"decode_reduce_{name}")(
            torch.zeros((2, 9), dtype=torch.uint8), torch.ones(2), 9 * per + 1)
    with pytest.raises(ValueError, match="scales"):
        getattr(dequant, f"decode_reduce_{name}")(
            torch.zeros((2, 9), dtype=torch.uint8), torch.ones(3), 9 * per)
    with pytest.raises(ValueError):
        decode_stacked_ref("topk", (torch.zeros(1), torch.zeros(1)), 1)
