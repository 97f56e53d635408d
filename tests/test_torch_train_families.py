"""What training every family needs beyond the dense one, against the
reference on the CPU: the delta exchange's modelled bytes for every
arch's full-width tree, and the reference's last public names of the
CoCoA path (``quantize_update`` / ``dequantize_update``,
``primal_from_state``, ``decode_mean_int{8,4,2}``).

The byte model reads shapes only: the port's tree from ``init(None)``
under ``torch.device("meta")``, the reference's from ``jax.eval_shape``
of its init, so no full-width weight is drawn. The int8 pair and the
decodes are bit for bit (the reference's eager oracle off TPU; its
Pallas decode kernels in interpret mode); ``primal_from_state`` within
f32 rounding of the reference's.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_get_config
from repro.core import distributed as dist_ref
from repro.core import glm as glm_ref
from repro.kernels import dequant as dequant_ref
from repro.kernels.ref import decode_stacked_ref as decode_ref
from repro.models import build_model as ref_build_model
from repro.optim import local_updates as ref_lu
from repro_torch.comm.codec import get_codec
from repro_torch.configs import ARCHS, get_config
from repro_torch.core import (GLMProblem, dequantize_update,
                              primal_from_state, primal_objective,
                              quantize_update)
from repro_torch.kernels import (decode_mean_int2, decode_mean_int4,
                                 decode_mean_int8, dequant)
from repro_torch.models import build_model
from repro_torch.optim import LocalUpdatesConfig, delta_wire_bytes
from repro_torch.utils.trees import tree_leaves

WIRE_CODECS = ("f32", "int8", "ef:int4", "ef:int2", "ef:topk(r=0.01)")
DECODE_MEAN = {"int8": decode_mean_int8, "int4": decode_mean_int4,
               "int2": decode_mean_int2}
KINDS = ("normal", "tiny", "huge", "zeros", "single")


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


@functools.lru_cache(maxsize=None)
def _full_trees(arch):
    """The port's full-width tree on the meta device and the reference's
    shapes, one trace an arch."""
    with torch.device("meta"):
        port = build_model(get_config(arch)).init(None)
    ref = jax.eval_shape(ref_build_model(ref_get_config(arch)).init,
                         jax.random.key(0))
    return port, ref


def test_every_reference_arch_is_ported():
    assert sorted(ARCHS) == sorted(REF_ARCHS)


@pytest.mark.parametrize("codec", WIRE_CODECS)
@pytest.mark.parametrize("arch", ARCHS)
def test_delta_wire_bytes_at_full_width(arch, codec):
    """Every arch's full tree: the same bytes a delta exchange, K 1, 4
    and 8, and the same leaf shapes in the same order."""
    port, ref = _full_trees(arch)
    assert [tuple(p.shape) for p in tree_leaves(port)] == [
        tuple(r.shape) for r in jax.tree.leaves(ref)]
    cfg, ref_cfg = (LocalUpdatesConfig(codec=codec),
                    ref_lu.LocalUpdatesConfig(codec=codec))
    for K in (1, 4, 8):
        assert delta_wire_bytes(port, cfg, K) == ref_lu.delta_wire_bytes(
            ref, ref_cfg, K)


# -- the reference's pre-codec quantizer API --------------------------------

@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("L", [1, 1001, 16384])
def test_quantize_update_bit_identical(kind, L):
    """``quantize_update`` and the round trip through
    ``dequantize_update``: the reference's bits."""
    x = _update(kind, L, seed=L + 3)
    q_r, s_r = dist_ref.quantize_update(jnp.asarray(x))
    q, s = quantize_update(torch.tensor(x))
    assert q.dtype == torch.int8 and q.shape == (L,) and s.shape == ()
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(s_r))
    np.testing.assert_array_equal(
        _bits(dequantize_update(q, s).numpy()),
        _bits(dist_ref.dequantize_update(q_r, s_r)))


def test_quantize_update_of_a_stack_is_the_per_row_reference():
    """A (K, L) stack quantizes row by row, as the reference's ``vmap``
    of ``quantize_update`` does (``tests/test_distributed.py``), and
    dequantizes with the scales as a column."""
    xs = np.stack([_update(k, 1001, seed=i) for i, k in enumerate(KINDS)])
    q_r, s_r = jax.vmap(dist_ref.quantize_update)(jnp.asarray(xs))
    q, s = quantize_update(torch.tensor(xs))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
    np.testing.assert_array_equal(_bits(s.numpy()), _bits(s_r))
    np.testing.assert_array_equal(
        _bits(dequantize_update(q, s[:, None]).numpy()),
        _bits(dist_ref.dequantize_update(q_r, s_r[:, None])))


@pytest.mark.parametrize("eta", [1.0, 0.7, 0.0])
def test_primal_from_state_matches_reference(eta):
    """The objective from the residual and the regularizer's value: the
    reference's within f32 rounding, and the primal objective's."""
    rng = np.random.default_rng(7)
    A = rng.standard_normal((64, 48)).astype(np.float32)
    b = rng.standard_normal(64).astype(np.float32)
    alpha = rng.standard_normal(48).astype(np.float32)
    w = A @ alpha - b
    prob, prob_r = GLMProblem(1.0, eta), glm_ref.GLMProblem(1.0, eta)
    got = primal_from_state(prob, torch.tensor(w),
                            prob.regularizer(torch.tensor(alpha)))
    want = glm_ref.primal_from_state(prob_r, jnp.asarray(w),
                                     prob_r.regularizer(jnp.asarray(alpha)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(
        float(got), float(primal_objective(prob, torch.tensor(A),
                                           torch.tensor(b),
                                           torch.tensor(alpha))),
        rtol=1e-5)


@pytest.mark.parametrize("name", list(DECODE_MEAN))
@pytest.mark.parametrize("K", [1, 3, 4, 8])
@pytest.mark.parametrize("L", [5, 1001])
def test_decode_mean_bit_identical_to_the_interpret_kernels(name, K, L):
    """``decode_mean_int*``: the reference's entries run in interpret
    mode, its eager decode+mean and the port's ``decode_reduce_int*(...,
    mean=True)``, bit for bit."""
    rng = np.random.default_rng(K * L + len(name))
    xs = (rng.standard_normal((K, L)) * rng.uniform(1e-3, 10, (K, 1))
          ).astype(np.float32)
    parts = [get_codec(name).encode_ref(torch.tensor(x)) for x in xs]
    q = torch.stack([p for p, _ in parts])
    s = torch.stack([s for _, s in parts])
    kernel = getattr(dequant_ref, f"decode_mean_{name}")(
        jnp.asarray(q.numpy()), jnp.asarray(s.numpy()), L, interpret=True)
    eager = decode_ref(name, (jnp.asarray(q.numpy()),
                              jnp.asarray(s.numpy())), L, mean=True)
    got = DECODE_MEAN[name](q, s, L)
    assert got.shape == (L,) and got.dtype == torch.float32
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(kernel))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(eager))
    np.testing.assert_array_equal(
        _bits(got.numpy()),
        _bits(getattr(dequant, f"decode_reduce_{name}")(
            q, s, L, mean=True).numpy()))
