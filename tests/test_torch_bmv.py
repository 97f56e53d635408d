"""The fixed-order batched products (``repro_torch.kernels.bmv``) on the
CPU, where each wrapper runs its plain version: against the reference's
own products (XLA dots in ``src/repro/core/baselines.py:112-113`` and
``src/repro/core/solvers.py:97``) on the same inputs, and the property
the kernels exist for, that a worker's outputs do not depend on how many
workers share the call.

Tolerance: two sums of the same c products in different orders differ
by at most 2 * gamma_c * sum_j |M_ij x_j|, gamma_c = c u / (1 - c u),
u = 2^-24 (the classical bound on a floating-point dot product).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.kernels import bmv
from repro_torch.kernels.bmv import (batched_matvec, batched_matvec_ref,
                                     batched_vecmat, batched_vecmat_ref)

SHAPES = [(4, 16, 96), (3, 7, 97), (1, 5, 3), (5, 33, 258)]


def _gamma(n: int) -> float:
    u = 2.0 ** -24
    return n * u / (1 - n * u)


def _inputs(K, r, c, per_worker, seed=0):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((K, r, c)).astype(np.float32)
    M[rng.random((K, r, c)) < 0.5] = 0.0          # sparse, as the data are
    v = rng.standard_normal((K, c) if per_worker else (c,)).astype(np.float32)
    return M, v


@pytest.mark.parametrize("per_worker", [False, True])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_matvec_matches_the_reference_dot(shape, per_worker):
    K, r, c = shape
    M, x = _inputs(K, r, c, per_worker)
    got = batched_matvec(torch.from_numpy(M), torch.from_numpy(x)).numpy()
    xs = x if per_worker else np.broadcast_to(x, (K, c))
    want = np.asarray(jnp.einsum("kij,kj->ki", jnp.asarray(M),
                                 jnp.asarray(xs)))
    tol = 2 * _gamma(c) * np.einsum("kij,kj->ki", np.abs(M), np.abs(xs))
    assert got.shape == (K, r) and got.dtype == np.float32
    assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_vecmat_matches_the_reference_dot(shape):
    K, r, c = shape
    rng = np.random.default_rng(1)
    M, _ = _inputs(K, r, c, False)
    y = rng.standard_normal((K, r)).astype(np.float32)
    got = batched_vecmat(torch.from_numpy(y), torch.from_numpy(M)).numpy()
    want = np.asarray(jnp.einsum("ki,kij->kj", jnp.asarray(y),
                                 jnp.asarray(M)))
    tol = 2 * _gamma(r) * np.einsum("ki,kij->kj", np.abs(y), np.abs(M))
    assert got.shape == (K, c) and got.dtype == np.float32
    assert np.all(np.abs(got - want) <= tol)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_a_workers_outputs_do_not_depend_on_K(shape):
    """Worker k's block alone (the sharded driver) gives the bits it
    gives in the stack (the virtual driver)."""
    K, r, c = shape
    M, x = _inputs(K, r, c, True, seed=2)
    M, x = torch.from_numpy(M), torch.from_numpy(x)
    y = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (K, r)).astype(np.float32))
    stack_mv, stack_vm = batched_matvec(M, x), batched_vecmat(y, M)
    for k in range(K):
        one = slice(k, k + 1)
        assert torch.equal(batched_matvec(M[one], x[one])[0].view(torch.int32),
                           stack_mv[k].view(torch.int32))
        assert torch.equal(batched_vecmat(y[one], M[one])[0].view(torch.int32),
                           stack_vm[k].view(torch.int32))


def test_one_vector_equals_its_rows_expanded():
    """Local SGD's first step hands one vector expanded to K rows."""
    M, x = _inputs(4, 16, 96, False, seed=4)
    M, x = torch.from_numpy(M), torch.from_numpy(x)
    assert torch.equal(batched_matvec(M, x), batched_matvec(M, x.expand(4, -1)))


def test_cpu_wrappers_run_the_plain_versions_and_launch_nothing():
    M, x = _inputs(3, 7, 97, True, seed=5)
    M, x = torch.from_numpy(M), torch.from_numpy(x)
    y = x[:, :7].contiguous()
    before = (batched_matvec.launches, batched_vecmat.launches)
    assert torch.equal(batched_matvec(M, x), batched_matvec_ref(M, x))
    assert torch.equal(batched_vecmat(y, M), batched_vecmat_ref(y, M))
    assert (batched_matvec.launches, batched_vecmat.launches) == before


def _z(*shape):
    return torch.zeros(shape)


@pytest.mark.parametrize("call,msg", [
    (lambda: batched_matvec(_z(2, 3), _z(3)), "M must be"),
    (lambda: batched_matvec(_z(2, 3, 4), _z(5)), "vector must be"),
    (lambda: batched_matvec(_z(2, 3, 4), _z(3, 4)), "vector must be"),
    (lambda: batched_vecmat(_z(2, 4), _z(2, 3, 4)), "vector must be"),
    (lambda: batched_vecmat(_z(2, 3), _z(2, 0, 4)), "M must be")])
def test_shapes_are_checked(call, msg):
    with pytest.raises(ValueError, match=msg):
        call()


def test_a_device_that_is_neither_cpu_nor_cuda_is_refused():
    M = torch.zeros((2, 3, 4), device="meta")
    with pytest.raises(ValueError, match="CPU .* or on a CUDA device"):
        bmv.batched_matvec(M, torch.zeros(4, device="meta"))
    with pytest.raises(ValueError, match="CPU .* or on a CUDA device"):
        bmv.batched_vecmat(torch.zeros((2, 3), device="meta"), M)
