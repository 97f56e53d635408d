"""The port's plain SCD solvers (kernel K1's plain version) against the
reference's, on the CPU, with the same index stream. The tolerance is
the reference's own kernel-vs-oracle one (rtol 1e-4, atol 1e-5): the
dot products are summed in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.solvers import scd_steps_fixed_point as fixed_ref
from repro.kernels.ref import scd_steps_ref
from repro_torch.core.solvers import scd_steps, scd_steps_fixed_point
from repro_torch.kernels.ops import scd_steps_kernel

TOL = dict(rtol=1e-4, atol=1e-5)


def _mk(m, n, H, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((m, n)).astype(np.float32)
    colsq = np.sum(A ** 2, axis=0)
    alpha = (rng.standard_normal(n) * 0.1).astype(np.float32)
    w = rng.standard_normal(m).astype(np.float32)
    idx = rng.integers(0, n, H).astype(np.int32)
    return A, colsq, alpha, w, idx


def _port(fn, A, colsq, alpha, w, idx, **kw):
    """One worker through the port's K-batched layout: A_T (1, n, m)."""
    dv, a = fn(torch.tensor(A.T.copy())[None], torch.tensor(colsq)[None],
               torch.tensor(alpha)[None], torch.tensor(w),
               torch.tensor(idx)[None], **kw)
    return dv[0].numpy(), a[0].numpy()


SHAPES = [(32, 16, 8), (64, 64, 64), (128, 96, 200), (256, 17, 7),
          (512, 128, 333), (33, 5, 1)]


@pytest.mark.parametrize("m,n,H", SHAPES)
@pytest.mark.parametrize("eta", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("which", ["scd_steps", "scd_steps_fixed_point"])
def test_plain_solvers_match_reference(m, n, H, eta, which):
    A, colsq, alpha, w, idx = _mk(m, n, H, seed=m + n + H)
    kw = dict(sigma=8.0, lam=1.0, eta=eta)
    ours, ref = ((scd_steps, scd_steps_ref) if which == "scd_steps"
                 else (scd_steps_fixed_point, fixed_ref))
    dv_r, a_r = ref(jnp.asarray(A), jnp.asarray(colsq), jnp.asarray(alpha),
                    jnp.asarray(w), jnp.asarray(idx), **kw)
    dv, a = _port(ours, A, colsq, alpha, w, idx, **kw)
    np.testing.assert_allclose(dv, np.asarray(dv_r), **TOL)
    np.testing.assert_allclose(a, np.asarray(a_r), **TOL)


def test_batched_workers_match_per_worker_reference():
    """K workers in one call == the reference run on each block alone."""
    K, m, n, H = 3, 48, 20, 30
    blocks = [_mk(m, n, H, seed=10 + k) for k in range(K)]
    w = blocks[0][3]
    kw = dict(sigma=3.0, lam=0.7, eta=0.5)
    A_T = torch.tensor(np.stack([b[0].T for b in blocks]))
    colsq = torch.tensor(np.stack([b[1] for b in blocks]))
    alpha = torch.tensor(np.stack([b[2] for b in blocks]))
    idx = torch.tensor(np.stack([b[4] for b in blocks]))
    dv, a = scd_steps(A_T, colsq, alpha, torch.tensor(w), idx, **kw)
    for k, (A, cs, al, _, ix) in enumerate(blocks):
        dv_r, a_r = scd_steps_ref(jnp.asarray(A), jnp.asarray(cs),
                                  jnp.asarray(al), jnp.asarray(w),
                                  jnp.asarray(ix), **kw)
        np.testing.assert_allclose(dv[k].numpy(), np.asarray(dv_r), **TOL)
        np.testing.assert_allclose(a[k].numpy(), np.asarray(a_r), **TOL)


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_zero_column_and_repeated_index(eta):
    """A zero column is an exact no-op (at eta=0 its denominator is 0 and
    the guard must discard the NaN), and a repeated index sees its own
    earlier update."""
    A, colsq, alpha, w, _ = _mk(64, 8, 0, seed=2)
    A[:, 2] = 0.0
    colsq[2] = 0.0
    idx = np.array([2, 3, 3, 2, 5, 3], np.int32)
    kw = dict(sigma=2.0, lam=0.5, eta=eta)
    dv_r, a_r = scd_steps_ref(jnp.asarray(A), jnp.asarray(colsq),
                              jnp.asarray(alpha), jnp.asarray(w),
                              jnp.asarray(idx), **kw)
    dv, a = _port(scd_steps, A, colsq, alpha, w, idx, **kw)
    assert a[2] == alpha[2] and np.all(np.isfinite(dv))
    np.testing.assert_allclose(dv, np.asarray(dv_r), **TOL)
    np.testing.assert_allclose(a, np.asarray(a_r), **TOL)


def test_kernel_entry_on_cpu_is_the_plain_version():
    A, colsq, alpha, w, idx = _mk(64, 16, 40, seed=5)
    kw = dict(sigma=4.0, lam=1.0, eta=1.0)
    dv, a = _port(scd_steps, A, colsq, alpha, w, idx, **kw)
    dv_k, a_k = _port(scd_steps_kernel, A, colsq, alpha, w, idx, **kw)
    np.testing.assert_array_equal(dv, dv_k)
    np.testing.assert_array_equal(a, a_k)
