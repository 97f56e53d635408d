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
from repro_torch.core.solvers import (scd_steps, scd_steps_fixed_point,
                                      scd_steps_fixed_point_batched)
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


@pytest.mark.parametrize("m,n,H", SHAPES)
@pytest.mark.parametrize("eta", [0.0, 0.3, 1.0])
def test_batched_fixed_point_matches_loop_and_reference(m, n, H, eta):
    """The batched exact form of mini-batch SCD's solve against its step
    loop and against the reference's loop, on the same index stream."""
    A, colsq, alpha, w, idx = _mk(m, n, H, seed=m + n + H)
    kw = dict(sigma=8.0, lam=1.0, eta=eta)
    dv, a = _port(scd_steps_fixed_point_batched, A, colsq, alpha, w, idx,
                  **kw)
    dv_l, a_l = _port(scd_steps_fixed_point, A, colsq, alpha, w, idx, **kw)
    dv_r, a_r = fixed_ref(jnp.asarray(A), jnp.asarray(colsq),
                          jnp.asarray(alpha), jnp.asarray(w),
                          jnp.asarray(idx), **kw)
    for want_dv, want_a in ((dv_l, a_l), (np.asarray(dv_r), np.asarray(a_r))):
        np.testing.assert_allclose(dv, want_dv, **TOL)
        np.testing.assert_allclose(a, want_a, **TOL)


def _workers(K, m, n, H, seed, integer=False):
    """K blocks in the port's layout, a zero (padded) last column each;
    ``integer`` makes A and w small integers, so that every dot is exact
    and any two reductions agree."""
    rng = np.random.default_rng(seed)
    if integer:
        A_T = rng.integers(-3, 4, (K, n, m)).astype(np.float32)
        w = rng.integers(-5, 6, m).astype(np.float32)
    else:
        A_T = rng.standard_normal((K, n, m)).astype(np.float32)
        w = rng.standard_normal(m).astype(np.float32)
    A_T[:, -1] = 0.0
    alpha = (rng.standard_normal((K, n)) * 0.1).astype(np.float32)
    idx = rng.integers(0, n, (K, H)).astype(np.int32)
    A_T = torch.tensor(A_T)
    return (A_T, torch.sum(A_T * A_T, dim=2), torch.tensor(alpha),
            torch.tensor(w), torch.tensor(idx))


@pytest.mark.parametrize("eta", [0.0, 0.3, 1.0])
def test_batched_fixed_point_one_column_h_times_and_zero_columns(eta):
    """A stream that visits one column H times (H passes) beside one
    that visits only the zero column, and a zero column among uniform
    draws: still the loop's result."""
    K, m, n, H = 3, 40, 9, 64
    args = list(_workers(K, m, n, H, seed=7))
    args[4][0] = 2                        # column 2, H times
    args[4][1] = n - 1                    # the zero column only
    args[4][2, ::3] = n - 1
    kw = dict(sigma=3.0, lam=0.5, eta=eta)
    dv, a = scd_steps_fixed_point_batched(*args, **kw)
    dv_l, a_l = scd_steps_fixed_point(*args, **kw)
    assert torch.equal(a[1], args[2][1]) and torch.equal(dv[1],
                                                         torch.zeros(m))
    assert a[0, -1] == args[2][0, -1] and bool(torch.isfinite(dv).all())
    torch.testing.assert_close(dv, dv_l, **TOL)
    torch.testing.assert_close(a, a_l, **TOL)


@pytest.mark.parametrize("eta", [0.0, 0.3, 1.0])
@pytest.mark.parametrize("K,m,n,H", [(4, 300, 128, 128), (3, 64, 17, 200),
                                     (2, 33, 5, 1)])
def test_batched_fixed_point_alpha_bit_identical_with_exact_dots(eta, K, m,
                                                                 n, H):
    """Where both forms take the same dots (here exact, so any reduction
    order gives them), alpha is the loop's bit for bit: each pass is the
    loop's step, op for op."""
    args = _workers(K, m, n, H, seed=K + m, integer=True)
    kw = dict(sigma=float(K), lam=1.0, eta=eta)
    dv, a = scd_steps_fixed_point_batched(*args, **kw)
    dv_l, a_l = scd_steps_fixed_point(*args, **kw)
    assert torch.equal(a.view(torch.int32), a_l.view(torch.int32))
    torch.testing.assert_close(dv, dv_l, **TOL)


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
