"""The port's data generator, partitioner and GLM objective against the
reference, on the CPU. Inputs are numpy arrays made from a seed and
handed to both packages."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import glm as glm_ref
from repro.core import partition as part_ref
from repro.data.synthetic import make_glm_data as make_ref
from repro_torch.core import glm
from repro_torch.core import partition as part
from repro_torch.data.synthetic import make_glm_data


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("m,n,density,seed", [
    (96, 256, 0.2, 42), (50, 30, 1.0, 0), (33, 70, 0.5, 7),
])
def test_make_glm_data_array_equal(m, n, density, seed):
    ours = make_glm_data(m=m, n=n, density=density, zipf_a=1.1, seed=seed)
    ref = make_ref(m=m, n=n, density=density, zipf_a=1.1, seed=seed)
    for a, r in zip(ours, ref):
        assert a.dtype == r.dtype
        np.testing.assert_array_equal(a, r)


@pytest.mark.parametrize("n,K", [(256, 4), (17, 3), (5, 8), (1000, 7)])
def test_block_partition_equal(n, K):
    a, r = part.block_partition(n, K), part_ref.block_partition(n, K)
    assert a.n_padded == r.n_padded and a.K == r.K
    for x, y in zip(a.owned, r.owned):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("K", [1, 3, 4, 8])
def test_balanced_partition_pack_unpack_equal(K):
    A, _, _ = make_ref(m=40, n=101, density=0.3, seed=K)
    nnz = (np.abs(A) > 0).sum(axis=0)
    a, r = part.balanced_partition(nnz, K), part_ref.balanced_partition(nnz, K)
    assert a.n_padded == r.n_padded
    for x, y in zip(a.owned, r.owned):
        np.testing.assert_array_equal(x, y)
    assert part.partition_imbalance(a, nnz) == part_ref.partition_imbalance(r, nnz)
    st, mask = part.pack_columns(A, a)
    st_r, mask_r = part_ref.pack_columns(A, r)
    np.testing.assert_array_equal(st, st_r)
    np.testing.assert_array_equal(mask, mask_r)
    # the column-major stack is the reference's stack transposed
    st_t, mask_t = part.pack_columns_t(torch.tensor(A), a)
    np.testing.assert_array_equal(st_t.numpy(), st.transpose(0, 2, 1))
    np.testing.assert_array_equal(mask_t.numpy(), mask)
    alpha_st = np.random.default_rng(K).standard_normal(st.shape[::2]) * mask
    alpha_st = alpha_st.astype(np.float32)
    np.testing.assert_array_equal(part.unpack_alpha(alpha_st, a, 101),
                                  part_ref.unpack_alpha(alpha_st, r, 101))


@pytest.mark.parametrize("eta", [1.0, 0.3, 0.0])
def test_primal_objective_and_regularizer(eta):
    A, b, _ = make_ref(m=60, n=90, density=0.3, seed=1)
    alpha = np.random.default_rng(2).standard_normal(90).astype(np.float32)
    p_ref, p = glm_ref.GLMProblem(2.0, eta), glm.GLMProblem(2.0, eta)
    want = float(glm_ref.primal_objective(p_ref, jnp.asarray(A),
                                          jnp.asarray(b), jnp.asarray(alpha)))
    got = float(glm.primal_objective(p, _t(A), _t(b), _t(alpha)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    np.testing.assert_allclose(float(p.regularizer(_t(alpha))),
                               float(p_ref.regularizer(jnp.asarray(alpha))),
                               rtol=1e-5)


@pytest.mark.parametrize("m,n", [(40, 120), (120, 40), (96, 256)])
def test_ridge_exact_both_forms(m, n):
    """m < n takes the push-through form, m >= n the reference's own
    system; both solve in f64 from an f32 Gram."""
    A, b, _ = make_ref(m=m, n=n, density=0.3, seed=3)
    want = glm_ref.ridge_exact(A, b, 1.0)
    got = glm.ridge_exact(_t(A), _t(b), 1.0)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-7)
    p_ref, p = glm_ref.GLMProblem(1.0, 1.0), glm.GLMProblem(1.0, 1.0)
    np.testing.assert_allclose(glm.optimal_objective(p, _t(A), _t(b)),
                               glm_ref.optimal_objective(p_ref, A, b),
                               rtol=1e-5)


def test_optimal_objective_fista_elastic_net():
    A, b, _ = make_ref(m=30, n=45, density=0.4, seed=4)
    p_ref, p = glm_ref.GLMProblem(1.0, 0.3), glm.GLMProblem(1.0, 0.3)
    np.testing.assert_allclose(glm.optimal_objective(p, _t(A), _t(b)),
                               glm_ref.optimal_objective(p_ref, A, b),
                               rtol=1e-5)


@pytest.mark.parametrize("p_now,p_star,p_zero", [
    (1.5, 1.0, 2.0), (0.9, 1.0, 2.0), (1.0, 1.0, 1.0), (3.0, 1.0, 2.0),
])
def test_suboptimality_equal(p_now, p_star, p_zero):
    assert glm.suboptimality(p_now, p_star, p_zero) == \
        glm_ref.suboptimality(p_now, p_star, p_zero)
