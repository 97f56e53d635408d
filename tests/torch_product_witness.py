"""Which product rule the port's baselines may take on the CPU: the one
alpha element that separates them, against a second witness.

    PYTHONPATH=src:tests python tests/torch_product_witness.py

Local SGD (H = 4, K = 3, ``compressed:ef:int4``) is the case of
``tests/test_torch_baselines.py`` that tells product rules apart: a
rounding difference in one product moves an int4 code, and error
feedback carries it on. For each rule of the two products (``A_s @
alpha`` and ``resid @ A_s``) the script runs the port against the live
reference on the reference's replayed stream, and prints the element
where the rule leaves the test's alpha tolerance furthest (rtol 1e-3,
atol 1e-6), with the reference's value beside it. The rules:

  * ``shipped``: ``kernels.bmv``'s plain versions (the summed products;
    one ``torch.matmul`` a worker);
  * ``summed``: the summed products for both;
  * ``per_worker``: one ``torch.matmul`` a worker for both;
  * ``batched``: one batched ``torch.matmul`` for both (K-dependent);
  * ``f64``: both products in float64, rounded to float32 once (the
    second witness: the closest of the five to the exact product).
"""
import numpy as np
import torch

import test_torch_baselines as T
from repro_torch.core import baselines as B
from repro_torch.data import make_glm_data
from repro_torch.kernels import bmv


def _rows(x, K):
    return x.expand(K, -1) if x.dim() == 1 else x


RULES = {
    "shipped": (bmv.batched_matvec_ref, bmv.batched_vecmat_ref),
    "summed": (bmv.batched_matvec_ref, lambda y, M: torch.sum(
        y[:, :, None] * M, dim=1)),
    "per_worker": (
        lambda M, x: torch.stack([a @ v for a, v in zip(M, _rows(x, len(M)))]),
        lambda y, M: torch.stack([v @ a for v, a in zip(y, M)])),
    "batched": (
        lambda M, x: torch.matmul(M, _rows(x, len(M))[..., None])[..., 0],
        lambda y, M: torch.matmul(y[:, None], M)[:, 0]),
    "f64": (
        lambda M, x: torch.matmul(M.double(), _rows(x, len(M)).double()[
            ..., None])[..., 0].float(),
        lambda y, M: torch.matmul(y.double()[:, None], M.double())[
            :, 0].float()),
}


def main() -> None:
    A, b, _ = make_glm_data(m=T.M, n=T.N, density=T.DENSITY, zipf_a=1.1,
                            seed=42)
    for name, (mv, vm) in RULES.items():
        B.batched_matvec, B.batched_vecmat = mv, vm
        ref, ref_hist, tr, hist = T._sgd_pair((A, b), 3, 4,
                                              "compressed:ef:int4", 0.5)
        got, want = tr.alpha_final, ref.alpha_final
        over = np.abs(got - want) - (1e-6 + 1e-3 * np.abs(want))
        i = int(np.argmax(over))
        primal = float(np.max(np.abs(np.array(hist.primal) - ref_hist.primal)
                              / np.abs(ref_hist.primal)))
        print(f"{name:10s} alpha[{i}] = {got[i]:.7e} (reference "
              f"{want[i]:.7e}), {'within' if over[i] <= 0 else 'outside'} "
              f"the tolerance; alpha[34] = {got[34]:.7e}; primal rel "
              f"{primal:.2e}")


if __name__ == "__main__":
    main()
