"""The webspam-like GLM data, made on the device: the distribution of
the program's ``make_glm_data`` (dense standard normal entries, Zipfian
column scales in a shuffled order, each entry kept with probability
``density``, labels from a sparse ground truth plus noise), drawn from a
``torch.Generator`` on the device in a few large calls. It is not the
numpy generator's bit stream: the same seed gives the same matrix on one
device, and both sides of a comparison are handed that matrix."""
from __future__ import annotations

import torch


def make_glm_data(m: int, n: int, *, density: float, zipf_a: float,
                  noise: float, truth_density: float, seed: int,
                  device) -> tuple[torch.Tensor, torch.Tensor]:
    """(A (m, n) f32, b (m,) f32) on ``device`` from ``seed``."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    A = torch.randn((m, n), generator=g, device=device, dtype=torch.float32)
    ranks = torch.arange(1, n + 1, device=device, dtype=torch.float64)
    scales = ranks ** (-1.0 / zipf_a)
    scales = (scales / scales.max()).to(torch.float32)
    scales = scales[torch.randperm(n, generator=g, device=device)]
    A.mul_(scales[None, :])
    if density < 1.0:
        keep = torch.empty((m, n), device=device, dtype=torch.float32)
        keep.uniform_(generator=g)
        A.masked_fill_(keep >= density, 0.0)
        del keep
    nz = torch.randperm(n, generator=g, device=device)[
        :max(1, int(truth_density * n))]
    truth = torch.zeros((n,), device=device, dtype=torch.float32)
    truth[nz] = torch.randn((nz.numel(),), generator=g, device=device)
    eps = torch.randn((m,), generator=g, device=device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        b = A @ truth + noise * eps
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return A, b
