"""Learning-rate schedules: the port of ``repro.optim.schedules``."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, warmup: int = 100, total: int = 10_000,
                    min_frac: float = 0.1) -> torch.Tensor:
    """Linear warmup then cosine decay to min_frac. Returns an f32 scale
    in (0, 1] multiplied onto the base lr, on ``step``'s device. Every
    quotient divides by a tensor: PyTorch's CUDA division by a Python
    number multiplies by the reciprocal instead."""
    step = torch.as_tensor(step).to(torch.float32)

    def div(a, b):
        return a / torch.full_like(a, float(b))

    warm = torch.clamp(div(step, max(warmup, 1)), max=1.0)
    prog = torch.clamp(div(step - warmup, max(total - warmup, 1)), 0.0, 1.0)
    cos = min_frac + (1 - min_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
