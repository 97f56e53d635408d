"""AdamW with global-norm clipping: the port of ``repro.optim.adamw``.

The reference's arithmetic in its order, leaf by leaf. Weight decay is
skipped for leaves of fewer than two dimensions, as in the reference
(``p.ndim``): the final norm's scale (1-D) is not decayed, but the
stacked per-layer norm scales, ``(n_cycles, d_model)``, are; the port
keeps that (ROADMAP.md, "Reference caveats"). Every quotient divides by
a tensor, never by a Python number, which PyTorch's CUDA division turns
into a multiply by the reciprocal.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.utils.trees import tree_leaves, tree_map, tree_unflatten

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"   # float32 | bfloat16


def adamw_init(params, cfg: AdamWConfig):
    dt = _DTYPES[cfg.state_dtype]
    leaves = tree_leaves(params)
    device = leaves[0].device if leaves else None
    return {
        "mu": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                             device=p.device), params),
        "nu": tree_map(lambda p: torch.zeros(p.shape, dtype=dt,
                                             device=p.device), params),
        "count": torch.zeros((), dtype=torch.int32, device=device),
    }


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


@torch.no_grad()
def adamw_update(params, grads, state, cfg: AdamWConfig,
                 lr_scale: torch.Tensor | float = 1.0):
    """Returns (new_params, new_state, metrics)."""
    gnorm = global_norm(grads)
    scale = torch.clamp(torch.full_like(gnorm, cfg.grad_clip)
                        / torch.clamp(gnorm, min=1e-9), max=1.0)
    count = state["count"] + 1
    b1c = 1.0 - cfg.b1 ** count.float()
    b2c = 1.0 - cfg.b2 ** count.float()
    dt = _DTYPES[cfg.state_dtype]

    def upd(p, g, mu, nu):
        g = g.float() * scale
        mu_n = cfg.b1 * mu.float() + (1 - cfg.b1) * g
        nu_n = cfg.b2 * nu.float() + (1 - cfg.b2) * g * g
        step = (mu_n / b1c) / (torch.sqrt(nu_n / b2c) + cfg.eps)
        # decoupled weight decay (skipped for 1-D params: norms/biases)
        wd = cfg.weight_decay if p.dim() >= 2 else 0.0
        p_new = p.float() - cfg.lr * lr_scale * (step + wd * p.float())
        return p_new.to(p.dtype), mu_n.to(dt), nu_n.to(dt)

    new = [upd(*leaves) for leaves in zip(
        tree_leaves(params), tree_leaves(grads), tree_leaves(state["mu"]),
        tree_leaves(state["nu"]))]
    p_new, mu_new, nu_new = (tree_unflatten(params, [t[i] for t in new])
                             for i in range(3))
    return p_new, {"mu": mu_new, "nu": nu_new, "count": count}, {
        "grad_norm": gnorm}
