"""Carry a run across between the reference and the port.

A reference trainer's state after any round is ``(alpha (K, n_pad),
w (m,))``; ``state_from_reference`` turns those numpy arrays into the
port's tensors on a device and ``state_to_numpy`` turns them back.
``ReplayIndices`` is an index source that hands the port the
reference's own per-round coordinate stream (computed by the caller
from ``jax.random``, which PyTorch cannot reproduce). With both, a port
run can start from any reference round and follow the same trajectory.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.device import resolve_device


def state_from_reference(alpha_stacked: np.ndarray, w: np.ndarray, *,
                         device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(alpha (K, n_pad), w (m,))`` as f32 tensors on ``device`` (the
    card by default), ready for ``CoCoATrainer.run(state=...)``."""
    dev = resolve_device(device)
    alpha = np.asarray(alpha_stacked, np.float32)
    w = np.asarray(w, np.float32)
    if alpha.ndim != 2 or w.ndim != 1:
        raise ValueError(f"expected alpha (K, n_pad) and w (m,), got "
                         f"{alpha.shape} and {w.shape}")
    return (torch.tensor(alpha, device=dev), torch.tensor(w, device=dev))


def state_to_numpy(alpha: torch.Tensor, w: torch.Tensor
                   ) -> tuple[np.ndarray, np.ndarray]:
    """The inverse of ``state_from_reference``."""
    return alpha.detach().cpu().numpy(), w.detach().cpu().numpy()


class ReplayIndices:
    """An index source that replays a recorded stream: ``stream[t - 1]``
    is round ``t``'s ``(K, H)`` array of coordinates."""

    def __init__(self, stream, *, device=None):
        self.device = resolve_device(device)
        self.stream = [np.asarray(s, np.int32) for s in stream]

    def __call__(self, t: int) -> torch.Tensor:
        if not 1 <= t <= len(self.stream):
            raise IndexError(f"round {t} is outside the replayed stream of "
                             f"{len(self.stream)} rounds")
        return torch.tensor(self.stream[t - 1], device=self.device)
