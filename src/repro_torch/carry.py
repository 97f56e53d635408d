"""Carry a run across between the reference and the port.

A reference trainer's state after any round is ``(local, w (m,))``,
where ``local`` is alpha ``(K, n_pad)`` or, under an ``ef:`` codec, the
pair ``(alpha, residual (K, m))``; ``state_from_reference`` turns those
numpy arrays into the port's tensors on a device and ``state_to_numpy``
turns them back.
``ReplayIndices`` is an index source that hands the port the
reference's own per-round coordinate stream (computed by the caller
from ``jax.random``, which PyTorch cannot reproduce). With both, a port
run can start from any reference round and follow the same trajectory.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.device import resolve_device


def state_from_reference(local, w: np.ndarray, *, device=None):
    """``(local, w (m,))`` as f32 tensors on ``device`` (the card by
    default), ready for ``CoCoATrainer.run(state=...)``: ``local`` is
    alpha ``(K, n_pad)`` or the ``ef:`` pair ``(alpha, residual (K,
    m))``, and comes back in the same form."""
    dev = resolve_device(device)
    pair = isinstance(local, (tuple, list))
    alpha = np.asarray(local[0] if pair else local, np.float32)
    w = np.asarray(w, np.float32)
    if alpha.ndim != 2 or w.ndim != 1:
        raise ValueError(f"expected alpha (K, n_pad) and w (m,), got "
                         f"{alpha.shape} and {w.shape}")
    if not pair:
        return torch.tensor(alpha, device=dev), torch.tensor(w, device=dev)
    residual = np.asarray(local[1], np.float32)
    if len(local) != 2 or residual.shape != (alpha.shape[0], w.shape[0]):
        raise ValueError(f"expected the ef: pair (alpha, residual (K, m)) "
                         f"with K={alpha.shape[0]}, m={w.shape[0]}; got "
                         f"{len(local)} arrays, residual {residual.shape}")
    return ((torch.tensor(alpha, device=dev),
             torch.tensor(residual, device=dev)),
            torch.tensor(w, device=dev))


def state_to_numpy(local, w: torch.Tensor):
    """The inverse of ``state_from_reference``."""
    def arr(t):
        return t.detach().cpu().numpy()
    if isinstance(local, tuple):
        return tuple(arr(t) for t in local), arr(w)
    return arr(local), arr(w)


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
