"""Carry a run across between the reference and the port.

A reference trainer's state after any round is ``(local, shared)``:
``local`` is alpha ``(K, n_pad)`` or, under an ``ef:`` codec, the pair
``(alpha, residual (K, m))``; ``shared`` is ``w (m,)`` or, under
``stale:k=..``, the pair ``(w, queue (k, m))`` of pending aggregates.
``state_from_reference`` turns those numpy arrays into the port's
tensors on a device and ``state_to_numpy`` turns them back.
``ReplayIndices`` is an index source that hands the port the
reference's own per-round coordinate stream (computed by the caller
from ``jax.random``, which PyTorch cannot reproduce). With both, a port
run can start from any reference round and follow the same trajectory.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.utils.device import resolve_device


def _pair(value, what: str):
    """``(first, second)`` of a state pair, ``(value, None)`` of a bare
    array."""
    if not isinstance(value, (tuple, list)):
        return np.asarray(value, np.float32), None
    if len(value) != 2:
        raise ValueError(f"expected the {what} pair of 2 arrays, got "
                         f"{len(value)}")
    return (np.asarray(value[0], np.float32),
            np.asarray(value[1], np.float32))


def state_from_reference(local, shared, *, device=None):
    """``(local, shared)`` as f32 tensors on ``device`` (the card by
    default), ready for ``CoCoATrainer.run(state=...)``: ``local`` is
    alpha ``(K, n_pad)`` or the ``ef:`` pair ``(alpha, residual (K,
    m))``, ``shared`` is ``w (m,)`` or the stale pair ``(w, queue (k,
    m))``, and each comes back in the same form."""
    dev = resolve_device(device)
    alpha, residual = _pair(local, "ef: (alpha, residual)")
    w, queue = _pair(shared, "stale (w, queue)")
    if alpha.ndim != 2 or w.ndim != 1:
        raise ValueError(f"expected alpha (K, n_pad) and w (m,), got "
                         f"{alpha.shape} and {w.shape}")
    K, m = alpha.shape[0], w.shape[0]
    if residual is not None and residual.shape != (K, m):
        raise ValueError(f"expected the ef: residual (K, m) with K={K}, "
                         f"m={m}; got {residual.shape}")
    if queue is not None and (queue.ndim != 2 or queue.shape[0] < 1
                              or queue.shape[1] != m):
        raise ValueError(f"expected the stale queue (k, m) with k >= 1, "
                         f"m={m}; got {queue.shape}")

    def put(a, b):
        t = torch.tensor(a, device=dev)
        return t if b is None else (t, torch.tensor(b, device=dev))

    return put(alpha, residual), put(w, queue)


def state_to_numpy(local, shared):
    """The inverse of ``state_from_reference``."""
    def arr(v):
        if isinstance(v, tuple):
            return tuple(t.detach().cpu().numpy() for t in v)
        return v.detach().cpu().numpy()
    return arr(local), arr(shared)


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
