"""Faults planted under the timed path, for the checks that show the
comparison catches them (``tests/test_cardbench_faults.py`` on the CPU,
``harness/control.py --fault`` on the card): a step that returns its
state unchanged, half of the batch left out with the mean taken over the
rest, the exchange left out, and an answer altered where it is
produced. ``plant(kind, fault, setattr)`` installs one through
``setattr(obj, name, value)`` (pytest's ``monkeypatch.setattr``, or
:func:`planted`, which undoes it)."""
from __future__ import annotations

import contextlib

import torch

FAULTS = ("state_unchanged", "half_batch_mean", "no_exchange",
          "answer_altered")


def cocoa(setattr, fault):
    """A fault of the CoCoA round (``core.cocoa``, ``core.distributed``)."""
    from repro_torch.core import cocoa as cc
    from repro_torch.core import distributed
    if fault == "state_unchanged":
        def local_step(self, data, alpha, w, idx, t):
            return torch.zeros((alpha.shape[0], w.shape[0]),
                               device=w.device), alpha
        setattr(cc._CoCoARound, "local_step", local_step)
    elif fault == "half_batch_mean":
        real = distributed.CommScheme.all_reduce_stacked

        def half(self, updates, state=None):
            K = updates.shape[0]
            return real(self, updates[:K // 2] * 2.0, state)
        setattr(distributed.CommScheme, "all_reduce_stacked", half)
    elif fault == "no_exchange":
        def none(self, updates, state=None):
            return torch.zeros_like(updates[0])
        setattr(distributed.CommScheme, "all_reduce_stacked", none)
    elif fault == "answer_altered":
        real = cc._CoCoARound.local_step

        def altered(self, data, alpha, w, idx, t):
            dv, alpha_new = real(self, data, alpha, w, idx, t)
            return dv, alpha_new * 1.01
        setattr(cc._CoCoARound, "local_step", altered)


PLANT = {"cocoa": cocoa}


@contextlib.contextmanager
def planted(kind: str, fault: str):
    """``fault`` planted under the ``kind`` generator's timed path for the
    block."""
    saved = []

    def set_(obj, name, value):
        saved.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)
    try:
        PLANT[kind](set_, fault)
        yield
    finally:
        for obj, name, value in reversed(saved):
            setattr(obj, name, value)
