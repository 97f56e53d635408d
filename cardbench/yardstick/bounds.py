"""The least time the card could take for a piece of work, frozen from
the program's own bound arithmetic so that the yardstick does not move
when the program does.

A bound is the larger of two times: the bytes the work must move (each
input read once, each output written once) over the HBM rate, and its
operations over the peak rate for their type.
"""
from __future__ import annotations

from cardbench.yardstick.peaks import HBM_BW, PEAK_OPS_F32


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = PEAK_OPS_F32) -> tuple[float, str]:
    """(bound in ms, "bytes" or "operations": the term that sets it)."""
    t_bytes, t_ops = nbytes / HBM_BW, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def codec_bounds(K: int, L: int, k: int) -> dict:
    """The bounds of the quantize (K2) and decode+reduce (K3) kernels of
    each width on a (K, L) stack and its payloads, and of top-k (K4) on
    that stack keeping k."""
    bounds = {}
    for c, per in (("int8", 1), ("int4", 2), ("int2", 4)):
        wire = -(-L // per)
        # quantize reads the f32 stack, writes the payload and scales;
        # decode reads the payload and scales, writes the (L,) f32 sum
        bounds[c] = bound_ms(K * (4 * L + wire + 4), 6 * K * L)
        bounds[f"decode_{c}"] = bound_ms(K * (wire + 4) + 4 * L, 2 * K * L)
    # K4 reads the f32 stack and writes k values, k indices and one
    # threshold per row; one magnitude per element
    bounds["topk"] = bound_ms(K * 4 * L + K * (8 * k + 4), K * L)
    return bounds


def distinct_columns(idx, n_pad: int) -> int:
    """The distinct (worker, column) pairs a (K, H) index stream visits."""
    import torch
    K = idx.shape[0]
    return int(torch.unique(idx.long() + torch.arange(K, device=idx.device)
                            [:, None] * n_pad).numel())


def kernel_bounds(idx, n_pad: int, m: int, k: int, distinct: int | None = None):
    """Each kernel's bound at one shape: K1 on the (K, H) index stream
    ``idx`` over K blocks of n_pad columns of m rows, K2 and K3 on a
    (K, m) stack and its payloads, K4 on that stack keeping k. Returns
    the bounds by kernel key, the distinct columns and K1's bytes."""
    K, H = idx.shape
    if distinct is None:
        distinct = distinct_columns(idx, n_pad)
    # K1 reads each distinct visited column once, its norm, the index
    # stream, alpha in and out, w, and writes Delta v; a step is a dot
    # and an axpy, 4m operations, plus ~10 scalar ones
    scd_bytes = 4 * (distinct * (m + 1) + K * H + 2 * K * n_pad + m + K * m)
    bounds = {"scd_solve": bound_ms(scd_bytes, K * H * (4 * m + 10))}
    bounds.update(codec_bounds(K, m, k))
    return bounds, distinct, scd_bytes


def cocoa_round_rest_ms(K: int, n_pad: int, m: int) -> float:
    """The bound of a CoCoA round's work outside K1, K2 and K3: the
    residual apply ``w + total`` (reads two (m,) vectors, writes one) and
    the primal pass (reads w, and alpha and its mask for the
    regularizer), 2 operations an element."""
    nbytes = 4 * (3 * m + m + 2 * K * n_pad)
    ops = 2 * (m + m + 2 * K * n_pad)
    return bound_ms(nbytes, ops)[0]
