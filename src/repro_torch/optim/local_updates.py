"""The paper's H knob at transformer scale: communication-avoiding
data-parallel training by local-update rounds. The port of
``repro.optim.local_updates``.

Every data shard runs H AdamW steps on its own microbatches, then the
parameter deltas are averaged across the shards: one exchange per H
steps instead of one per step. ``LocalUpdatesConfig.codec`` picks the
wire codec of that exchange (``repro_torch.comm``): ``f32`` keeps the
exact mean; a lossy codec (``int8``/``int4``/``int2``/``topk(r=..)`` and
their ``ef:`` wrappers) encodes each shard's delta of each leaf and
averages through the codec's decode+mean, the same codec objects as the
linear solvers' ``compressed`` exchange, and so on the card the same
kernels: K2 (quantize) and K3 (decode+mean), or K4 (top-k) and the topk
decode. An ``ef:`` codec carries a per-shard residual of every leaf
(:func:`init_delta_codec_state`).

Two drivers:

* :func:`local_updates_round` runs one shard's H steps with no data
  axis: the reference's ``axis_name=None`` (what its launcher runs).
* :func:`virtual_round` runs K shards held on one device, one after
  another, then the exchange leaf by leaf in leaf order: the K f32
  deltas ``pH - p0`` as a ``(K, L)`` stack, encoded in one launch,
  decoded and averaged in worker order in one launch, and ``p0 + mean``
  written back in the param dtype. It is the counterpart of the
  reference's ``_codec_mean`` under ``shard_map`` (the all-gather of a
  stack held on one device is the stack itself), as
  ``core.distributed.build_virtual_round`` is for CoCoA.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.comm import get_codec
from repro_torch.comm.codec import FP_ITEMSIZE
from repro_torch.utils.trees import tree_leaves, tree_map, tree_unflatten


@dataclass(frozen=True)
class LocalUpdatesConfig:
    H: int = 1                 # local steps per communication round
    average: str = "delta"     # delta | params  (identical result; delta
    #                            keeps the reduced operand small)
    sync_opt_state: bool = True
    codec: str = "f32"         # wire codec for the delta exchange

    def __post_init__(self):
        # parse through the full codec grammar: typos and malformed
        # compositions (ef:f32, ef:ef:int8, topk(r=0)) raise here
        codec = get_codec(self.codec)
        if not codec.lossless and self.average != "delta":
            raise ValueError(
                f"codec={self.codec!r} requires average='delta': the "
                f"absmax grid is sized to the small per-round deltas — "
                f"quantizing full parameters would be lossy at a "
                f"completely different magnitude")


def _numel(leaf) -> int:
    return math.prod(int(d) for d in leaf.shape)


def delta_wire_bytes(params, cfg: LocalUpdatesConfig, K: int) -> int:
    """Modelled bytes on the wire for ONE delta exchange across K data
    shards (opt-state sync not included), the reference's model: the
    lossless ``f32`` mean as one f32 all-reduce a leaf, ``2 * K * 4 *
    leaf_len``; a lossy codec ``2 * K * codec.wire_bytes(leaf_len)`` a
    leaf (the ``ef:`` wrapper prices as its base codec). ``params`` may
    hold meta tensors."""
    codec = get_codec(cfg.codec)
    total = 0
    for leaf in tree_leaves(params):
        if codec.lossless:
            total += 2 * K * FP_ITEMSIZE * _numel(leaf)
        else:
            total += 2 * K * codec.wire_bytes(_numel(leaf))
    return total


def init_delta_codec_state(params, cfg: LocalUpdatesConfig,
                           shards: int | None = None):
    """Per-leaf codec state of the delta exchange: flat f32 zero
    residuals, one a leaf, when ``cfg.codec`` is stateful (the ``ef:``
    wrapper), else None. One shard's (``(L,)`` a leaf, the reference's)
    by default; with ``shards=K`` the virtual driver's ``(K, L)`` stack,
    row k shard k's."""
    codec = get_codec(cfg.codec)
    if not getattr(codec, "stateful", False):
        return None
    lead = () if shards is None else (shards,)
    return tree_map(lambda leaf: torch.zeros(
        (*lead, _numel(leaf)), dtype=torch.float32, device=leaf.device),
        params)


def _steps(step_fn, params, opt_state, batches):
    """One shard's steps over the leading axis of ``batches``; the
    metrics stacked over the steps."""
    n = next(iter(batches.values())).shape[0]
    ms = []
    for h in range(n):
        params, opt_state, m = step_fn(params, opt_state,
                                       {k: v[h] for k, v in batches.items()})
        ms.append(m)
    metrics = {k: torch.stack([torch.as_tensor(m[k]) for m in ms])
               for k in ms[0]}
    return params, opt_state, metrics


def local_updates_round(step_fn, params, opt_state, batches,
                        cfg: LocalUpdatesConfig, axis_name=None,
                        codec_state=None):
    """One shard's round with no data axis (``axis_name=None``): the
    steps of ``batches``' leading axis (H of them), nothing exchanged.
    step_fn(params, opt_state, batch) -> (params, opt_state, metrics)
    must not synchronise gradients. With ``codec_state`` the return
    grows a fourth element, the state unchanged. The reference's
    exchange across a data axis is not ported: any ``axis_name`` raises
    (ROADMAP.md, Queue 1 item 14)."""
    if axis_name is not None:
        raise NotImplementedError(
            f"local_updates_round: axis_name={axis_name!r}: the exchange "
            f"across a data axis is not ported yet (ROADMAP.md, Queue 1 "
            f"item 14); K shards on one device are virtual_round")
    pH, oH, metrics = _steps(step_fn, params, opt_state, batches)
    if codec_state is None:
        return pH, oH, metrics
    return pH, oH, metrics, codec_state


def _mean_rows(rows) -> torch.Tensor:
    """The f32 mean of a sequence of equal tensors, summed in order and
    divided by the count (as a tensor: a true quotient on the card)."""
    acc = rows[0].float()
    for r in rows[1:]:
        acc = acc + r.float()
    return acc / torch.full_like(acc, float(len(rows)))


def exchange_leaf(codec, stack: torch.Tensor, state=None):
    """The delta exchange of one leaf over the ``(K, L)`` f32 stack of
    the shards' deltas: returns (the f32 mean ``(L,)``, the new ``(K,
    L)`` residual or None, the wire parts). ``f32``: the exact mean, in
    worker order. A lossy codec: one encode of the stack (K2, or K4 on
    the card), through ``encode_with_state`` when a residual is given,
    and one decode+mean of the parts (K3, or the topk decode)."""
    if codec.lossless:
        return _mean_rows(list(stack)), state, (stack,)
    if state is None:
        parts = codec.encode(stack)
    else:
        parts, state = codec.encode_with_state(stack, state)
    return codec.decode_stacked_mean(parts, stack.shape[1]), state, parts


def virtual_round(step_fn, params, opt_state, batches,
                  cfg: LocalUpdatesConfig, codec_state=None):
    """A round over K shards held on one device.

    ``params``: the round's start, the same on every shard. ``batches``:
    tensors with leading axes (K, H): shard k's H microbatches.
    ``opt_state``: one tree every shard starts from, or a list of K (the
    shards' own, when ``cfg.sync_opt_state`` is off). ``codec_state``:
    the ``(K, L)`` residuals of ``init_delta_codec_state(..., shards=K)``
    for an ``ef:`` codec.

    Each shard runs its H steps in turn; then, leaf by leaf in leaf
    order, the exchange (:func:`exchange_leaf`) and ``p0 + mean`` in the
    param dtype (``average="params"``: the mean of the shards' params).
    With ``cfg.sync_opt_state`` the float leaves of the opt state are
    averaged over the shards (summed in worker order as each shard
    finishes), else each shard keeps its own. Returns (params, opt_state
    (one tree, or the list of K), metrics with leading axes (K, H) plus
    ``wire_bytes``, twice the bytes of the encoded parts: what the
    exchange put on a wire, up and back) and, with ``codec_state``, the
    new residuals."""
    K = next(iter(batches.values())).shape[0]
    opts = opt_state if isinstance(opt_state, list) else [opt_state] * K
    if len(opts) != K:
        raise ValueError(f"virtual_round: {len(opts)} opt states for "
                         f"{K} shards")
    p0 = tree_leaves(params)
    shard_params, shard_opts, ms, opt_sum = [], [], [], None
    for k in range(K):
        pH, oH, m = _steps(step_fn, params, opts[k],
                           {n: v[k] for n, v in batches.items()})
        shard_params.append(tree_leaves(pH))
        ms.append(m)
        if not cfg.sync_opt_state:
            shard_opts.append(oH)
        elif opt_sum is None:
            opt_sum = tree_map(lambda x: x.float() if x.is_floating_point()
                               else x, oH)
        else:
            opt_sum = tree_map(lambda a, x: a + x.float()
                               if x.is_floating_point() else a, opt_sum, oH)
        del pH, oH
    metrics = {n: torch.stack([m[n] for m in ms]) for n in ms[0]}

    codec = get_codec(cfg.codec)
    states = None if codec_state is None else tree_leaves(codec_state)
    new, new_states, wire = [], [], 0
    for i, p in enumerate(p0):
        if cfg.average != "delta":
            new.append(_mean_rows([s[i] for s in shard_params]).to(p.dtype))
            for s in shard_params:
                s[i] = None
            continue
        p0f = p.float().reshape(-1)
        stack = torch.empty((K, p0f.shape[0]), dtype=torch.float32,
                            device=p.device)
        for k, s in enumerate(shard_params):
            torch.sub(s[i].float().reshape(-1), p0f, out=stack[k])
            s[i] = None                  # the shard's copy is spent
        mean, st, parts = exchange_leaf(
            codec, stack, None if states is None else states[i])
        del stack
        wire += 2 * sum(t.numel() * t.element_size() for t in parts)
        new_states.append(st)
        new.append((p0f + mean).reshape(p.shape).to(p.dtype))
        del parts, mean
    metrics["wire_bytes"] = wire
    params = tree_unflatten(params, new)
    if cfg.sync_opt_state:
        denom = float(K)
        opt_state = tree_map(
            lambda a, like: (a / torch.full_like(a, denom)).to(like.dtype)
            if like.is_floating_point() else a, opt_sum, opts[0])
    else:
        opt_state = shard_opts
    if codec_state is None:
        return params, opt_state, metrics
    return params, opt_state, metrics, tree_unflatten(codec_state,
                                                      new_states)


def suggest_H(t_compute_per_step: float, t_collective_per_sync: float,
              max_H: int = 64, staleness_budget: float = 0.25) -> int:
    """Roofline-driven H selection (the paper's Fig-6 logic, automated).

    Picks the smallest H whose per-step amortized communication cost is
    <= staleness_budget * compute, capped at max_H — i.e. spend at least
    1/(1+budget) of the time computing, mirroring the paper's optimal
    compute fractions (60-97%) rising with per-round overhead.
    """
    H = 1
    while (H < max_H
           and t_collective_per_sync / H > staleness_budget
           * max(t_compute_per_step, 1e-12)):
        H *= 2
    return min(H, max_H)
