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

* :func:`local_updates_round` runs this shard's H steps and then, with
  ``axis_name`` a :class:`~repro_torch.comm.collectives.Fabric` or a
  ``torch.distributed`` process group (one process a data shard), the
  exchange across its ranks through the fabric: under ``f32`` the
  reference's ``pmean`` (one ``all_reduce`` of the f32 delta a leaf,
  divided by K); under a lossy codec :func:`_codec_mean` (this rank's
  delta encoded as one ``(1, L)`` row, each wire part all-gathered in
  rank order, one decode+mean of the ``(K, ...)`` parts); or a mesh-axis
  name under ``launch.build.partitioning`` (the group of those axes).
  Leaves that are DTensors (split over ``model``) are exchanged whole,
  each gathered over its split first so that the codec's scale and
  payload are the unsplit leaf's, and placed back after, each rank
  keeping its shard. With ``axis_name=None`` nothing is exchanged (what
  the launcher runs).
* :func:`virtual_round` runs K shards held on one device, one after
  another, then the exchange leaf by leaf in leaf order: the K f32
  deltas ``pH - p0`` as a ``(K, L)`` stack, encoded in one launch,
  decoded and averaged in worker order in one launch, and ``p0 + mean``
  written back in the param dtype. The all-gather of a stack held on
  one device is the stack itself, so a rank's codec row is encoded and
  the gathered rows decoded as here: the two drivers agree bit for bit
  under a lossy codec, and under ``f32`` and for the opt state up to
  the order of the all-reduce's sum.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.comm import get_codec
from repro_torch.comm.codec import FP_ITEMSIZE
from repro_torch.comm.collectives import Fabric, data_fabric, pmean
from repro_torch.utils.trees import (is_dtensor, tree_leaves, tree_map,
                                     tree_unflatten)


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
    """One shard's steps over the leading axis of every leaf of
    ``batches`` (any tree: a dict, a tuple ``(X, Y)``); the metrics
    stacked over the steps."""
    n = tree_leaves(batches)[0].shape[0]
    ms = []
    for h in range(n):
        params, opt_state, m = step_fn(params, opt_state,
                                       tree_map(lambda v: v[h], batches))
        ms.append(m)
    metrics = {k: torch.stack([torch.as_tensor(m[k]) for m in ms])
               for k in ms[0]}
    return params, opt_state, metrics


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A leaf whole: a DTensor gathered over the axes that split it (the
    params of a partitioned round are split over ``model`` only), so
    that a codec's scale is the whole leaf's, as GSPMD's is."""
    return x.full_tensor() if is_dtensor(x) else x


def _placed_like(value: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``value`` (a whole leaf every rank holds alike) placed as ``like``:
    each rank keeps its own shard, nothing sent."""
    if not is_dtensor(like):
        return value
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(value, like.device_mesh, like.placements,
                             src_data_rank=None)


def _pmean_f32(x: torch.Tensor, fabric: Fabric) -> torch.Tensor:
    """:func:`pmean` in f32, cast back to ``x``'s dtype; a DTensor's own
    shard is averaged over the fabric's ranks (which hold the same
    shard of it)."""
    if is_dtensor(x):
        from torch.distributed.tensor import DTensor
        return DTensor.from_local(_pmean_f32(x.to_local(), fabric),
                                  x.device_mesh, x.placements,
                                  run_check=False, shape=x.shape,
                                  stride=x.stride())
    return pmean(x.float(), fabric).to(x.dtype)


def _codec_mean(delta: torch.Tensor, codec, fabric: Fabric, state=None):
    """The lossy replacement for the f32 pmean of one leaf's f32 delta,
    the reference's ``_codec_mean``: this rank's delta as one ``(1, L)``
    row, encoded (K2, or K4, on the card; through ``encode_with_state``
    with this rank's ``(L,)`` residual), each wire part all-gathered into
    ``(K, ...)`` in rank order, and one decode+mean of the gathered parts
    (K3, or the topk decode). Returns (the mean, shaped as ``delta``, the
    new ``(L,)`` residual or None, the gathered parts)."""
    row = delta.reshape(1, -1)
    if state is None:
        parts = codec.encode(row)
    else:
        parts, state = codec.encode_with_state(row, state.reshape(1, -1))
        state = state.reshape(-1)
    gathered = tuple(fabric.all_gather(p) for p in parts)
    mean = codec.decode_stacked_mean(gathered, row.shape[1])
    return mean.reshape(delta.shape), state, gathered


def _exchange_deltas(p0, shard: list, codec, fabric: Fabric, states=None):
    """The delta exchange, leaf by leaf in leaf order: ``p0 + mean`` of
    the ranks' f32 deltas ``shard - p0`` in the param dtype (each of the
    ``shard`` leaves is dropped from the list once spent). Returns (the
    new params' leaves, the new residuals or None, the wire bytes: twice
    the bytes of every rank's encoded parts, as :func:`virtual_round`
    counts them)."""
    new, new_states, wire = [], [], 0
    for i, leaf in enumerate(tree_leaves(p0)):
        p = _whole(leaf)
        p0f = p.float().reshape(-1)
        delta = _whole(shard[i]).float().reshape(-1) - p0f
        shard[i] = None
        if codec.lossless:
            mean, st, parts = pmean(delta, fabric), None, (delta,)
            wire += 2 * fabric.K * delta.numel() * delta.element_size()
        else:
            mean, st, parts = _codec_mean(
                delta, codec, fabric, None if states is None else states[i])
            wire += 2 * sum(t.numel() * t.element_size() for t in parts)
        del delta, parts
        new_states.append(st)
        new.append(_placed_like((p0f + mean).reshape(p.shape).to(p.dtype),
                                leaf))
    return new, (None if states is None else new_states), wire


def _sync_opt_state(opt_state, fabric: Fabric):
    """The opt state's float leaves averaged over the ranks in f32 and
    cast back; the step ``count`` as it is."""
    return tree_map(lambda x: _pmean_f32(x, fabric)
                    if x.is_floating_point() else x, opt_state)


def local_updates_round(step_fn, params, opt_state, batches,
                        cfg: LocalUpdatesConfig, axis_name=None,
                        codec_state=None):
    """Run cfg.H local steps, then average across the ranks of
    ``axis_name``.

    step_fn(params, opt_state, batch) -> (params, opt_state, metrics)
    must not synchronise gradients. ``batches`` is a tree (a dict, a
    tuple ``(X, Y)``) whose leaves have a leading axis H: this shard's
    microbatches. ``axis_name``: ``None`` runs the steps alone, nothing
    exchanged; a :class:`Fabric` or a ``torch.distributed`` process
    group (one process a shard) exchanges across its ranks
    (:func:`data_fabric`): the deltas under ``cfg.average="delta"``
    (the f32 pmean, or :func:`_codec_mean` under a lossy codec), the
    params' f32 pmean under ``"params"``, then with
    ``cfg.sync_opt_state`` the opt state's float leaves.
    ``codec_state`` (:func:`init_delta_codec_state`, this shard's own
    ``(L,)`` residual a leaf) carries an ``ef:`` codec's residual; when
    passed, the return grows a fourth element, the new state. Across
    ranks ``metrics`` also holds ``wire_bytes``: twice the bytes of the
    K ranks' operands of the exchange (the encoded parts under a lossy
    codec), ``delta_wire_bytes`` for a delta exchange."""
    fabric = data_fabric(axis_name)
    pH, oH, metrics = _steps(step_fn, params, opt_state, batches)
    if fabric is not None:
        if cfg.average == "delta":
            states = (None if codec_state is None
                      else tree_leaves(codec_state))
            shard = tree_leaves(pH)
            pH = None
            new, states, metrics["wire_bytes"] = _exchange_deltas(
                params, shard, get_codec(cfg.codec), fabric, states)
            pH = tree_unflatten(params, new)
            if states is not None:
                codec_state = tree_unflatten(codec_state, states)
        else:
            pH = tree_map(lambda x: _pmean_f32(x, fabric), pH)
            metrics["wire_bytes"] = 2 * fabric.K * FP_ITEMSIZE * sum(
                _numel(p) for p in tree_leaves(pH))
        if cfg.sync_opt_state:
            oH = _sync_opt_state(oH, fabric)
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
    a tree of tensors with leading axes (K, H): shard k's H
    microbatches.
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
    exchange put on a wire, up and back; the f32 params under
    ``average="params"``) and, with ``codec_state``, the new
    residuals."""
    K = tree_leaves(batches)[0].shape[0]
    opts = opt_state if isinstance(opt_state, list) else [opt_state] * K
    if len(opts) != K:
        raise ValueError(f"virtual_round: {len(opts)} opt states for "
                         f"{K} shards")
    p0 = tree_leaves(params)
    shard_params, shard_opts, ms, opt_sum = [], [], [], None
    for k in range(K):
        pH, oH, m = _steps(step_fn, params, opts[k],
                           tree_map(lambda v: v[k], batches))
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
            wire += 2 * K * FP_ITEMSIZE * p.numel()
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
