"""Train-step factory: the port of ``repro.train.step`` (loss + grad +
AdamW, with optional per-layer remat, gradient accumulation over
microbatches, and optional gradient averaging across the ranks of a
``torch.distributed`` group: synchronous data parallelism, one process
a data shard). Inside local-update rounds
(``repro_torch.optim.local_updates``) a step does not synchronise: the
round exchanges parameter deltas instead.
"""
from __future__ import annotations

from typing import Callable

import torch

from repro_torch.comm.collectives import data_fabric, pmean
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.schedules import cosine_schedule
from repro_torch.train.loss import lm_loss
from repro_torch.utils.trees import tree_leaves, tree_unflatten


def batch_to(batch: dict, device) -> dict:
    """A host batch (numpy arrays) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def loss_and_grads(model, params, batch, *, remat: bool = False):
    """What a train step differentiates: the loss, its metrics
    (``lm_loss``'s: CE, z-loss, the aux and MTP terms) and the gradient
    of every leaf of ``params`` in leaf order, all detached."""
    live = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        loss, metrics = lm_loss(model, tree_unflatten(params, live), batch,
                                remat=remat)
        # a leaf the loss does not reach (command-r's parallel block
        # leaves channel_norm unused) has a zero gradient, as in jax
        grads = torch.autograd.grad(loss, live, allow_unused=True,
                                    materialize_grads=True)
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, list(grads)


def _microbatches(batch: dict, n: int) -> list:
    """The batch's leading dim split n ways: microbatch i the rows [i B/n,
    (i+1) B/n). A DTensor batch split over the data axes is split on
    each rank's own rows instead (microbatch i: the i-th n-th of every
    shard), so that no row moves between ranks; the step's sum of the
    microbatch gradients is the same, in another order."""
    def split(v):
        from torch.distributed.tensor import DTensor
        if not isinstance(v, DTensor):
            return list(v.reshape(n, v.shape[0] // n, *v.shape[1:]))
        loc = v.to_local()
        shape = (v.shape[0] // n, *v.shape[1:])
        return [DTensor.from_local(c, v.device_mesh, v.placements,
                                   run_check=False, shape=torch.Size(shape),
                                   stride=torch.empty(shape,
                                                      device="meta").stride())
                for c in loc.reshape(n, loc.shape[0] // n, *loc.shape[1:])]
    parts = {k: split(v) for k, v in batch.items()}
    return [{k: p[i] for k, p in parts.items()} for i in range(n)]


def make_train_step(model, opt_cfg: AdamWConfig, *, remat: bool = False,
                    grad_sync_axis=None, schedule: Callable | None = None,
                    microbatch: int | None = None):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics), all tensors on the params' device (no host sync without
    ``grad_sync_axis``).

    remat: checkpoint each layer (the reference's per-layer-cycle
    policy). grad_sync_axis: ``None`` (no sync), a
    :class:`~repro_torch.comm.collectives.Fabric` or a
    ``torch.distributed`` process group: every gradient leaf is averaged
    across its ranks in the leaf's own dtype (the reference's ``pmean``:
    an all-reduce, then a division by K as a tensor), after the
    microbatch accumulation and before AdamW. microbatch:
    gradient-accumulate over N sequential microbatches (the batch's
    leading dim split N ways), in f32. schedule(step_no) -> lr scale;
    the cosine schedule by default.
    """
    fabric = data_fabric(grad_sync_axis)

    def step(params, opt_state, batch):
        if microbatch and microbatch > 1:
            mbs = _microbatches(batch, microbatch)
            g_acc = [torch.zeros_like(p, dtype=torch.float32)
                     for p in tree_leaves(params)]
            ms = []
            for b in mbs:
                loss, metrics, g = loss_and_grads(model, params, b,
                                                 remat=remat)
                g_acc = [a + gg.to(a.dtype)
                         / torch.full_like(a, float(microbatch))
                         for a, gg in zip(g_acc, g)]
                metrics["loss"] = loss
                ms.append(metrics)
            metrics = {k: torch.mean(torch.stack([m[k] for m in ms]).float(),
                                     dim=0) for k in ms[0]}
            grads = g_acc
        else:
            _, metrics, grads = loss_and_grads(model, params, batch,
                                              remat=remat)
        if fabric is not None:
            grads = [pmean(g, fabric) for g in grads]
        grads = tree_unflatten(params, grads)
        step_no = opt_state["count"] + 1
        lr_scale = (schedule(step_no) if schedule is not None
                    else cosine_schedule(step_no))
        params, opt_state, om = adamw_update(params, grads, opt_state,
                                             opt_cfg, lr_scale)
        metrics = dict(metrics)
        metrics.update(om)
        metrics["lr_scale"] = lr_scale
        return params, opt_state, metrics

    return step
