"""Language-model losses: the port of ``repro.train.loss`` (cross-entropy
with a z-loss over the positions whose label is not -100, the MoE aux
loss and the multi-token prediction term)."""
from __future__ import annotations

import torch


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 z_loss_coef: float = 1e-4):
    """Mean next-token CE over valid positions; labels = -100 masked.
    Returns (loss, metrics)."""
    valid = labels >= 0
    labels_safe = torch.where(valid, labels, torch.zeros_like(labels)).long()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, labels_safe[..., None])[..., 0] - logz
    n = torch.clamp(valid.sum(), min=1)
    ce = -(ll * valid).sum() / n
    zl = z_loss_coef * ((logz ** 2) * valid).sum() / n
    acc = ((logits.argmax(-1) == labels_safe) & valid).sum() / n
    return ce + zl, {"ce": ce, "z_loss": zl, "accuracy": acc}


def lm_loss(model, params, batch, *, z_loss_coef: float = 1e-4,
            mtp_coef: float = 0.3, unroll: bool = False, remat: bool = False):
    """Full train loss of a registry model: CE (+ z-loss) + the MoE aux
    loss, and with multi-token prediction (deepseek-v3) ``mtp_coef``
    times the MTP head's CE against the labels shifted one further (no
    z-loss). batch needs tokens + labels (labels already shifted; -100 =
    ignore); ``unroll`` changes nothing (the port has no scan to
    unroll)."""
    if model.cfg.mtp_depth > 0:
        logits, mtp_logits, aux = model.forward_train_mtp(
            params, batch, unroll=unroll, remat=remat)
        loss, metrics = softmax_xent(logits, batch["labels"], z_loss_coef)
        # MTP predicts token t+2 from position t
        mtp_labels = batch["labels"][:, 1:][:, :mtp_logits.shape[1]]
        mtp_loss, _ = softmax_xent(mtp_logits, mtp_labels, 0.0)
        loss = loss + mtp_coef * mtp_loss + aux
        metrics["mtp_loss"] = mtp_loss
    else:
        logits, aux = model.forward_train(params, batch, unroll=unroll,
                                          remat=remat)
        loss, metrics = softmax_xent(logits, batch["labels"], z_loss_coef)
        loss = loss + aux
    metrics["aux_loss"] = aux
    metrics["loss"] = loss
    return loss, metrics
