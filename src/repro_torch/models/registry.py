"""The model interface: the port of ``repro.models.registry``.

``build_model(cfg)`` returns a ``Model`` with
  init(generator[, dtype])           -> params on the generator's device
                                        (None: the default one)
  forward_train(params, batch)       -> (logits, aux_loss)   [full seq]
for the dense decoder family; the other families, prefill and decode
are not ported yet and raise.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, generator: torch.Generator | None, dtype=torch.bfloat16):
        return T.init_lm(generator, self.cfg, dtype)

    def forward_train(self, params, batch, *, remat: bool = False):
        return T.forward(params, self.cfg, batch, mode="full", remat=remat)


PORTED_FAMILIES = ("dense",)


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet "
            f"(ROADMAP.md, Queue 1 item 12); ported: {PORTED_FAMILIES}")
    return Model(cfg)
