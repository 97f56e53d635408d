"""The model interface: the port of ``repro.models.registry``.

``build_model(cfg)`` returns a ``Model`` with
  init(generator[, dtype])           -> params on the generator's device
                                        (None: the default one)
  forward_train(params, batch)       -> (logits, aux_loss)   [full seq]
  prefill(params, batch, states)     -> (logits, states)
  decode_step(params, batch, states) -> (logits, states)     [S == 1]
  init_states(params, B, max_len)    -> per-layer decode state
for the dense decoder family, the SSM one (mamba2: SSD layers) and the
hybrid one (recurrentgemma: RG-LRU and local attention); the other
families are not ported yet and raise.
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

    def forward_train(self, params, batch, *, unroll: bool = False,
                      remat: bool = False):
        logits, _, aux = T.forward(params, self.cfg, batch, mode="full",
                                   unroll=unroll, remat=remat)
        return logits, aux

    def prefill(self, params, batch, states, *, last_logits_only=False,
                unroll=False):
        """The prompt's forward, filling ``states`` in place."""
        logits, states, _ = T.forward(params, self.cfg, batch, mode="full",
                                      states=states, unroll=unroll,
                                      last_logits_only=last_logits_only)
        return logits, states

    def decode_step(self, params, batch, states):
        """One token a row (``batch``: tokens and positions, (B, 1))
        against ``states``, whose caches it writes in place and returns:
        a caller who kept an older ``states`` sees it change."""
        logits, states, _ = T.forward(params, self.cfg, batch, mode="step",
                                      states=states)
        return logits, states

    def init_states(self, params, B: int, max_len: int, batch=None,
                    dtype=torch.bfloat16):
        """Empty decode states on the device of ``params["embed"]``: a
        KV cache for an attention layer, ``{h, conv}`` for an RG-LRU or
        SSD layer. ``batch`` (the reference's whisper encoder input) is
        unused: the ported families' states need none."""
        return T.init_states(self.cfg, B, max_len, dtype,
                             device=params["embed"].device)


def states_max_len(states) -> int:
    """The slots of the first attention cache in ``states`` (0 with
    none, as for mamba2's ``{h, conv}`` states). The reference's whisper
    branch waits for its family."""
    for st in states:
        if isinstance(st, dict) and "k" in st:
            return st["k"].shape[1]
    return 0


PORTED_FAMILIES = ("dense", "ssm", "hybrid")


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet "
            f"(ROADMAP.md, Queue 1 item 12); ported: {PORTED_FAMILIES}")
    return Model(cfg)
