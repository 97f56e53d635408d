"""The model interface: the port of ``repro.models.registry``.

``build_model(cfg)`` returns a ``Model`` with
  init(generator[, dtype])           -> params on the generator's device
                                        (None: the default one)
  forward_train(params, batch)       -> (logits, aux_loss)   [full seq]
  prefill(params, batch, states)     -> (logits, states)
  decode_step(params, batch, states) -> (logits, states)     [S == 1]
  init_states(params, B, max_len[, batch]) -> per-layer decode state
and, for a config with multi-token prediction (deepseek-v3),
  forward_train_mtp(params, batch)   -> (logits, mtp_logits, aux_loss)
for the decoder-only families (dense, the MoE one: llama4-maverick's
experts, deepseek-v3's experts, dense prologue, MLA and MTP head, the
SSM one: mamba2's SSD layers, the hybrid one: recurrentgemma's RG-LRU
and local attention, and the vlm one: qwen2-vl's M-RoPE and patch
embeddings in the batch) and the audio enc-dec (whisper:
``frame_embeds`` in the batch).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as T
from repro_torch.models import whisper as W


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, generator: torch.Generator | None, dtype=torch.bfloat16):
        if self.cfg.family == "audio":
            return W.init_whisper(generator, self.cfg, dtype)
        return T.init_lm(generator, self.cfg, dtype)

    def forward_train(self, params, batch, *, unroll: bool = False,
                      remat: bool = False):
        cfg = self.cfg
        if cfg.family == "audio":
            enc_out = W.encode(params, cfg, batch["frame_embeds"])
            logits, _ = W.decode(params, cfg, batch["tokens"], enc_out)
            return logits, torch.zeros((), dtype=torch.float32,
                                       device=logits.device)
        logits, _, aux = T.forward(params, cfg, batch, mode="full",
                                   unroll=unroll, remat=remat)
        return logits, aux

    def forward_train_mtp(self, params, batch, *, unroll: bool = False,
                          remat: bool = False):
        """The train forward with the MTP head's logits too (deepseek-v3):
        (logits, mtp_logits (B, S - 1, V), aux_loss)."""
        logits, hidden, aux = T.forward_hidden(params, self.cfg, batch,
                                               remat=remat)
        return logits, T.mtp_logits(params, self.cfg, hidden, batch), aux

    def prefill(self, params, batch, states, *, last_logits_only=False,
                unroll=False):
        """The prompt's forward, filling ``states`` in place (whisper's
        rebuilt in place first: the frames encoded again, the cross keys
        and values projected into their tensors, the self caches
        emptied)."""
        cfg = self.cfg
        if cfg.family == "audio":
            enc_out = W.encode(params, cfg, batch["frame_embeds"])
            states = W.refill_whisper_states(params, cfg, states, enc_out)
            logits, states = W.decode(params, cfg, batch["tokens"], enc_out,
                                      mode="full", states=states)
            if last_logits_only:
                logits = logits[:, -1:]
            return logits, states
        logits, states, _ = T.forward(params, cfg, batch, mode="full",
                                      states=states, unroll=unroll,
                                      last_logits_only=last_logits_only)
        return logits, states

    def decode_step(self, params, batch, states):
        """One token a row (``batch``: tokens and positions, (B, 1))
        against ``states``, whose caches it writes in place and returns:
        a caller who kept an older ``states`` sees it change."""
        cfg = self.cfg
        if cfg.family == "audio":
            return W.decode(params, cfg, batch["tokens"], None, mode="step",
                            states=states, positions=batch["positions"])
        logits, states, _ = T.forward(params, cfg, batch, mode="step",
                                      states=states)
        return logits, states

    def init_states(self, params, B: int, max_len: int, batch=None,
                    dtype=torch.bfloat16):
        """Empty decode states on the device of ``params["embed"]``: a
        KV cache for an attention layer, the latent ``{c, kr, pos_abs}``
        for an MLA layer, ``{h, conv}`` for an RG-LRU or SSD layer; for
        whisper a layer's self cache and its cross keys and values from
        ``batch["frame_embeds"]``, encoded here."""
        cfg = self.cfg
        if cfg.family == "audio":
            if batch is None or "frame_embeds" not in batch:
                raise ValueError("init_states: whisper's states need "
                                 "batch={'frame_embeds': (B, source_len, "
                                 "d_model)}")
            enc_out = W.encode(params, cfg, batch["frame_embeds"])
            return W.init_whisper_states(params, cfg, B, max_len, enc_out,
                                         dtype)
        return T.init_states(cfg, B, max_len, dtype,
                             device=params["embed"].device)


def states_max_len(states) -> int:
    """The slots of the first attention cache in ``states`` (whisper's
    self cache; 0 with none, as for mamba2's ``{h, conv}`` states and,
    as in the reference, for MLA's latent caches)."""
    for st in states:
        if isinstance(st, dict) and "self" in st:
            return st["self"]["k"].shape[1]
        if isinstance(st, dict) and "k" in st:
            return st["k"].shape[1]
    return 0


PORTED_FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


def build_model(cfg: ModelConfig) -> Model:
    if cfg.family not in PORTED_FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r} ({cfg.name}); "
                         f"known: {PORTED_FAMILIES}")
    return Model(cfg)
