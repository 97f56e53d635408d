"""Whisper-style encoder-decoder backbone: the port of
``repro.models.whisper`` (audio frontend stubbed, as there).

The mel-spectrogram and conv feature extractor are not implemented: the
caller supplies (B, source_len, d_model) frame embeddings. This module is
the transformer: a bidirectional encoder over the frames, a causal
decoder with cross-attention over the encoder's output, learned decoder
positions, LayerNorm, GELU and biases (whisper-tiny style), and the tied
unembedding.

The decoder's states are a list, one a layer, of ``{"self": attention
cache, "cross_k", "cross_v"}``: the cross keys and values are projected
once from the encoder's output and only read afterwards; the self cache
is written in place, as every port state is.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, padded_vocab
from repro_torch.models import layers as L

MAX_TARGET_POSITIONS = 32_768   # generous; real whisper is 448


def _sinusoid(length: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None]
    ang = pos / (10000.0 ** (2 * dim / d))
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1)


def _init_enc_layer(gen, cfg: ModelConfig, dtype):
    dev = L._device(gen)
    return {
        "attn_norm": L.norm_init(cfg.d_model, "layernorm", device=dev),
        "attn": L.init_attention(gen, cfg, dtype),
        "mlp_norm": L.norm_init(cfg.d_model, "layernorm", device=dev),
        "mlp": L.init_mlp(gen, cfg, dtype=dtype),
    }


def _init_dec_layer(gen, cfg: ModelConfig, dtype):
    dev = L._device(gen)
    return {
        "self_norm": L.norm_init(cfg.d_model, "layernorm", device=dev),
        "self": L.init_attention(gen, cfg, dtype),
        "cross_norm": L.norm_init(cfg.d_model, "layernorm", device=dev),
        "cross": L.init_attention(gen, cfg, dtype),
        "mlp_norm": L.norm_init(cfg.d_model, "layernorm", device=dev),
        "mlp": L.init_mlp(gen, cfg, dtype=dtype),
    }


def init_whisper(gen: torch.Generator | None, cfg: ModelConfig,
                 dtype=torch.bfloat16):
    """Random params on ``gen``'s device in the reference's tree, each
    leaf drawn from ``gen`` in turn (``layers._normal``, as ``init_lm``)."""
    dev = L._device(gen)
    return {
        "embed": L._normal(gen, (padded_vocab(cfg), cfg.d_model), 0.02,
                           dtype),
        "dec_pos": L._normal(gen, (MAX_TARGET_POSITIONS, cfg.d_model), 0.02,
                             dtype),
        "enc_layers": [_init_enc_layer(gen, cfg, dtype)
                       for _ in range(cfg.encdec.num_layers)],
        "enc_norm": L.norm_init(cfg.d_model, "layernorm", device=dev),
        "dec_layers": [_init_dec_layer(gen, cfg, dtype)
                       for _ in range(cfg.num_layers)],
        "dec_norm": L.norm_init(cfg.d_model, "layernorm", device=dev),
    }


def _bidir_attn(p, cfg, x):
    """Non-causal encoder self-attention (dense: source_len is short)."""
    B, S, _ = x.shape
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = L._unflatten(L.dense(p["wq"], x), (B, S, H, Dh))
    k = L._unflatten(L.dense(p["wk"], x), (B, S, KV, Dh))
    v = L._unflatten(L.dense(p["wv"], x), (B, S, KV, Dh))
    out = L._attend_dense(q, k, v, None, Dh ** -0.5)
    return L.dense(p["wo"], L._flatten(out, (B, S, H * Dh)))


def encode(params, cfg: ModelConfig, frame_embeds):
    """(B, source_len, d_model) frames -> the encoder's output."""
    x = frame_embeds + _sinusoid(frame_embeds.shape[1], cfg.d_model,
                                 frame_embeds.device).to(
                                     frame_embeds.dtype)[None]
    for lp in params["enc_layers"]:
        x = x + _bidir_attn(lp["attn"], cfg,
                            L.apply_norm(lp["attn_norm"], x, "layernorm"))
        x = x + L.mlp_apply(lp["mlp"], cfg,
                            L.apply_norm(lp["mlp_norm"], x, "layernorm"))
    return L.apply_norm(params["enc_norm"], x, "layernorm")


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device)[None].expand(
        B, S)


def _cross_kv(p, cfg, enc_out):
    B, S, _ = enc_out.shape
    KV, Dh = cfg.num_kv_heads, cfg.head_dim
    k = L._unflatten(L.dense(p["wk"], enc_out), (B, S, KV, Dh))
    v = L._unflatten(L.dense(p["wv"], enc_out), (B, S, KV, Dh))
    return k, v, _positions(B, S, enc_out.device)


def decode(params, cfg: ModelConfig, tokens, enc_out, *, mode="full",
           states=None, positions=None):
    """Teacher-forced decode (``mode="full"``) or one step (``"step"``);
    returns (logits f32, states).

    ``states``: per layer ``{"self", "cross_k", "cross_v"}``
    (``init_whisper_states``); with them the cross keys and values are
    read from the states (``enc_out`` is not used) and the self caches
    are written in place, and the same list comes back; without them
    (teacher forcing) the cross keys and values are projected from
    ``enc_out`` and a list of None comes back. The reference
    rematerialises each layer of a teacher-forced pass past 512 tokens
    (``jax.checkpoint``), which changes no number; the port, which
    serves under ``inference_mode``, does not."""
    B, S = tokens.shape
    if positions is None:
        positions = _positions(B, S, tokens.device)
    x = (L.embed_lookup(params["embed"], tokens)
         + L.embed_lookup(params["dec_pos"], positions))
    for i, lp in enumerate(params["dec_layers"]):
        if states is None:
            ck, cv, cpos = _cross_kv(lp["cross"], cfg, enc_out)
            self_state = None
        else:
            st = states[i]
            ck, cv, self_state = st["cross_k"], st["cross_v"], st["self"]
            cpos = _positions(B, ck.shape[1], ck.device)
        h, _ = L.attention_apply(
            lp["self"], cfg, L.apply_norm(lp["self_norm"], x, "layernorm"),
            positions, mode=mode, state=self_state)
        x = x + h
        h, _ = L.attention_apply(
            lp["cross"], cfg, L.apply_norm(lp["cross_norm"], x, "layernorm"),
            positions, mode=mode, cross_kv=(ck, cv, cpos))
        x = x + h
        x = x + L.mlp_apply(lp["mlp"], cfg,
                            L.apply_norm(lp["mlp_norm"], x, "layernorm"))
    x = L.apply_norm(params["dec_norm"], x, "layernorm")
    logits = L.dense({"w": params["embed"].T}, x).float()
    return logits, ([None] * len(params["dec_layers"]) if states is None
                    else states)


def init_whisper_states(params, cfg: ModelConfig, B: int, max_len: int,
                        enc_out, dtype=torch.bfloat16) -> list:
    """Per decoder layer: an empty self-attention cache of ``max_len``
    slots in ``dtype``, and the cross keys and values projected from
    ``enc_out`` (in the params' dtype)."""
    states = []
    for lp in params["dec_layers"]:
        ck, cv, _ = _cross_kv(lp["cross"], cfg, enc_out)
        states.append({
            "self": L.init_attn_cache(cfg, B, max_len, dtype=dtype,
                                      device=enc_out.device),
            "cross_k": ck, "cross_v": cv,
        })
    return states


def refill_whisper_states(params, cfg: ModelConfig, states: list,
                          enc_out) -> list:
    """``states`` rebuilt in place for a new prompt: the cross keys and
    values projected from ``enc_out`` into their tensors, the self
    caches emptied, every tensor keeping its address and dtype. What the
    reference's prefill gets by building new states
    (``init_whisper_states``) at ``states_max_len(states)``; the
    reference builds those self caches in its default bf16 whatever
    dtype the caller gave, the port keeps the caller's."""
    for lp, st in zip(params["dec_layers"], states, strict=True):
        ck, cv, _ = _cross_kv(lp["cross"], cfg, enc_out)
        for name, new in (("cross_k", ck), ("cross_v", cv)):
            if st[name].shape != new.shape:
                raise ValueError(
                    f"whisper prefill: {name} of the states is "
                    f"{tuple(st[name].shape)}, the frames give "
                    f"{tuple(new.shape)}; build the states "
                    f"(init_states) from the same frame_embeds")
            st[name].copy_(new)
        st["self"]["k"].zero_()
        st["self"]["v"].zero_()
        st["self"]["pos_abs"].fill_(-1)
    return states
