"""Decoder-only LM over the dense, MoE, SSM, hybrid and vlm blocks: the
port of ``repro.models.transformer`` (``layer_plan``, ``_period``,
``init_lm``, ``embed_inputs``, ``forward`` over a whole sequence or one
decode step, ``forward_hidden``, ``mtp_logits``, ``unembed``,
``init_states``).

A *layer* is a (mixer, channel) pair with pre-norm residuals; the
mixers are ``attn``, ``attn_local``, ``mla``, ``rglru`` and ``ssd``, the
channels ``mlp``, ``moe`` and ``none`` (``ssd`` has no channel block).
An MoE config's first ``first_k_dense`` layers are a *prologue* of dense
layers, each stored on its own (``params["prologue"]``); the others are
stored STACKED per pattern slot, as in the reference: ``params["stack"]
[s]`` holds slot ``s`` of every layer cycle, each leaf with a leading
axis of ``n_cycles``, so that the leaves (and so the delta exchange's
codec scales and ``delta_wire_bytes``) are the reference's. The forward
runs the prologue and then indexes each cycle's layer out of the stack
in a Python loop (the reference's ``lax.scan``), summing the MoE layers'
aux losses; ``remat=True`` checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant), keeping only its input.
deepseek-v3's multi-token prediction head (``params["mtp"]``) predicts
token t + 2 from the final hidden state at t and token t + 1.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, padded_vocab
from repro_torch.models import layers as L
from repro_torch.utils.trees import tree_map


def layer_plan(cfg: ModelConfig) -> list[tuple[str, str]]:
    """[(mixer, channel)] for every layer."""
    plan = []
    pat = cfg.block_pattern
    for i in range(cfg.num_layers):
        mixer = pat[i % len(pat)]
        if mixer == "ssd":
            channel = "none"
        elif cfg.moe is not None and i >= cfg.moe.first_k_dense:
            channel = "moe"
        else:
            channel = "mlp"
        if cfg.mla is not None and mixer == "attn":
            mixer = "mla"
        plan.append((mixer, channel))
    return plan


def _period(cfg: ModelConfig) -> int:
    """Smallest cycle after which the (mixer, channel) plan repeats."""
    plan = layer_plan(cfg)
    base = len(cfg.block_pattern)
    k = cfg.moe.first_k_dense if cfg.moe else 0
    body = plan[k:]
    p = base
    while any(body[i] != body[i % p] for i in range(len(body))):
        p += base
    return p


_MIXER_INIT = {"attn": L.init_attention, "attn_local": L.init_attention,
               "mla": L.init_mla, "rglru": L.init_rglru, "ssd": L.init_ssd}
_CHANNEL_INIT = {"mlp": L.init_mlp, "moe": L.init_moe}


def _init_layer(gen, cfg, mixer, channel, dtype, lead=()):
    if mixer not in _MIXER_INIT:
        raise ValueError(f"unknown mixer {mixer!r}")
    p = {"mixer_norm": L.norm_init(cfg.d_model, cfg.norm, lead=lead,
                                   device=L._device(gen)),
         "mixer": _MIXER_INIT[mixer](gen, cfg, dtype, lead=lead)}
    if channel in _CHANNEL_INIT:
        p["channel"] = _CHANNEL_INIT[channel](gen, cfg, dtype=dtype,
                                              lead=lead)
        p["channel_norm"] = L.norm_init(cfg.d_model, cfg.norm, lead=lead,
                                        device=L._device(gen))
    elif channel != "none":
        raise ValueError(f"unknown channel {channel!r}")
    return p


def _apply_mixer(p, cfg, mixer, x, positions, mode, state):
    if mixer == "rglru":
        return L.rglru_apply(p, cfg, x, positions, mode=mode, state=state)
    if mixer == "ssd":
        return L.ssd_apply(p, cfg, x, positions, mode=mode, state=state)
    if mixer == "mla":
        return L.mla_apply(p, cfg, x, positions, mode=mode, state=state)
    local = mixer == "attn_local" or cfg.sliding_window is not None
    return L.attention_apply(p, cfg, x, positions, mode=mode, state=state,
                             local=local)


def _apply_layer(p, cfg, mixer, channel, x, positions, mode, state):
    """Returns (x, new_state, aux_loss): aux is the MoE channel's router
    loss (None for the other channels, which have none: no kernel is
    spent on a zero). A decode step's MoE routes without drops."""
    aux = None
    h_in = L.apply_norm(p["mixer_norm"], x, cfg.norm)
    h, state = _apply_mixer(p["mixer"], cfg, mixer, h_in, positions, mode,
                            state)
    if cfg.parallel_block and channel != "none":
        return x + h + L.mlp_apply(p["channel"], cfg, h_in), state, aux
    x = x + h
    if channel == "mlp":
        x = x + L.mlp_apply(p["channel"], cfg,
                            L.apply_norm(p["channel_norm"], x, cfg.norm))
    elif channel == "moe":
        y, aux = L.moe_apply(p["channel"], cfg,
                             L.apply_norm(p["channel_norm"], x, cfg.norm),
                             no_drop=(mode == "step"))
        x = x + y
    return x, state, aux


def init_lm(gen: torch.Generator | None, cfg: ModelConfig,
            dtype=torch.bfloat16):
    """Random params on ``gen``'s device, in the reference's tree: the
    prologue's layers each on its own, the leaves of each slot drawn
    stacked, ``(n_cycles, ...)``, and the MTP head. With no generator,
    on PyTorch's default generator and device (under
    ``torch.device("meta")``, the tree's shapes without allocating)."""
    v = padded_vocab(cfg)
    period = _period(cfg)
    plan = layer_plan(cfg)
    k_dense = _first_k_dense(cfg)
    n_cycles = (len(plan) - k_dense) // period
    params: dict[str, Any] = {
        "embed": (L._randn(gen, (v, cfg.d_model)) * 0.02).to(dtype),
        "final_norm": L.norm_init(cfg.d_model, cfg.norm,
                                  device=L._device(gen)),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = (L._randn(gen, (cfg.d_model, v))
                             / np.sqrt(cfg.d_model)).to(dtype)
    params["prologue"] = [_init_layer(gen, cfg, *plan[i], dtype)
                          for i in range(k_dense)]
    params["stack"] = [_init_layer(gen, cfg, *plan[k_dense + s], dtype,
                                   (n_cycles,))
                       for s in range(period)]
    if cfg.mtp_depth > 0:
        params["mtp"] = {
            "proj": L.dense_init(gen, 2 * cfg.d_model, cfg.d_model,
                                 dtype=dtype),
            "norm": L.norm_init(cfg.d_model, cfg.norm,
                                device=L._device(gen)),
            "layer": _init_layer(gen, cfg, plan[-1][0], "mlp", dtype),
        }
    return params


def _first_k_dense(cfg: ModelConfig) -> int:
    return cfg.moe.first_k_dense if cfg.moe else 0


def embed_inputs(params, cfg: ModelConfig, batch: dict):
    """Token embedding and (VLM) patch-embedding early fusion; returns
    (x, positions), positions (B, S) int32, or (B, S, 3) under M-RoPE.
    With ``patch_embeds`` (B, P, d_model) in the batch (M-RoPE only, as
    in the reference), they replace the first P token embeddings and
    ``patch_positions`` (B, P, 3) the first P positions."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = params["embed"][tokens.long()]
    if "positions" in batch:
        positions = batch["positions"]
    else:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None].expand(B, S)
    if cfg.rope_style == "mrope":
        if positions.ndim == 2:
            positions = positions[..., None].expand(B, S, 3)
        if "patch_embeds" in batch:
            pe = batch["patch_embeds"].to(x.dtype)
            P = pe.shape[1]
            x = torch.cat([pe, x[:, P:]], dim=1)
            positions = torch.cat([batch["patch_positions"].to(
                positions.dtype), positions[:, P:]], dim=1)
    return x, positions


def _trunk(params, cfg: ModelConfig, batch: dict, mode: str, states,
           remat: bool):
    """Every layer, the prologue first, then ``final_norm``: (hidden,
    new_states, the summed aux loss)."""
    plan = layer_plan(cfg)
    k_dense = _first_k_dense(cfg)
    period = _period(cfg)
    n_cycles = (len(plan) - k_dense) // period
    x, positions = embed_inputs(params, cfg, batch)
    aux_total = None
    new_states: list = [None] * len(plan)
    layers = [(i, lp) for i, lp in enumerate(params["prologue"])] + [
        (k_dense + c * period + s,
         tree_map(lambda a, c=c: a[c], params["stack"][s]))
        for c in range(n_cycles) for s in range(period)]
    for li, lp in layers:
        st = None if states is None else states[li]
        if remat:
            x, new_states[li], aux = checkpoint(
                _apply_layer, lp, cfg, *plan[li], x, positions, mode, st,
                use_reentrant=False)
        else:
            x, new_states[li], aux = _apply_layer(lp, cfg, *plan[li], x,
                                                  positions, mode, st)
        if aux is not None:
            aux_total = aux if aux_total is None else aux_total + aux
    if aux_total is None:
        aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    return L.apply_norm(params["final_norm"], x, cfg.norm), new_states, (
        aux_total)


def forward(params, cfg: ModelConfig, batch: dict, *, mode: str = "full",
            states: list | None = None, unroll: bool = False,
            remat: bool = False, last_logits_only: bool = False):
    """Returns (logits f32, new_states, aux_loss), aux_loss the MoE
    layers' router losses summed (an f32 zero without MoE).

    mode="full" runs the whole sequence (and, with ``states``, fills the
    caches: prefill); mode="step" runs one token per row against
    ``states`` (decode), whose caches are written in place. ``states``:
    per-layer decode states in plan order, the prologue's first
    (``init_states``), or None for the stateless train forward;
    ``new_states`` is that list again (a list of None without states).
    ``unroll`` changes nothing: the port's forward is always the loop
    over the stacked params that the reference's ``unroll=True`` is.
    remat=True checkpoints each layer. last_logits_only keeps only the
    last position for the unembedding (serving prefill)."""
    x, new_states, aux = _trunk(params, cfg, batch, mode, states, remat)
    if last_logits_only:
        x = x[:, -1:]
    return unembed(params, cfg, x), new_states, aux


def forward_hidden(params, cfg: ModelConfig, batch: dict, *,
                   remat: bool = False):
    """The train forward's (logits, hidden, aux_loss): hidden the final
    hidden states after ``final_norm``, what the MTP head reads."""
    x, _, aux = _trunk(params, cfg, batch, "full", None, remat)
    return unembed(params, cfg, x), x, aux


def mtp_logits(params, cfg: ModelConfig, hidden, batch):
    """deepseek-v3's multi-token prediction head (depth 1): the logits of
    token t + 2 from [norm(h_t) ; embed(token_{t+1})], projected to
    d_model and through one layer of the last layer's mixer with a dense
    MLP, at positions 0 ... S - 2; (B, S - 1, V)."""
    mtp = params["mtp"]
    tokens = batch["tokens"]
    emb_next = params["embed"][tokens[:, 1:].long()]
    h2 = L.dense(mtp["proj"], torch.cat([
        L.apply_norm(mtp["norm"], hidden[:, :-1], cfg.norm), emb_next], -1))
    B, S1 = tokens.shape[0], tokens.shape[1] - 1
    positions = torch.arange(S1, dtype=torch.int32,
                             device=tokens.device)[None].expand(B, S1)
    h2, _, _ = _apply_layer(mtp["layer"], cfg, layer_plan(cfg)[-1][0], "mlp",
                            h2, positions, "full", None)
    return unembed(params, cfg, h2)


def unembed(params, cfg: ModelConfig, x):
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    logits = (x @ w).float()
    if cfg.logit_softcap:
        logits = torch.tanh(logits / cfg.logit_softcap) * cfg.logit_softcap
    return logits


def init_states(cfg: ModelConfig, B: int, max_len: int,
                dtype=torch.bfloat16, device=None) -> list:
    """Per-layer decode state in plan order: an attention cache
    (``layers.init_attn_cache``), windowed for ``attn_local`` layers and
    under ``cfg.sliding_window``; the latent cache ``{c, kr, pos_abs}``
    for ``mla`` layers; ``{h, conv}`` for ``rglru`` and ``ssd`` layers
    (``h`` f32, the conv tail in ``dtype``)."""
    states = []
    for mixer, _ in layer_plan(cfg):
        if mixer == "attn":
            states.append(L.init_attn_cache(cfg, B, max_len,
                                            window=cfg.sliding_window,
                                            dtype=dtype, device=device))
        elif mixer == "attn_local":
            w = cfg.rglru.local_window if cfg.rglru else cfg.sliding_window
            states.append(L.init_attn_cache(cfg, B, max_len, window=w,
                                            dtype=dtype, device=device))
        elif mixer == "mla":
            states.append(L.init_mla_cache(cfg, B, max_len, dtype=dtype,
                                           device=device))
        elif mixer == "rglru":
            states.append(L.init_rglru_state(cfg, B, dtype=dtype,
                                             device=device))
        elif mixer == "ssd":
            states.append(L.init_ssd_state(cfg, B, dtype=dtype,
                                           device=device))
        else:
            raise ValueError(f"unknown mixer {mixer!r}")
    return states
