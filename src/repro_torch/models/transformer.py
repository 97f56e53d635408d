"""Decoder-only LM over the dense, SSM, hybrid and vlm blocks: the port of
``repro.models.transformer`` (``layer_plan``, ``_period``, ``init_lm``,
``embed_inputs``, ``forward`` over a whole sequence or one decode step,
``unembed``, ``init_states``).

A *layer* is a (mixer, channel) pair with pre-norm residuals; the
mixers ported are ``attn``, ``attn_local``, ``rglru`` and ``ssd``, the
channels ``mlp`` and ``none`` (``ssd`` has no channel block). Layers are
stored STACKED per pattern slot, as in the reference: ``params["stack"]
[s]`` holds slot ``s`` of every layer cycle, each leaf with a leading
axis of ``n_cycles``, so that the leaves (and so the delta exchange's
codec scales and ``delta_wire_bytes``) are the reference's. The forward
indexes each cycle's layer out of the stack in a Python loop (the
reference's ``lax.scan``); ``remat=True`` checkpoints each layer
(``torch.utils.checkpoint``, non-reentrant), keeping only its input.
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


def _unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md, Queue 1 item 12: MoE, then "
        f"MLA with multi-token prediction, are what is left)")


_MIXER_INIT = {"attn": L.init_attention, "attn_local": L.init_attention,
               "rglru": L.init_rglru, "ssd": L.init_ssd}


def _init_layer(gen, cfg, mixer, channel, dtype, lead):
    if mixer not in _MIXER_INIT:
        raise _unported(f"mixer {mixer!r}")
    if channel not in ("mlp", "none"):
        raise _unported(f"channel {channel!r}")
    p = {"mixer_norm": L.norm_init(cfg.d_model, cfg.norm, lead=lead,
                                   device=L._device(gen)),
         "mixer": _MIXER_INIT[mixer](gen, cfg, dtype, lead=lead)}
    if channel == "mlp":
        p["channel"] = L.init_mlp(gen, cfg, dtype=dtype, lead=lead)
        p["channel_norm"] = L.norm_init(cfg.d_model, cfg.norm, lead=lead,
                                        device=L._device(gen))
    return p


def _apply_mixer(p, cfg, mixer, x, positions, mode, state):
    if mixer == "rglru":
        return L.rglru_apply(p, cfg, x, positions, mode=mode, state=state)
    if mixer == "ssd":
        return L.ssd_apply(p, cfg, x, positions, mode=mode, state=state)
    local = mixer == "attn_local" or cfg.sliding_window is not None
    return L.attention_apply(p, cfg, x, positions, mode=mode, state=state,
                             local=local)


def _apply_layer(p, cfg, mixer, channel, x, positions, mode, state):
    """Returns (x, new_state)."""
    h_in = L.apply_norm(p["mixer_norm"], x, cfg.norm)
    h, state = _apply_mixer(p["mixer"], cfg, mixer, h_in, positions, mode,
                            state)
    if cfg.parallel_block and channel != "none":
        return x + h + L.mlp_apply(p["channel"], cfg, h_in), state
    x = x + h
    if channel == "mlp":
        x = x + L.mlp_apply(p["channel"], cfg,
                            L.apply_norm(p["channel_norm"], x, cfg.norm))
    return x, state


def init_lm(gen: torch.Generator | None, cfg: ModelConfig,
            dtype=torch.bfloat16):
    """Random params on ``gen``'s device, in the reference's tree: the
    leaves of each slot drawn stacked, ``(n_cycles, ...)``. With no
    generator, on PyTorch's default generator and device (under
    ``torch.device("meta")``, the tree's shapes without allocating)."""
    if cfg.moe is not None or cfg.mtp_depth > 0:
        raise _unported("MoE / multi-token prediction")
    v = padded_vocab(cfg)
    period = _period(cfg)
    plan = layer_plan(cfg)
    n_cycles = len(plan) // period
    params: dict[str, Any] = {
        "embed": (L._randn(gen, (v, cfg.d_model)) * 0.02).to(dtype),
        "final_norm": L.norm_init(cfg.d_model, cfg.norm,
                                  device=L._device(gen)),
    }
    if not cfg.tie_embeddings:
        params["unembed"] = (L._randn(gen, (cfg.d_model, v))
                             / np.sqrt(cfg.d_model)).to(dtype)
    params["prologue"] = []
    params["stack"] = [_init_layer(gen, cfg, *plan[s], dtype, (n_cycles,))
                       for s in range(period)]
    return params


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


def forward(params, cfg: ModelConfig, batch: dict, *, mode: str = "full",
            states: list | None = None, unroll: bool = False,
            remat: bool = False, last_logits_only: bool = False):
    """Returns (logits f32, new_states, aux_loss).

    mode="full" runs the whole sequence (and, with ``states``, fills the
    caches: prefill); mode="step" runs one token per row against
    ``states`` (decode), whose caches are written in place. ``states``:
    per-layer decode states in plan order (``init_states``), or None for
    the stateless train forward; ``new_states`` is that list again (a
    list of None without states). ``unroll`` changes nothing: the
    port's forward is always the loop over the stacked params that the
    reference's ``unroll=True`` is. remat=True checkpoints each layer.
    last_logits_only keeps only the last position for the unembedding
    (serving prefill)."""
    if params["prologue"]:
        raise _unported("a prologue of dense layers (MoE)")
    plan = layer_plan(cfg)
    period = _period(cfg)
    n_cycles = len(plan) // period
    x, positions = embed_inputs(params, cfg, batch)
    new_states: list = [None] * len(plan)
    for c in range(n_cycles):
        for s in range(period):
            li = c * period + s
            lp = tree_map(lambda a: a[c], params["stack"][s])
            st = None if states is None else states[li]
            if remat:
                x, new_states[li] = checkpoint(
                    _apply_layer, lp, cfg, *plan[s], x, positions, mode, st,
                    use_reentrant=False)
            else:
                x, new_states[li] = _apply_layer(lp, cfg, *plan[s], x,
                                                 positions, mode, st)
    x = L.apply_norm(params["final_norm"], x, cfg.norm)
    if last_logits_only:
        x = x[:, -1:]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return unembed(params, cfg, x), new_states, aux


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
    under ``cfg.sliding_window``; ``{h, conv}`` for ``rglru`` and ``ssd``
    layers (``h`` f32, the conv tail in ``dtype``)."""
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
        elif mixer == "rglru":
            states.append(L.init_rglru_state(cfg, B, dtype=dtype,
                                             device=device))
        elif mixer == "ssd":
            states.append(L.init_ssd_state(cfg, B, dtype=dtype,
                                           device=device))
        else:
            raise _unported(f"the decode state of mixer {mixer!r}")
    return states
