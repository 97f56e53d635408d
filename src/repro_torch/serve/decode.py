"""Serving: batched prefill + single-token decode steps, the port of
``repro.serve.decode``.

``make_serve_step`` is the one-token step: one new token a row against
the per-layer decode states (KV caches, ring buffers under a window),
which it writes in place. ``greedy_generate`` prefills the prompt and
then decodes greedily, all under ``torch.inference_mode()``.
"""
from __future__ import annotations

import torch


def make_serve_step(model):
    def serve_step(params, states, tokens, positions):
        logits, states = model.decode_step(
            params, {"tokens": tokens, "positions": positions}, states)
        return logits, states
    return serve_step


def _greedy(logits):
    """(B, V) -> (B, 1) int32 ids of the first maximum (``jnp.argmax``'s
    tie rule, which ``torch.argmax`` shares)."""
    return logits.argmax(-1).to(torch.int32)[:, None]


def greedy_generate(model, params, prompt_tokens, *, max_new: int = 16,
                    max_len: int | None = None,
                    batch_extras: dict | None = None):
    """Prefill the prompt then greedily decode max_new tokens.

    prompt_tokens: (B, S) int32 on the params' device. Returns (B,
    max_new) int32 generated ids; (B, 0) for max_new <= 0. The states
    hold max_len positions (S + max_new by default). batch_extras: the
    family's inputs beyond the tokens, given to ``init_states`` and the
    prefill (whisper's ``frame_embeds``; a vlm's ``patch_embeds`` and
    ``patch_positions``, which replace the prompt's first tokens)."""
    B, S = prompt_tokens.shape
    dev = prompt_tokens.device
    if max_new <= 0:
        return torch.zeros((B, 0), dtype=torch.int32, device=dev)
    max_len = max_len or (S + max_new)
    extras = batch_extras or {}
    with torch.inference_mode():
        states = model.init_states(params, B, max_len, batch=extras or None)
        logits, states = model.prefill(
            params, {"tokens": prompt_tokens, **extras}, states)
        step = make_serve_step(model)
        tok = _greedy(logits[:, -1])
        out = [tok]
        for t in range(S, S + max_new - 1):
            pos = torch.full((B, 1), t, dtype=torch.int32, device=dev)
            logits, states = step(params, states, tok, pos)
            tok = _greedy(logits[:, -1])
            out.append(tok)
        return torch.cat(out, dim=1)
