"""Model primitives, the dense subset: the port of ``repro.models.layers``.

Every module is a pair ``init_*(generator, ...) -> params-dict`` and an
apply function, over the reference's parameter layout (weights ``(d_in,
d_out)``, applied as ``x @ w``), so that a reference param tree carries
across leaf for leaf (``models.carry``). The init functions take a
``lead`` shape that is prepended to every leaf: the transformer keeps
each slot's layers stacked in one tensor, as the reference does.

Numerics follow the reference's order: params in bf16 and norm scales
in f32; a norm computes in f32 and casts back; RoPE rotates in f32;
attention takes its logits, softmax and sums in f32.

Here so far: ``dense``, the norms, the activations, full and partial
RoPE, dense attention (``_attend_dense``), flash attention with a
backward that recomputes the score blocks, the GQA attention block with
its decode cache (a ring buffer under a window) and the (gated) MLP.
MLA, MoE, RG-LRU and SSD are not ported yet (ROADMAP.md, Queue 1 item
12), nor is the reference's sharding (``constrain``, item 13).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

# ----------------------------------------------------------------------
# basics
# ----------------------------------------------------------------------


def _randn(gen: torch.Generator | None, shape) -> torch.Tensor:
    """Standard normal f32 from ``gen`` on its device; with no generator,
    PyTorch's default one on the default device (under
    ``torch.device("meta")``: shapes only, nothing allocated)."""
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=None if gen is None else gen.device)


def _device(gen: torch.Generator | None):
    return None if gen is None else gen.device


def dense_init(gen, d_in, d_out, *, bias=False, dtype=torch.bfloat16,
               scale=None, lead=()):
    scale = (1.0 / math.sqrt(d_in)) if scale is None else scale
    # in place: one f32 draw beside the result, not two (a stacked
    # (32, 6144, 24576) leaf is 19.3 GB in f32); the same values
    p = {"w": _randn(gen, (*lead, d_in, d_out)).mul_(scale).to(dtype)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype,
                             device=_device(gen))
    return p


def dense(p, x):
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def norm_init(d, kind="rmsnorm", *, lead=(), device=None):
    p = {"scale": torch.ones((*lead, d), dtype=torch.float32, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((*lead, d), dtype=torch.float32,
                                device=device)
    return p


def apply_norm(p, x, kind="rmsnorm", eps=1e-6):
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    else:
        mu = torch.mean(xf, -1, keepdim=True)
        var = torch.mean((xf - mu) ** 2, -1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        if "bias" in p:
            y = y + p["bias"]
    return (y * p["scale"]).to(x.dtype)


_ACTS = {
    # the reference's jax.nn.silu, x * sigmoid(x): in bf16 the sigmoid is
    # rounded before the product (F.silu rounds once, and misses the
    # reference's bf16 logits at twice as many elements)
    "silu": lambda x: x * torch.sigmoid(x),
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "relu2": lambda x: torch.square(F.relu(x)),
}

# ----------------------------------------------------------------------
# RoPE (full / partial)
# ----------------------------------------------------------------------


def _rope_angles(positions, rot_dim, theta):
    """positions (..., S) -> cos/sin of shape (..., S, rot_dim/2)."""
    ar = torch.arange(0, rot_dim, 2, dtype=torch.float32,
                      device=positions.device)
    inv = 1.0 / (theta ** (ar / rot_dim))
    ang = positions[..., None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def _rotate(x, cos, sin):
    """x (..., rot_dim) with cos/sin (..., rot_dim/2): pairwise rotation."""
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)


def apply_rope(x, positions, cfg: ModelConfig):
    """x (B,S,H,D); positions (B,S)."""
    D = x.shape[-1]
    if cfg.rope_style == "none":
        return x
    if cfg.rope_style not in ("full", "partial"):
        raise NotImplementedError(
            f"rope_style={cfg.rope_style!r} is not ported yet (ROADMAP.md, "
            f"Queue 1 item 12)")
    rot = int(D * cfg.rope_frac)
    rot -= rot % 2
    xr, xp = x[..., :rot], x[..., rot:]
    cos, sin = _rope_angles(positions, rot, cfg.rope_theta)   # (B,S,rot/2)
    out = _rotate(xr.float(), cos[:, :, None, :], sin[:, :, None, :])
    return torch.cat([out.to(x.dtype), xp], -1)

# ----------------------------------------------------------------------
# attention
# ----------------------------------------------------------------------


def _attend_dense(q, k, v, mask, scale, softcap=None):
    """Dense attention for short S. q (B,Sq,H,D), k/v (B,Skv,KV,D); mask
    broadcastable to (B,1,Sq,Skv) or None."""
    B, Sq, H, D = q.shape
    KV, Dv = k.shape[2], v.shape[-1]
    g = H // KV
    qf = (q * scale).float().reshape(B, Sq, KV, g, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qf, k.float())
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    if mask is not None:
        logits = torch.where(mask[:, :, None, :, :], logits,
                             torch.full_like(logits, -1e30))
    p = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return out.reshape(B, Sq, H, Dv).to(q.dtype)


def _chunk_mask(qpi, kpj, causal, window):
    """(B,1,1,qc,kvc) validity mask from absolute positions."""
    m = torch.ones((qpi.shape[0], 1, 1, qpi.shape[1], kpj.shape[1]),
                   dtype=torch.bool, device=qpi.device)
    if causal:
        m = m & (kpj[:, None, None, None, :] <= qpi[:, None, None, :, None])
    if window is not None:
        m = m & (kpj[:, None, None, None, :] >
                 qpi[:, None, None, :, None] - window)
    return m


def _spans(n: int, chunk: int):
    return [(s, min(s + chunk, n)) for s in range(0, n, chunk)]


class _Flash(torch.autograd.Function):
    """Streaming-softmax attention over q chunks and kv chunks, in f32.
    The forward keeps only the output and the row log-sum-exp; the
    backward recomputes each (q chunk x kv chunk) score block from them
    instead of saving S^2 probabilities (the reference's custom VJP,
    ``_flash_vjp``)."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, kv_pos, causal, window, scale,
                q_chunk, kv_chunk, softcap):
        B, Sq, H, D = q.shape
        Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
        g = H // KV
        qf = q.float().reshape(B, Sq, KV, g, D)
        kf, vf = k.float(), v.float()
        outs = torch.empty((B, KV, g, Sq, Dv), dtype=torch.float32,
                           device=q.device)
        lses = torch.empty((B, KV, g, Sq), dtype=torch.float32,
                           device=q.device)
        for s0, s1 in _spans(Sq, q_chunk):
            qi, qpi = qf[:, s0:s1], q_pos[:, s0:s1]
            m = torch.full((B, KV, g, s1 - s0), -math.inf,
                           dtype=torch.float32, device=q.device)
            l = torch.zeros_like(m)
            acc = torch.zeros((B, KV, g, s1 - s0, Dv), dtype=torch.float32,
                              device=q.device)
            for a, b in _spans(Skv, kv_chunk):
                z = scale * torch.einsum("bqkgd,bskd->bkgqs", qi, kf[:, a:b])
                if softcap:
                    z = torch.tanh(z / softcap) * softcap
                z = torch.where(_chunk_mask(qpi, kv_pos[:, a:b], causal,
                                            window), z,
                                torch.full_like(z, -1e30))
                m_new = torch.maximum(m, z.amax(-1))
                p = torch.exp(z - m_new[..., None])
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1)
                acc = acc * corr[..., None] + torch.einsum(
                    "bkgqs,bskd->bkgqd", p, vf[:, a:b])
                m = m_new
            outs[..., s0:s1, :] = acc / torch.clamp(l, min=1e-30)[..., None]
            lses[..., s0:s1] = torch.where(
                l > 0, m + torch.log(torch.clamp(l, min=1e-30)),
                torch.full_like(l, 1e30))
        ctx.save_for_backward(q, k, v, q_pos, kv_pos, outs, lses)
        ctx.cfg = (causal, window, scale, q_chunk, kv_chunk, softcap)
        out = outs.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, Dv)
        return out.to(q.dtype)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, q_pos, kv_pos, outs, lses = ctx.saved_tensors
        causal, window, scale, q_chunk, kv_chunk, softcap = ctx.cfg
        B, Sq, H, D = q.shape
        Skv, KV, Dv = k.shape[1], k.shape[2], v.shape[-1]
        g = H // KV
        qf = q.float().reshape(B, Sq, KV, g, D)
        kf, vf = k.float(), v.float()
        douts = dout.float().reshape(B, Sq, KV, g, Dv).permute(0, 2, 3, 1, 4)
        Dres = torch.sum(douts * outs, -1)                  # (B,KV,g,Sq)
        dq = torch.zeros((B, Sq, KV, g, D), dtype=torch.float32,
                         device=q.device)
        dk = torch.zeros((B, Skv, KV, D), dtype=torch.float32,
                         device=q.device)
        dv = torch.zeros((B, Skv, KV, Dv), dtype=torch.float32,
                         device=q.device)
        for s0, s1 in _spans(Sq, q_chunk):
            qi, qpi = qf[:, s0:s1], q_pos[:, s0:s1]
            lse_i, dout_i = lses[..., s0:s1], douts[..., s0:s1, :]
            D_i = Dres[..., s0:s1]
            dq_i = torch.zeros_like(qi)
            for a, b in _spans(Skv, kv_chunk):
                kj, vj = kf[:, a:b], vf[:, a:b]
                mask = _chunk_mask(qpi, kv_pos[:, a:b], causal, window)
                z = scale * torch.einsum("bqkgd,bskd->bkgqs", qi, kj)
                if softcap:
                    t = torch.tanh(z / softcap)
                    zc = torch.where(mask, t * softcap,
                                     torch.full_like(z, -1e30))
                else:
                    zc = torch.where(mask, z, torch.full_like(z, -1e30))
                p = torch.exp(zc - lse_i[..., None])
                dv_j = torch.einsum("bkgqs,bkgqd->bskd", p, dout_i)
                dp = torch.einsum("bkgqd,bskd->bkgqs", dout_i, vj)
                ds = p * (dp - D_i[..., None])
                if softcap:
                    ds = ds * (1.0 - t * t)
                dq_i = dq_i + scale * torch.einsum("bkgqs,bskd->bqkgd", ds,
                                                   kj)
                dk[:, a:b] += scale * torch.einsum("bkgqs,bqkgd->bskd", ds,
                                                   qi)
                dv[:, a:b] += dv_j
            dq[:, s0:s1] = dq_i
        return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype),
                dv.to(v.dtype)) + (None,) * 8


def flash_attention(q, k, v, *, q_pos, kv_pos, causal=True, window=None,
                    scale, q_chunk=512, kv_chunk=1024, softcap=None):
    """Memory-efficient attention: O(S) residuals in both directions.
    q (B,Sq,H,D); k/v (B,Skv,KV,D) with GQA; q_pos (B,Sq), kv_pos (B,Skv)
    absolute positions for the causal and window masks. Returns
    (B,Sq,H,Dv) in q's dtype."""
    return _Flash.apply(q, k, v, q_pos, kv_pos, causal, window, float(scale),
                        int(min(q_chunk, q.shape[1])),
                        int(min(kv_chunk, k.shape[1])),
                        None if softcap is None else float(softcap))

# ----------------------------------------------------------------------
# GQA attention block over a whole sequence
# ----------------------------------------------------------------------


def init_attention(gen, cfg: ModelConfig, dtype=torch.bfloat16, lead=()):
    d, H, KV, Dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": dense_init(gen, d, H * Dh, bias=cfg.attn_bias, dtype=dtype,
                         lead=lead),
        "wk": dense_init(gen, d, KV * Dh, bias=cfg.attn_bias, dtype=dtype,
                         lead=lead),
        "wv": dense_init(gen, d, KV * Dh, bias=cfg.attn_bias, dtype=dtype,
                         lead=lead),
        "wo": dense_init(gen, H * Dh, d, dtype=dtype, lead=lead),
    }


def attention_apply(p, cfg: ModelConfig, x, positions, *, mode="full",
                    state=None, local: bool = False):
    """GQA self-attention; returns (y, new_state). local=True uses
    cfg.rglru.local_window (hybrid) or cfg.sliding_window.

    ``mode="full"``: flash attention over the whole sequence; with a
    ``state`` (prefill), the sequence's last T keys and values are also
    written into it. ``mode="step"`` (S == 1, decode): the token's key
    and value are written at ``pos % T`` and it attends densely over the
    whole cache, to the slots holding positions ``<= pos`` (and ``> pos
    - window`` when windowed). Either writes the cache in place, into
    the tensors of ``state``, and returns that same dict: a caller who
    kept an older ``state`` sees it change."""
    B, S, _ = x.shape
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    window = None
    if local:
        window = cfg.rglru.local_window if cfg.rglru else cfg.sliding_window
    scale = Dh ** -0.5
    q = dense(p["wq"], x).reshape(B, S, H, Dh)
    k = dense(p["wk"], x).reshape(B, S, KV, Dh)
    v = dense(p["wv"], x).reshape(B, S, KV, Dh)
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)
    if mode == "full":
        out = flash_attention(q, k, v, q_pos=positions, kv_pos=positions,
                              causal=True, window=window, scale=scale,
                              softcap=cfg.logit_softcap)
        if state is not None:
            state = _cache_fill(state, k, v, positions)
    elif mode == "step":
        state = _cache_append(state, k, v, positions)
        cpos = state["pos_abs"]
        mask = (cpos <= positions) & (cpos >= 0)
        if window is not None:
            mask &= cpos > positions - window
        out = _attend_dense(q, state["k"], state["v"], mask[:, None, None, :],
                            scale, cfg.logit_softcap)
    else:
        raise ValueError(f"attention_apply: mode {mode!r}, not 'full' or "
                         f"'step'")
    return dense(p["wo"], out.reshape(B, S, H * Dh)), state


def init_attn_cache(cfg: ModelConfig, B, max_len, *, window=None,
                    dtype=torch.bfloat16, device=None):
    """One attention layer's decode cache: ``k``, ``v`` (B, T, KV, Dh)
    zeros and ``pos_abs`` (B, T) int32, -1 marking an empty slot; T =
    min(window, max_len) when windowed, else max_len."""
    T = min(window, max_len) if window else max_len
    KV, Dh = cfg.num_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((B, T, KV, Dh), dtype=dtype, device=device),
        "v": torch.zeros((B, T, KV, Dh), dtype=dtype, device=device),
        "pos_abs": torch.full((B, T), -1, dtype=torch.int32, device=device),
    }


def _cache_write(state, bidx, slot, k, v, pos):
    state["k"].index_put_((bidx, slot), k.to(state["k"].dtype))
    state["v"].index_put_((bidx, slot), v.to(state["v"].dtype))
    state["pos_abs"].index_put_((bidx, slot), pos.to(torch.int32))
    return state


def _cache_append(state, k, v, pos):
    """Write one token (S == 1) at pos (B, 1), slot ``pos % T``: a ring
    buffer when windowed."""
    T = state["k"].shape[1]
    bidx = torch.arange(k.shape[0], device=k.device)
    return _cache_write(state, bidx, (pos[:, 0] % T).long(), k[:, 0],
                        v[:, 0], pos[:, 0])


def _cache_fill(state, k, v, pos):
    """Bulk prefill: write the last T positions, each at ``pos % T``."""
    T = state["k"].shape[1]
    k, v, pos = k[:, -T:], v[:, -T:], pos[:, -T:]
    bidx = torch.arange(k.shape[0], device=k.device)[:, None]
    return _cache_write(state, bidx, (pos % T).long(), k, v, pos)

# ----------------------------------------------------------------------
# MLP
# ----------------------------------------------------------------------


def init_mlp(gen, cfg: ModelConfig, d_ff=None, dtype=torch.bfloat16,
             lead=()):
    d_ff = d_ff or cfg.d_ff
    p = {"w_up": dense_init(gen, cfg.d_model, d_ff, bias=cfg.mlp_bias,
                            dtype=dtype, lead=lead),
         "w_down": dense_init(gen, d_ff, cfg.d_model, bias=cfg.mlp_bias,
                              dtype=dtype, lead=lead)}
    if cfg.mlp_gated:
        p["w_gate"] = dense_init(gen, cfg.d_model, d_ff, bias=cfg.mlp_bias,
                                 dtype=dtype, lead=lead)
    return p


def mlp_apply(p, cfg: ModelConfig, x):
    act = _ACTS[cfg.mlp_act]
    h = act(dense(p["w_up"], x)) if "w_gate" not in p else (
        act(dense(p["w_gate"], x)) * dense(p["w_up"], x))
    return dense(p["w_down"], h)
