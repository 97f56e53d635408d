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

Here so far: ``dense``, the norms, the activations, full, partial, 2d
and M-RoPE, dense attention (``_attend_dense``), flash attention with a
backward that recomputes the score blocks, the GQA attention block with
its decode cache (a ring buffer under a window) and as cross-attention
(whisper's decoder), the (gated) MLP, the causal depthwise conv1d, the
RG-LRU block (griffin) and the SSD block (mamba2), each with its decode
state, MLA (deepseek-v3's latent-compressed attention, absorbed at
decode) with its latent cache, and the mixture of experts (a router,
the reference's sort-based capacity dispatch, the batched experts and a
combine in a fixed order). Every decode state is written in place: the
attention and latent caches' slots, the recurrent ``h`` and the conv
tail, so a state's tensors keep their addresses across steps. The
reference's sharding (``constrain``, ``constrain_cache`` and the
expert-parallel ``_moe_sharded``) is not ported yet (ROADMAP.md, Queue 1
item 13).
"""
from __future__ import annotations

import dataclasses
import itertools
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


# a leaf whose f32 draw takes at most this many bytes is drawn whole
_WHOLE_DRAW_BYTES = 1 << 31


def _normal(gen, shape, scale, dtype, lead=()) -> torch.Tensor:
    """``scale`` times a standard normal draw of ``(*lead, *shape)`` in
    ``dtype``. A leaf whose f32 draw exceeds ``_WHOLE_DRAW_BYTES`` is
    drawn one slot of ``lead`` at a time, so that the f32 transient is
    one slot's (command-r-35b's stacked (40, 8192, 22528) ``w_gate`` is
    29.5 GB in f32, a slot 0.74 GB); a slot that still exceeds it one
    row of its first axis at a time (an expert: llama4-maverick's slot
    of ``w_up``, (128, 5120, 8192), is 21.5 GB in f32, an expert 0.17
    GB); a smaller one whole, as it always was. On the CPU generator
    these give the same values wherever a part holds a multiple of 16
    elements; on the CUDA one they do not, so the whole draw keeps the
    smaller configs' random models (tinyllama-1.1b's among them) as they
    were."""
    if 4 * math.prod(lead) * math.prod(shape) <= _WHOLE_DRAW_BYTES:
        return _randn(gen, (*lead, *shape)).mul_(scale).to(dtype)
    out = torch.empty((*lead, *shape), dtype=dtype, device=_device(gen))
    if out.is_meta:                 # shapes only: nothing to draw
        return out
    if 4 * math.prod(shape) > _WHOLE_DRAW_BYTES and len(shape) > 1:
        lead, shape = (*lead, shape[0]), shape[1:]
    for idx in itertools.product(*map(range, lead)):
        out[idx] = _randn(gen, shape).mul_(scale)
    return out


def _uniform(gen, shape, lo, hi) -> torch.Tensor:
    """Uniform f32 on [lo, hi) from ``gen`` on its device."""
    return torch.empty(shape, dtype=torch.float32,
                       device=_device(gen)).uniform_(lo, hi, generator=gen)


def dense_init(gen, d_in, d_out, *, bias=False, dtype=torch.bfloat16,
               scale=None, lead=()):
    scale = (1.0 / math.sqrt(d_in)) if scale is None else scale
    p = {"w": _normal(gen, (d_in, d_out), scale, dtype, lead)}
    if bias:
        p["b"] = torch.zeros((*lead, d_out), dtype=dtype,
                             device=_device(gen))
    return p


def dense(p, x):
    """``x @ w (+ b)``, in the promoted dtype where x's and w's differ, as
    jnp's product promotes (whisper's bf16 frames into f32 weights)."""
    w = p["w"]
    if x.dtype != w.dtype:
        dt = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dt), w.to(dt)
    y = x @ w
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


class _Logistic(torch.autograd.Function):
    """``jax.nn.sigmoid`` (``lax.logistic``): ``1 / (1 + exp(-x))``, each
    op rounded in x's dtype, which is how the reference computes it in
    bf16 (``torch.sigmoid`` rounds once and differs at a third of the
    bf16 elements); its derivative ``s * (1 - s)`` from the output, as
    jax's, so that ``exp(-x) = inf`` gives 0 and not NaN. Four kernels
    where ``torch.sigmoid`` is one: the SSD block takes it, the MLP's
    silu keeps ``torch.sigmoid`` (see ``_ACTS``)."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1 - s))


def _sigmoid(x):
    """``jax.nn.sigmoid``: op by op (``_Logistic``) below f32; in f32
    ``torch.sigmoid``, within an ulp of it."""
    return torch.sigmoid(x) if x.dtype == torch.float32 else (
        _Logistic.apply(x))


def _rounded(v: float, dtype) -> float:
    """``v`` rounded to ``dtype``: jax rounds a Python scalar to the
    array's dtype before the op, PyTorch keeps it at full precision."""
    return float(torch.tensor(v, dtype=torch.float64).to(dtype))


def _gelu(x):
    """``jax.nn.gelu`` (``approximate=True``), op by op in x's dtype with
    its constants rounded to it; ``F.gelu(approximate="tanh")`` rounds
    once and misses recurrentgemma's bf16 logits at 1.9-2.0x the
    elements the reference's own op-by-op run does."""
    c = _rounded(math.sqrt(2 / math.pi), x.dtype)
    k = _rounded(0.044715, x.dtype)
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x ** 3)))))


_ACTS = {
    # the reference's jax.nn.silu, x * sigmoid(x): in bf16 the sigmoid is
    # rounded before the product (F.silu rounds once, and misses the
    # reference's bf16 logits at twice as many elements). The dense MLPs
    # meet the reference's bf16 logits with torch.sigmoid; _sigmoid's
    # op-by-op form slowed tinyllama's train step by ~5% (PERF.md)
    "silu": lambda x: x * torch.sigmoid(x),
    "gelu": _gelu,
    "relu2": lambda x: torch.square(F.relu(x)),
}


def _softplus(x):
    """``jax.nn.softplus``: ``logaddexp(x, 0)`` everywhere (F.softplus
    returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))

# ----------------------------------------------------------------------
# RoPE (full / partial / 2d / M-RoPE)
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


def _mrope_angles(positions, rot_dim, theta):
    """M-RoPE: positions (B, S, 3), the (t, h, w) components, each
    rotating its own section of the rot_dim/2 pairs: ``[half - 2 *
    (half // 3), half // 3, half // 3]`` (22 / 21 / 21 at head_dim 128,
    the reference's split, not Qwen2-VL's published 16 / 24 / 24). The
    angles of all three components come from one ``_rope_angles`` call
    and each pair takes its component's: the reference's three calls
    and concatenation, in fewer kernels."""
    half = rot_dim // 2
    b1, b2 = half - 2 * (half // 3), half - half // 3
    cos, sin = _rope_angles(positions, rot_dim, theta)   # (B, S, 3, half)
    j = torch.arange(half, device=positions.device)
    comp = ((j >= b1).long() + (j >= b2).long()).expand(
        *cos.shape[:-2], 1, half)
    return cos.gather(-2, comp)[..., 0, :], sin.gather(-2, comp)[..., 0, :]


def apply_rope(x, positions, cfg: ModelConfig):
    """x (B,S,H,D); positions (B,S), or (B,S,3) under ``"mrope"`` (a (B,
    S) one then stands for all three components). ``"2d"`` rotates the
    first half of the head dims, ``"partial"`` its ``rope_frac``."""
    D = x.shape[-1]
    if cfg.rope_style == "none":
        return x
    rot = int(D * (0.5 if cfg.rope_style == "2d" else cfg.rope_frac))
    rot -= rot % 2
    xr, xp = x[..., :rot], x[..., rot:]
    if cfg.rope_style == "mrope":
        if positions.ndim == 2:
            positions = positions[..., None].expand(*positions.shape, 3)
        cos, sin = _mrope_angles(positions, rot, cfg.rope_theta)
    else:
        cos, sin = _rope_angles(positions, rot, cfg.rope_theta)
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
                    state=None, local: bool = False, cross_kv=None):
    """GQA attention; returns (y, new_state). local=True uses
    cfg.rglru.local_window (hybrid) or cfg.sliding_window. positions:
    (B, S), or (B, S, 3) under M-RoPE, whose first component (``pos1d``)
    places the tokens for the masks and the cache.

    ``mode="full"``: flash attention over the whole sequence; with a
    ``state`` (prefill), the sequence's last T keys and values are also
    written into it. ``mode="step"`` (S == 1, decode): the token's key
    and value are written at ``pos % T`` and it attends densely over the
    whole cache, to the slots holding positions ``<= pos`` (and ``> pos
    - window`` when windowed). Either writes the cache in place, into
    the tensors of ``state``, and returns that same dict: a caller who
    kept an older ``state`` sees it change.

    ``cross_kv=(k, v, kv_pos)``: cross-attention (whisper's decoder) over
    given keys and values: no RoPE on them, no cache written, dense
    attention with no mask in both modes; ``state`` comes back as
    given."""
    B, S, _ = x.shape
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    window = None
    if local:
        window = cfg.rglru.local_window if cfg.rglru else cfg.sliding_window
    scale = Dh ** -0.5
    if mode not in ("full", "step"):
        raise ValueError(f"attention_apply: mode {mode!r}, not 'full' or "
                         f"'step'")
    q = dense(p["wq"], x).reshape(B, S, H, Dh)
    if cross_kv is not None:
        k, v, _ = cross_kv
        out = _attend_dense(q, k, v, None, scale, cfg.logit_softcap)
        return dense(p["wo"], out.reshape(B, S, H * Dh)), state
    k = dense(p["wk"], x).reshape(B, S, KV, Dh)
    v = dense(p["wv"], x).reshape(B, S, KV, Dh)
    q = apply_rope(q, positions, cfg)
    k = apply_rope(k, positions, cfg)
    pos1d = positions[..., 0] if positions.ndim == 3 else positions
    if mode == "full":
        out = flash_attention(q, k, v, q_pos=pos1d, kv_pos=pos1d,
                              causal=True, window=window, scale=scale,
                              softcap=cfg.logit_softcap)
        if state is not None:
            state = _slots_fill(state, {"k": k, "v": v}, pos1d)
    else:
        state = _slots_append(state, {"k": k, "v": v}, pos1d)
        cpos = state["pos_abs"]
        mask = (cpos <= pos1d) & (cpos >= 0)
        if window is not None:
            mask &= cpos > pos1d - window
        out = _attend_dense(q, state["k"], state["v"], mask[:, None, None, :],
                            scale, cfg.logit_softcap)
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


def _slots_write(state, bidx, slot, vals: dict, pos):
    for name, t in vals.items():
        state[name].index_put_((bidx, slot), t.to(state[name].dtype))
    state["pos_abs"].index_put_((bidx, slot), pos.to(torch.int32))
    return state


def _slots_append(state, vals: dict, pos):
    """Write one token (S == 1) of each tensor of ``vals`` (B, 1, ...)
    into ``state``'s tensor of that name, and pos (B, 1) into
    ``pos_abs``, at slot ``pos % T``: a ring buffer when windowed."""
    T = state["pos_abs"].shape[1]
    bidx = torch.arange(pos.shape[0], device=pos.device)
    return _slots_write(state, bidx, (pos[:, 0] % T).long(),
                        {n: t[:, 0] for n, t in vals.items()}, pos[:, 0])


def _slots_fill(state, vals: dict, pos):
    """Bulk prefill: write the last T positions of each tensor of
    ``vals`` (B, S, ...), each at ``pos % T``. Where positions share a
    slot the last of them wins, as in the reference (jax's scatter keeps
    the last update; a VLM prompt's patches all sit at position 0).
    ``index_put_`` with repeated indices leaves the winner undefined on
    CUDA, so every write to a slot first takes the last writer's values:
    each slot then receives one value, whatever the order. No sort and
    no host round trip: a ``scatter_reduce`` (amax, order-free) of the
    row index into a (B, T) table and one gather a tensor."""
    B, T = state["pos_abs"].shape
    pos = pos[:, -T:]
    slot = (pos % T).long()
    j = torch.arange(slot.shape[1], dtype=torch.int32,
                     device=slot.device).expand_as(slot)
    last = torch.full((B, T), -1, dtype=torch.int32, device=slot.device)
    last.scatter_reduce_(1, slot, j, reduce="amax")
    src = last.gather(1, slot).long()               # (B, S'): its writer

    def writer(t):
        t = t[:, -T:]
        return t.gather(1, src.view(*src.shape, *(1,) * (t.ndim - 2))
                        .expand_as(t))
    vals = {n: writer(t) for n, t in vals.items()}
    bidx = torch.arange(B, device=slot.device)[:, None]
    return _slots_write(state, bidx, slot, vals, pos.gather(1, src))


# ----------------------------------------------------------------------
# MLA (deepseek-v3): latent-compressed keys and values
# ----------------------------------------------------------------------


def init_mla(gen, cfg: ModelConfig, dtype=torch.bfloat16, lead=()):
    m = cfg.mla
    d, H = cfg.d_model, cfg.num_heads
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    dev = _device(gen)
    return {
        "w_dq": dense_init(gen, d, m.q_lora_rank, dtype=dtype, lead=lead),
        "q_norm": norm_init(m.q_lora_rank, lead=lead, device=dev),
        "w_uq": dense_init(gen, m.q_lora_rank, H * qk_dim, dtype=dtype,
                           lead=lead),
        "w_dkv": dense_init(gen, d, m.kv_lora_rank, dtype=dtype, lead=lead),
        "kv_norm": norm_init(m.kv_lora_rank, lead=lead, device=dev),
        "w_kr": dense_init(gen, d, m.qk_rope_dim, dtype=dtype, lead=lead),
        "w_uk": dense_init(gen, m.kv_lora_rank, H * m.qk_nope_dim,
                           dtype=dtype, lead=lead),
        "w_uv": dense_init(gen, m.kv_lora_rank, H * m.v_head_dim,
                           dtype=dtype, lead=lead),
        "wo": dense_init(gen, H * m.v_head_dim, d, dtype=dtype, lead=lead),
    }


def _mla_rope(x, positions, cfg):
    """Full RoPE over all of x's (rope) dimensions, whatever cfg's style."""
    return apply_rope(x, positions, dataclasses.replace(
        cfg, rope_style="full", rope_frac=1.0))


def mla_apply(p, cfg: ModelConfig, x, positions, *, mode, state):
    """Multi-head latent attention; returns (y, state). The queries come
    through a rank-``q_lora_rank`` bottleneck; keys and values through
    the normed latent ``c`` (rank ``kv_lora_rank``) and one shared RoPE
    key ``kr`` (``qk_rope_dim``), which is all the cache holds.

    ``mode="full"`` rebuilds each head's keys (``qk_nope_dim`` from ``c``
    and ``kr``) and values (``v_head_dim``) for the whole sequence and
    runs flash attention; with a ``state`` (prefill) it writes ``c``,
    ``kr`` and the positions into the cache's slots ``pos % T``.
    ``mode="step"`` (decode) writes the token in place at ``pos % T`` and
    attends in the latent space (the absorbed form: ``w_uk`` folded into
    the query, ``w_uv`` applied after the weighted sum), in f32, over the
    slots holding positions ``<= pos``, without rebuilding per-head keys
    or values."""
    m = cfg.mla
    B, S, _ = x.shape
    H, nope, rope = cfg.num_heads, m.qk_nope_dim, m.qk_rope_dim
    pos1d = positions[..., 0] if positions.ndim == 3 else positions
    q = dense(p["w_uq"], apply_norm(p["q_norm"], dense(p["w_dq"], x)))
    q = q.reshape(B, S, H, nope + rope)
    q_nope = q[..., :nope]
    q_rope = _mla_rope(q[..., nope:], pos1d, cfg)
    c = apply_norm(p["kv_norm"], dense(p["w_dkv"], x))          # (B,S,r)
    k_rope = _mla_rope(dense(p["w_kr"], x)[:, :, None, :], pos1d,
                       cfg)[:, :, 0]                             # (B,S,e)
    scale = (nope + rope) ** -0.5
    if mode == "full":
        if state is not None:
            state = _slots_fill(state, {"c": c, "kr": k_rope}, pos1d)
        k_nope = dense(p["w_uk"], c).reshape(B, S, H, nope)
        val = dense(p["w_uv"], c).reshape(B, S, H, m.v_head_dim)
        k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, rope)],
                      -1)
        out = flash_attention(torch.cat([q_nope, q_rope], -1), k, val,
                              q_pos=pos1d, kv_pos=pos1d, causal=True,
                              window=None, scale=scale)
    elif mode == "step":
        state = _slots_append(state, {"c": c, "kr": k_rope}, pos1d)
        r = m.kv_lora_rank
        w_uk = p["w_uk"]["w"].reshape(r, H, nope).float()
        w_uv = p["w_uv"]["w"].reshape(r, H, m.v_head_dim).float()
        q_lat = torch.einsum("bshn,rhn->bshr", q_nope.float(), w_uk)
        cf = state["c"].float()
        logits = (torch.einsum("bshr,btr->bhst", q_lat, cf)
                  + torch.einsum("bshe,bte->bhst", q_rope.float(),
                                 state["kr"].float())) * scale
        kv_pos = state["pos_abs"]
        mask = ((kv_pos <= pos1d) & (kv_pos >= 0))[:, None, None, :]
        logits = torch.where(mask, logits, torch.full_like(logits, -1e30))
        attn = torch.softmax(logits, dim=-1)                     # (B,H,1,T)
        out_lat = torch.einsum("bhst,btr->bshr", attn, cf)
        out = torch.einsum("bshr,rhv->bshv", out_lat, w_uv).to(x.dtype)
    else:
        raise ValueError(f"mla_apply: mode {mode!r}, not 'full' or 'step'")
    return dense(p["wo"], out.reshape(B, S, H * m.v_head_dim)), state


def init_mla_cache(cfg: ModelConfig, B, max_len, dtype=torch.bfloat16,
                   device=None):
    """One MLA layer's decode cache: the latent ``c`` (B, T, kv_lora_rank)
    and RoPE key ``kr`` (B, T, qk_rope_dim) zeros, and ``pos_abs`` (B, T)
    int32, -1 marking an empty slot; T = max_len."""
    m = cfg.mla
    return {
        "c": torch.zeros((B, max_len, m.kv_lora_rank), dtype=dtype,
                         device=device),
        "kr": torch.zeros((B, max_len, m.qk_rope_dim), dtype=dtype,
                          device=device),
        "pos_abs": torch.full((B, max_len), -1, dtype=torch.int32,
                              device=device),
    }

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


def mlp_apply(p, cfg: ModelConfig, x, act=None):
    """The (gated) MLP; ``act`` replaces the config's activation."""
    act = act or _ACTS[cfg.mlp_act]
    h = act(dense(p["w_up"], x)) if "w_gate" not in p else (
        act(dense(p["w_gate"], x)) * dense(p["w_up"], x))
    return dense(p["w_down"], h)

# ----------------------------------------------------------------------
# mixture of experts
# ----------------------------------------------------------------------


def init_moe(gen, cfg: ModelConfig, dtype=torch.bfloat16, lead=()):
    """The router (f32), the experts' stacked (E, ...) gated-MLP weights
    and, with ``num_shared``, one shared MLP of ``num_shared * d_expert``."""
    mo = cfg.moe
    d, dff, E = cfg.d_model, mo.d_expert, mo.num_experts
    p = {
        "router": dense_init(gen, d, E, dtype=torch.float32, lead=lead),
        "w_up": _normal(gen, (E, d, dff), 1.0 / math.sqrt(d), dtype, lead),
        "w_gate": _normal(gen, (E, d, dff), 1.0 / math.sqrt(d), dtype, lead),
        "w_down": _normal(gen, (E, dff, d), 1.0 / math.sqrt(dff), dtype,
                          lead),
    }
    if mo.num_shared:
        p["shared"] = init_mlp(gen, cfg, d_ff=mo.num_shared * dff,
                               dtype=dtype, lead=lead)
    return p


def _route(router_p, mo, xt):
    """The router over tokens xt (T, d): (gates (T, K) f32, experts (T, K),
    aux loss). The softmax of an f32 dense, its top K (``lax.top_k``'s:
    ties to the lower index, which a stable descending sort gives and
    ``torch.topk`` does not promise), renormalised; the Switch-style
    load-balance loss over all top-K assignments."""
    logits = dense(router_p, xt.float())                       # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, experts = gates[:, :mo.top_k], experts[:, :mo.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    density = F.one_hot(experts, mo.num_experts).float().sum(1).mean(0) / (
        mo.top_k)
    aux = mo.num_experts * torch.sum(density * probs.mean(0)) * (
        mo.router_aux_coef)
    return gates, experts, aux


def _dispatch_tables(experts, gates, T, mo, C):
    """The reference's sort-based capacity dispatch: the assignments
    sorted stably by expert, each expert's first C kept, in token order.
    Returns the reference's tables, ``tok_idx`` (E, C) int32 and
    ``gate_val`` (E, C) (an empty slot holds token 0 and gate 0), and
    ``combine`` (T, K) int64: each token's kept slots as flat indices
    into (E * C), in expert order, a dropped assignment as E * C (sorted
    last)."""
    E, K = mo.num_experts, mo.top_k
    dev = experts.device
    flat_e = experts.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    se, order = torch.sort(flat_e, stable=True)
    st, sg = flat_t[order], gates.reshape(-1)[order]
    seg_counts = torch.bincount(se, minlength=E)
    seg_start = torch.cumsum(seg_counts, 0) - seg_counts
    pos_in_seg = torch.arange(T * K, device=dev) - seg_start[se]
    keep = pos_in_seg < C
    slot_e = torch.where(keep, se, E)                          # overflow row
    slot_c = torch.where(keep, pos_in_seg, 0)
    # the kept (e, c) are unique; the dropped all land on (E, 0), cut off
    tok_idx = torch.zeros((E + 1, C), dtype=torch.int32, device=dev)
    tok_idx[slot_e, slot_c] = st.to(torch.int32)
    gate_val = torch.zeros((E + 1, C), dtype=gates.dtype, device=dev)
    gate_val[slot_e, slot_c] = torch.where(keep, sg, torch.zeros_like(sg))
    flat_slot = torch.where(keep, se * C + pos_in_seg, E * C)
    combine = torch.empty_like(flat_slot)
    combine[order] = flat_slot
    combine = combine.view(T, K).sort(dim=-1).values
    return tok_idx[:E], gate_val[:E], combine


# the experts' activations: silu as jax.nn.silu computes it in bf16, its
# sigmoid op by op (``_sigmoid``), so that a bf16 MoE block gives the
# reference's bits where its products do (with torch.sigmoid, rounded
# once, 275 of 1,000 normal bf16 inputs give another silu; the dense
# MLPs keep it, see ``_ACTS``). Its cost on the MoE archs' prefill and
# decode is within 2% on an H100 (bench/moe_silu.py, PERF.md)
_MOE_ACTS = {**_ACTS, "silu": lambda x: x * _sigmoid(x)}


def _expert_ffn(cfg, xe, wg, wu, wd):
    """The experts' gated MLPs, batched: xe (E, C, d) -> (E, C, d)."""
    act = _MOE_ACTS[cfg.mlp_act]
    return (act(xe @ wg) * (xe @ wu)) @ wd


def _capacity(mo, T, no_drop):
    if no_drop:
        return T * mo.top_k
    return max(1, int(mo.capacity_factor * mo.top_k * T / mo.num_experts))


def _combine(ye, combine):
    """Each token's sum of its kept slots' rows of ye (E * C, d) in expert
    order, every partial sum rounded to ye's dtype: the order in which
    the reference's scatter-add (flat (E, C) order) sums them, in a fixed
    order on every device (an atomic ``index_add_`` has none, and a bf16
    sum of deepseek's eight would change from run to run)."""
    n = ye.shape[0]
    y = torch.zeros((combine.shape[0], ye.shape[1]), dtype=ye.dtype,
                    device=ye.device)
    for j in range(combine.shape[1]):
        idx = combine[:, j]
        kept = (idx < n)[:, None]
        y = y + torch.where(kept, ye[idx.clamp(max=n - 1)],
                            torch.zeros((), dtype=ye.dtype, device=ye.device))
    return y


def moe_apply(p, cfg: ModelConfig, x, *, no_drop: bool = False):
    """The mixture-of-experts channel block; returns (y, aux_loss). The
    reference's single-device path: global routing, sort-based capacity
    dispatch (tokens over an expert's capacity dropped), every expert
    computing its whole (C, d) slab, the gated rows summed back per
    token, and the shared expert added. ``no_drop=True`` (a decode step)
    sizes the capacity at T * top_k, so that routing is exact."""
    mo = cfg.moe
    B, S, d = x.shape
    T = B * S
    xt = x.reshape(T, d)
    gates, experts, aux = _route(p["router"], mo, xt)
    C = _capacity(mo, T, no_drop)
    tok_idx, gate_val, combine = _dispatch_tables(experts, gates, T, mo, C)
    ye = _expert_ffn(cfg, xt[tok_idx.long()], p["w_gate"], p["w_up"],
                     p["w_down"])
    ye = ye * gate_val[..., None].to(ye.dtype)
    y = _combine(ye.reshape(-1, d), combine)
    if "shared" in p:
        y = y + mlp_apply(p["shared"], cfg, xt, _MOE_ACTS[cfg.mlp_act])
    return y.reshape(B, S, d), aux

# ----------------------------------------------------------------------
# causal depthwise conv1d (griffin / mamba2 frontends)
# ----------------------------------------------------------------------


def init_conv1d(gen, width, d, dtype=torch.bfloat16, lead=()):
    return {"w": _normal(gen, (width, d), 1.0 / math.sqrt(width), dtype,
                         lead),
            "b": torch.zeros((*lead, d), dtype=dtype, device=_device(gen))}


def conv1d_apply(p, x, *, mode, state):
    """x (B,S,d); ``state`` (B,width-1,d) holds the trailing context, or
    None. ``mode="full"`` pads width-1 zeros in front and writes the last
    width-1 rows of the padded input into ``state``; ``mode="step"``
    (S == 1) convolves the state and the token and shifts the token into
    the state. The state is written in place (in its own dtype) and
    returned."""
    width = p["w"].shape[0]
    if mode == "full":
        xp = F.pad(x, (0, 0, width - 1, 0))
        y = sum(xp[:, i: i + x.shape[1]] * p["w"][i] for i in range(width))
        if state is not None:
            state.copy_(xp[:, -(width - 1):])
        return y + p["b"], state
    ctx = torch.cat([state.to(x.dtype), x], 1)                 # (B,width,d)
    y = torch.einsum("bwd,wd->bd", ctx, p["w"])[:, None] + p["b"]
    state.copy_(ctx[:, 1:])
    return y, state

# ----------------------------------------------------------------------
# RG-LRU recurrent block (recurrentgemma / griffin)
# ----------------------------------------------------------------------


def init_rglru(gen, cfg: ModelConfig, dtype=torch.bfloat16, lead=()):
    width = cfg.rglru.lru_width or cfg.d_model
    d = cfg.d_model
    return {
        "w_x": dense_init(gen, d, width, dtype=dtype, lead=lead),
        "w_gate_branch": dense_init(gen, d, width, dtype=dtype, lead=lead),
        "conv": init_conv1d(gen, cfg.rglru.d_conv, width, dtype=dtype,
                            lead=lead),
        "w_rec_gate": dense_init(gen, width, width, dtype=dtype, lead=lead),
        "w_in_gate": dense_init(gen, width, width, dtype=dtype, lead=lead),
        # lam s.t. a = exp(-c*softplus(lam)) lands in ~(0.9, 0.999) at r=1
        "lam": torch.log(torch.expm1(_uniform(gen, (*lead, width), 0.0001,
                                              0.013))),
        "w_out": dense_init(gen, width, d, dtype=dtype, lead=lead),
    }


_RGLRU_C = 8.0


def _rglru_scan(x, r, i, lam):
    """x,r,i (B,S,W) f32. The scan over time of
    h_t = a_t h_{t-1} + sqrt(1-a_t^2) (i_t * x_t), a_t = a^(c r_t), in
    ceil(log2 S) doubling passes (Hillis-Steele): pass o adds a_t h_{t-o}
    to h_t and multiplies a_t by a_{t-o}, each from the previous pass.
    The reference's ``lax.associative_scan`` computes the same
    recurrence in another rounding order."""
    log_a = -_RGLRU_C * r * _softplus(lam)                    # log a_t
    a = torch.exp(log_a)
    h = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6)) * (
        i * x)
    o = 1
    while o < x.shape[1]:
        h = torch.cat([h[:, :o], h[:, o:] + a[:, o:] * h[:, :-o]], 1)
        a = torch.cat([a[:, :o], a[:, o:] * a[:, :-o]], 1)
        o *= 2
    return h


def rglru_apply(p, cfg: ModelConfig, x, positions, *, mode, state):
    """Griffin recurrent block: gate branch (gelu) * recurrent branch
    (conv1d -> RG-LRU), then out-projection. ``state`` ({h (B,W) f32,
    conv (B,d_conv-1,W)}) is written in place and returned."""
    gate = _ACTS["gelu"](dense(p["w_gate_branch"], x))
    u = dense(p["w_x"], x)
    u, _ = conv1d_apply(p["conv"], u, mode=mode,
                        state=None if state is None else state["conv"])
    uf = u.float()
    r = _sigmoid(dense(p["w_rec_gate"], u).float())
    i = _sigmoid(dense(p["w_in_gate"], u).float())
    lam = p["lam"]
    if mode == "full":
        h = _rglru_scan(uf, r, i, lam)
        if state is not None:
            state["h"].copy_(h[:, -1])
    else:
        log_a = -_RGLRU_C * r[:, 0] * _softplus(lam)
        a = torch.exp(log_a)
        g = torch.sqrt(torch.clamp(1 - torch.exp(2 * log_a), min=1e-6)) * (
            i[:, 0] * uf[:, 0])
        h = state["h"].mul_(a).add_(g)[:, None]
    y = dense(p["w_out"], h.to(x.dtype) * gate)
    return y, state


def init_rglru_state(cfg: ModelConfig, B, dtype=torch.bfloat16,
                     device=None):
    width = cfg.rglru.lru_width or cfg.d_model
    return {"h": torch.zeros((B, width), dtype=torch.float32, device=device),
            "conv": torch.zeros((B, cfg.rglru.d_conv - 1, width),
                                dtype=dtype, device=device)}

# ----------------------------------------------------------------------
# Mamba-2 SSD block (state-space duality, chunked)
# ----------------------------------------------------------------------


def init_ssd(gen, cfg: ModelConfig, dtype=torch.bfloat16, lead=()):
    s = cfg.ssm
    d = cfg.d_model
    din = s.d_inner(d)
    nh = s.n_heads(d)
    conv_dim = din + 2 * s.n_groups * s.d_state
    return {
        # in_proj -> [z (din), x (din), B (G*N), C (G*N), dt (nh)]
        "w_in": dense_init(gen, d, 2 * din + 2 * s.n_groups * s.d_state + nh,
                           dtype=dtype, lead=lead),
        "conv": init_conv1d(gen, s.d_conv, conv_dim, dtype=dtype, lead=lead),
        "A_log": torch.log(_uniform(gen, (*lead, nh), 1.0, 16.0)),
        "D": torch.ones((*lead, nh), dtype=torch.float32,
                        device=_device(gen)),
        "dt_bias": torch.log(torch.expm1(_uniform(gen, (*lead, nh), 1e-3,
                                                  1e-1))),
        "out_norm": norm_init(din, lead=lead, device=_device(gen)),
        "w_out": dense_init(gen, din, d, dtype=dtype, lead=lead),
    }


def _ssd_chunked(x, dt, A, Bm, Cm, chunk):
    """Minimal SSD (mamba2 §6): x (B,S,H,P); dt (B,S,H); A (H,);
    Bm/Cm (B,S,G,N). Returns y (B,S,H,P), final_state (B,H,P,N).

    The reference's 4-operand einsums run here as pairwise products in
    the order of its equations, so that no (b,nc,c,c,H,P) tensor is
    made; the scan over chunks is a loop over them."""
    b, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    if S % chunk:
        raise ValueError(f"_ssd_chunked: S={S} is not a multiple of "
                         f"chunk={chunk}")
    nc = S // chunk
    rep = H // G
    x_ = x.reshape(b, nc, chunk, H, P)
    dt_ = dt.reshape(b, nc, chunk, H)
    B_ = Bm.reshape(b, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    C_ = Cm.reshape(b, nc, chunk, G, N).repeat_interleave(rep, dim=3)
    dA = dt_ * (-torch.exp(A))                                # (b,nc,c,H) <=0
    dA_cum = torch.cumsum(dA, dim=2)
    # intra-chunk (quadratic within chunk). Mask BEFORE exp: the
    # upper-triangle segments are positive and exp() of them overflows,
    # which poisons gradients (inf * 0 = NaN in the backward pass).
    seg = dA_cum[:, :, :, None, :] - dA_cum[:, :, None, :, :]  # (b,nc,c,c,H)
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=x.device))
    Lm = torch.exp(torch.where(causal[:, :, None], seg,
                               torch.full_like(seg, -math.inf)))
    scores = torch.einsum("bzchn,bzshn->bzcsh", C_, B_)       # (b,nc,c,c,H)
    w = scores * Lm * dt_[:, :, None]                          # (b,nc,c,s,H)
    y_diag = torch.einsum("bzcsh,bzshp->bzchp", w, x_)
    # chunk end-states
    decay_to_end = torch.exp(dA_cum[:, :, -1:] - dA_cum)      # (b,nc,c,H)
    states = torch.einsum("bzchn,bzchp->bzhpn",
                          (decay_to_end * dt_)[..., None] * B_, x_)
    # inter-chunk recurrence over nc
    chunk_decay = torch.exp(dA_cum[:, :, -1])                  # (b,nc,H)
    h = torch.zeros((b, H, P, N), dtype=x.dtype, device=x.device)
    h_prev = []
    for z in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, z, :, None, None] + states[:, z]
    h_prev = torch.stack(h_prev, 1)                            # (b,nc,H,P,N)
    decay_in = torch.exp(dA_cum)                               # (b,nc,c,H)
    y_off = torch.einsum("bzchn,bzhpn->bzchp", C_, h_prev) * decay_in[
        ..., None]
    y = (y_diag + y_off).reshape(b, S, H, P)
    return y, h


def ssd_apply(p, cfg: ModelConfig, x, positions, *, mode, state):
    """Mamba-2 block: in-projection, conv1d and silu over (x, B, C), the
    chunked SSD over the sequence (``mode="full"``) or one recurrent step
    (``"step"``), the D skip, a gated RMSNorm and the out-projection.
    ``state`` ({h (B,nh,P,N) f32, conv (B,d_conv-1,conv_dim)}) is written
    in place and returned."""
    s = cfg.ssm
    B, S, d = x.shape
    din = s.d_inner(d)
    nh = s.n_heads(d)
    G, N, P = s.n_groups, s.d_state, s.head_dim

    def silu(v):
        # the sigmoid op by op, as jax's: with torch.sigmoid, mamba2's
        # bf16 logits miss the reference's at 4.4-6.1x the elements its
        # own op-by-op run does (the count rule allows 2x)
        return v * _sigmoid(v)
    zxbcdt = dense(p["w_in"], x)
    z, xbc, dt = torch.split(zxbcdt, [din, din + 2 * G * N, nh], dim=-1)
    xbc, _ = conv1d_apply(p["conv"], xbc, mode=mode,
                          state=None if state is None else state["conv"])
    xbc = silu(xbc)
    xs, Bm, Cm = torch.split(xbc, [din, G * N, G * N], dim=-1)
    xs = xs.reshape(B, S, nh, P)
    Bm = Bm.reshape(B, S, G, N)
    Cm = Cm.reshape(B, S, G, N)
    dt = _softplus(dt.float() + p["dt_bias"])                  # (B,S,nh)
    A = p["A_log"]
    if mode == "full":
        # the padded steps have dt = 0 (padded after the softplus): they
        # leave the final state unchanged
        pad = (-S) % s.chunk
        y, hT = _ssd_chunked(
            F.pad(xs.float(), (0, 0, 0, 0, 0, pad)),
            F.pad(dt, (0, 0, 0, pad)), A,
            F.pad(Bm.float(), (0, 0, 0, 0, 0, pad)),
            F.pad(Cm.float(), (0, 0, 0, 0, 0, pad)), s.chunk)
        y = y[:, :S]
        if state is not None:
            state["h"].copy_(hT)
    else:
        # recurrent step: h = exp(dt A) h + dt B x ; y = C h
        dA = torch.exp(dt[:, 0] * (-torch.exp(A)))             # (B,nh)
        B_rep = Bm[:, 0].repeat_interleave(nh // G, dim=1)     # (B,nh,N)
        C_rep = Cm[:, 0].repeat_interleave(nh // G, dim=1)
        Bx = (B_rep.float()[:, :, None, :] * xs[:, 0].float()[..., None]
              * dt[:, 0, :, None, None])                       # (B,nh,P,N)
        h = state["h"].mul_(dA[..., None, None]).add_(Bx)
        y = torch.einsum("bhpn,bhn->bhp", h, C_rep.float())[:, None]
    y = y + xs.float() * p["D"][None, None, :, None]
    y = y.reshape(B, S, din).to(x.dtype)
    y = apply_norm(p["out_norm"], y * silu(z))
    return dense(p["w_out"], y), state


def init_ssd_state(cfg: ModelConfig, B, dtype=torch.bfloat16, device=None):
    s = cfg.ssm
    d = cfg.d_model
    nh = s.n_heads(d)
    conv_dim = s.d_inner(d) + 2 * s.n_groups * s.d_state
    return {"h": torch.zeros((B, nh, s.head_dim, s.d_state),
                             dtype=torch.float32, device=device),
            "conv": torch.zeros((B, s.d_conv - 1, conv_dim), dtype=dtype,
                                device=device)}
