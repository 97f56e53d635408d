"""The least time the card could take for a piece of work, and the
byte and operation counts behind it.

A bound is the larger of two times: the bytes the work must move (each
input read once, each output written once) over the card's HBM rate,
and its operations over the card's peak rate for their type
(``launch.mesh``: 3.35 TB/s, 67 TFLOP/s in f32, 989 TFLOP/s in bf16).

  * :func:`bound_ms`, :func:`codec_bounds`, :func:`kernel_bounds`: the
    hand-written kernels K1-K4 at a shape (K1 from its run's own index
    stream: the distinct columns it visits).
  * :func:`mixer_products`, :func:`dense_products`: a forward's bf16
    matrix products; :func:`state_bytes`, :func:`step_weight_bytes`: what
    a decode step reads; :func:`lm_predicted_peak`: a training row's
    peak device bytes.

Every bound that ``chip_smoke.py`` prints comes from here.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import padded_vocab
from repro_torch.launch.mesh import HBM_BW, PEAK_OPS_F32
from repro_torch.models.transformer import layer_plan
from repro_torch.utils.trees import tree_bytes


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = PEAK_OPS_F32) -> tuple[float, str]:
    """(bound in ms, "bytes" or "operations": the term that sets it)."""
    t_bytes, t_ops = nbytes / HBM_BW, ops / ops_per_s
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def codec_bounds(K: int, L: int, k: int) -> dict:
    """The bounds of K2 and K3 (each width) on a (K, L) stack and its
    payloads, and of K4 on that stack keeping k."""
    bounds = {}
    for c, per in (("int8", 1), ("int4", 2), ("int2", 4)):
        wire = -(-L // per)
        # quantize reads the f32 stack, writes the payload and scales;
        # decode reads the payload and scales, writes the (L,) f32 sum
        bounds[c] = bound_ms(K * (4 * L + wire + 4), 6 * K * L)
        bounds[f"decode_{c}"] = bound_ms(K * (wire + 4) + 4 * L, 2 * K * L)
    # K4 reads the f32 stack and writes k values, k indices and one
    # threshold per row; one magnitude per element
    bounds["topk"] = bound_ms(K * 4 * L + K * (8 * k + 4), K * L)
    return bounds


def kernel_bounds(idx, n_pad: int, m: int, k: int):
    """Each kernel's bound at one shape: K1 on the (K, H) index stream
    ``idx`` over K blocks of n_pad columns of m rows, K2 and K3 on a
    (K, m) stack and its payloads, K4 on that stack keeping k. Returns
    the bounds by kernel key, the distinct columns and K1's bytes."""
    K, H = idx.shape
    # K1 reads each distinct visited column once (this run's idx), its
    # norm, the index stream, alpha in and out, w, and writes Delta v;
    # a step is a dot and an axpy, 4m operations, plus ~10 scalar ones
    distinct = int(torch.unique(idx.long()
                                + torch.arange(K, device=idx.device)[:, None]
                                * n_pad).numel())
    scd_bytes = 4 * (distinct * (m + 1) + K * H + 2 * K * n_pad + m + K * m)
    bounds = {"scd_solve": bound_ms(scd_bytes, K * H * (4 * m + 10))}
    bounds.update(codec_bounds(K, m, k))
    return bounds, distinct, scd_bytes


def mixer_products(cfg, mixer: str, decode: bool = False) -> list:
    """The (d_in, d_out) of a mixer's bf16 projections. MLA: the query's
    down and up projections, the latent's and the RoPE key's, and, over
    a whole sequence only, the latent's up projections to the heads' keys
    and values (a decode step's absorbed form applies them in f32
    einsums, which are not counted, as the attention's score products
    are not), then the output projection."""
    d = cfg.d_model
    if mixer == "rglru":
        W = cfg.rglru.lru_width or d
        return [(d, W), (d, W), (W, W), (W, W), (W, d)]
    if mixer == "ssd":
        s = cfg.ssm
        din = s.d_inner(d)
        return [(d, 2 * din + 2 * s.n_groups * s.d_state + s.n_heads(d)),
                (din, d)]
    H, KV, Dh = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    if mixer == "mla":
        m = cfg.mla
        up = [] if decode else [(m.kv_lora_rank, H * m.qk_nope_dim),
                                (m.kv_lora_rank, H * m.v_head_dim)]
        return [(d, m.q_lora_rank),
                (m.q_lora_rank, H * (m.qk_nope_dim + m.qk_rope_dim)),
                (d, m.kv_lora_rank), (d, m.qk_rope_dim)] + up + [
                    (H * m.v_head_dim, d)]
    return [(d, H * Dh), (d, KV * Dh), (d, KV * Dh), (H * Dh, d)]


def dense_products(cfg, tokens: int, frames: int = 0,
                   decode: bool = False) -> tuple[float, float]:
    """The bf16 matrix products of a forward over ``tokens`` positions,
    each layer's mixer and channel projections and the unembedding:
    (flops, bytes), each weight, input and output read or written once
    (the attention's score products, MLA's absorbed decode, the MoE
    router and the SSD and RG-LRU scans run in f32 and are not counted).
    An MoE channel: every expert's three weights, and ``tokens * top_k``
    rows through them (every assignment, the dropped ones with them),
    and the shared expert's over ``tokens``. whisper: the decoder's
    self-attention, cross q and o and MLP over ``tokens``, and over
    ``frames`` encoder positions (its prefill; 0 in a decode step, which
    reads the cached cross keys and values) the encoder and each layer's
    cross k and v."""
    def mlp(f):
        return [(d, f), (f, d)] + ([(d, f)] if cfg.mlp_gated else [])
    d = cfg.d_model
    shapes = []                         # (positions, d_in, d_out, copies)
    for mixer, channel in layer_plan(cfg):
        proj = mixer_products(cfg, mixer, decode)
        if cfg.family == "audio":               # self, then cross
            shapes += [(tokens, *ab, 1) for ab in proj + [proj[0], proj[3]]]
            shapes += [(frames, *ab, 1) for ab in proj[1:3]]
        else:
            shapes += [(tokens, *ab, 1) for ab in proj]
        if channel == "mlp":
            shapes += [(tokens, *ab, 1) for ab in mlp(cfg.d_ff)]
        elif channel == "moe":
            mo = cfg.moe
            shapes += [(tokens * mo.top_k, *ab, mo.num_experts)
                       for ab in mlp(mo.d_expert)]
            if mo.num_shared:
                shapes += [(tokens, *ab, 1)
                           for ab in mlp(mo.num_shared * mo.d_expert)]
    if cfg.family == "audio":
        shapes += [(frames, *ab, 1) for _ in range(cfg.encdec.num_layers)
                   for ab in mixer_products(cfg, "attn") + mlp(cfg.d_ff)]
    shapes.append((tokens, d, padded_vocab(cfg), 1))
    shapes = [sh for sh in shapes if sh[0]]
    flops = sum(2 * n * a * b for n, a, b, _ in shapes)
    nbytes = sum(2 * (n * a + c * a * b + n * b) for n, a, b, c in shapes)
    return flops, nbytes


def state_bytes(cfg, B: int, max_len: int) -> tuple[int, int]:
    """The bytes of ``init_states(cfg, B, max_len)`` in bf16, from the
    config alone: (attention caches, ``{h, conv}`` states). A KV cache
    holds T = min(window, max_len) slots of bf16 k and v and int32
    ``pos_abs``; an MLA cache max_len slots of the bf16 latent and RoPE
    key and int32 ``pos_abs``, B T (2 (kv_lora_rank + qk_rope_dim) + 4);
    an RG-LRU or SSD state an f32 ``h`` and a bf16 conv tail of d_conv -
    1 rows; a whisper decoder layer also its cross k and v, B source_len
    KV Dh each in bf16."""
    attn = rec = 0
    for mixer, _ in layer_plan(cfg):
        if mixer == "rglru":
            W = cfg.rglru.lru_width or cfg.d_model
            rec += B * (W * 4 + (cfg.rglru.d_conv - 1) * W * 2)
        elif mixer == "ssd":
            s = cfg.ssm
            conv = s.d_inner(cfg.d_model) + 2 * s.n_groups * s.d_state
            rec += B * (s.n_heads(cfg.d_model) * s.head_dim * s.d_state * 4
                        + (s.d_conv - 1) * conv * 2)
        elif mixer == "mla":
            m = cfg.mla
            attn += B * max_len * (2 * (m.kv_lora_rank + m.qk_rope_dim) + 4)
        else:
            window = cfg.sliding_window
            if mixer == "attn_local" and cfg.rglru:
                window = cfg.rglru.local_window
            T = min(window, max_len) if window else max_len
            attn += B * T * (2 * cfg.num_kv_heads * cfg.head_dim * 2 + 4)
            if cfg.family == "audio":
                attn += (B * cfg.encdec.source_len * cfg.num_kv_heads
                         * cfg.head_dim * 2 * 2)
    return attn, rec


def step_weight_bytes(cfg, params) -> int:
    """The weight bytes a decode step reads: every one but the embedding
    table's (a step gathers B rows of it), which it reads whole where it
    is also the unembedding, and the MTP head's (which serving does not
    run); an MoE layer's every expert (the dispatch without drops hands
    each expert a slab of T top_k rows); for whisper only the decoder's,
    less each layer's cross k and v projections (their outputs are
    cached), with the tied embedding whole (``dec_pos``: B rows)."""
    if cfg.family == "audio":
        return (tree_bytes(params["dec_layers"])
                + tree_bytes(params["dec_norm"]) + tree_bytes(params["embed"])
                - sum(tree_bytes(lp["cross"][k]) for lp in params["dec_layers"]
                      for k in ("wk", "wv")))
    return (tree_bytes(params) - tree_bytes(params.get("mtp", {}))
            - (0 if cfg.tie_embeddings else tree_bytes(params["embed"])))


def lm_predicted_peak(cfg, n_params: int, largest: int, codec: str, *,
                      K: int, batch: int, seq: int) -> int:
    """A training row's predicted peak device bytes while the last of K
    virtual shards steps on ``batch`` x ``seq`` tokens: p0 and the K
    shards' bf16 copies (2 + 2K B a param), the start, running and next
    f32 AdamW states and the f32 opt sum (32 B), the bf16 grads (2 B),
    under an ``ef:`` codec the (K, L) f32 residuals (4K B); AdamW's f32
    temporaries on the largest leaf (28 B an element: the grad, its
    square, the moments, the step's quotients, the param in f32); the
    f32 logits and their gradient (16 B a logit, twice with an MTP
    head); 1.5 GB of activations under per-layer remat."""
    per = 2 + 2 * K + 32 + 2 + (4 * K if codec.startswith("ef:") else 0)
    logits = (batch * seq * padded_vocab(cfg) * 16
              * (2 if cfg.mtp_depth else 1))
    return n_params * per + 28 * largest + logits + int(1.5e9)
