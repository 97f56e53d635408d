"""Config schema of the architectures: the port of ``repro.configs.base``.

Plain frozen dataclasses, copied field for field from the reference so
that a config means the same model in both packages, and the four input
shapes of the dry-run (``SHAPES``) with ``input_specs``, their inputs as
meta-device tensors (shapes and dtypes, nothing allocated).
"""
from __future__ import annotations

from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int                 # per-expert FFN width
    num_shared: int = 0           # shared (always-on) experts
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01
    first_k_dense: int = 0        # leading dense layers (deepseek-v3: 3)
    router_dtype: str = "float32"


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class EncDecConfig:
    """Encoder stack for enc-dec models (whisper)."""
    num_layers: int = 4
    source_len: int = 1500        # whisper 30s @ 2x conv downsample


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64            # mamba2 P
    chunk: int = 128              # SSD chunk length
    n_groups: int = 1

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int | None = None  # defaults to d_model
    d_conv: int = 4
    local_window: int = 2048      # window of the interleaved local-attn


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | vlm | audio | ssm | hybrid
    source: str                    # citation for the numbers
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 128
    # block pattern, cycled over layers: "attn" | "attn_local" | "rglru" | "ssd"
    block_pattern: tuple = ("attn",)
    # attention flavour
    rope_style: str = "full"       # full | partial | 2d | mrope | none
    rope_frac: float = 1.0         # fraction of head_dim that rotates
    rope_theta: float = 10000.0
    attn_bias: bool = False
    sliding_window: int | None = None   # set -> SWA for long-context decode
    # mlp
    mlp_act: str = "silu"          # silu | gelu | relu2
    mlp_gated: bool = True
    mlp_bias: bool = False
    parallel_block: bool = False   # command-r style attn||mlp
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    tie_embeddings: bool = False
    logit_softcap: float | None = None
    # family extensions
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    ssm: SSMConfig | None = None
    rglru: RGLRUConfig | None = None
    encdec: EncDecConfig | None = None
    mtp_depth: int = 0             # deepseek-v3 multi-token prediction heads
    # vlm stub frontend: number of prepended patch-embedding positions
    num_patch_tokens: int = 0
    dtype: str = "bfloat16"
    # long-context policy: "native" (sub-quadratic already), "swa" (use
    # sliding_window for long_500k), "skip" (documented skip)
    long_context: str = "swa"

    @property
    def attn_free(self) -> bool:
        return all(b == "ssd" for b in self.block_pattern)

    def reduced(self) -> "ModelConfig":
        """2-layer, narrow variant of the same family for CPU smoke tests."""
        pattern_len = len(self.block_pattern)
        layers = max(2, pattern_len)
        kw = dict(
            num_layers=layers,
            d_model=256,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=64,
            d_ff=512,
            vocab_size=512,
        )
        if self.moe is not None:
            kw["moe"] = replace(self.moe, num_experts=4,
                                top_k=min(self.moe.top_k, 2), d_expert=128,
                                first_k_dense=min(self.moe.first_k_dense, 1))
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=64, kv_lora_rank=32,
                                  qk_nope_dim=32, qk_rope_dim=16, v_head_dim=32)
        if self.ssm is not None:
            kw["ssm"] = replace(self.ssm, d_state=16, head_dim=32, chunk=32)
        if self.rglru is not None:
            kw["rglru"] = RGLRUConfig(lru_width=256, d_conv=4, local_window=64)
        if self.encdec is not None:
            kw["encdec"] = EncDecConfig(num_layers=2, source_len=64)
        if self.sliding_window is not None:
            kw["sliding_window"] = 64
        kw["name"] = self.name + "-reduced"
        return replace(self, **kw)


def padded_vocab(cfg: ModelConfig, multiple: int = 256) -> int:
    """Megatron-style vocab padding so the vocab dim shards over the
    16-way model axis (whisper 51865 -> 51968, mamba2 50280 -> 50432)."""
    v = cfg.vocab_size
    return ((v + multiple - 1) // multiple) * multiple



# ----------------------------------------------------------------------
# The four assigned input shapes.
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                      # train | prefill | decode


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta-device stand-ins for every model input, the reference's
    shapes and dtypes: token ids (and labels for train; one token and
    its position a row for decode, whose cache of length S is the step's
    state); the vlm's stub patch embeddings and their M-RoPE positions
    outside decode; whisper's stub encoder frame embeddings."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32
    specs: dict = {}
    if shape.kind == "train":
        specs["tokens"] = _meta((B, S), i32)
        specs["labels"] = _meta((B, S), i32)
    elif shape.kind == "prefill":
        specs["tokens"] = _meta((B, S), i32)
    else:
        specs["tokens"] = _meta((B, 1), i32)
        specs["positions"] = _meta((B, 1), i32)
    if cfg.family == "vlm" and shape.kind != "decode":
        n_patch = min(cfg.num_patch_tokens or 256, S // 2)
        specs["patch_embeds"] = _meta((B, n_patch, cfg.d_model),
                                      torch.bfloat16)
        specs["patch_positions"] = _meta((B, n_patch, 3), i32)
    if cfg.family == "audio":
        specs["frame_embeds"] = _meta((B, cfg.encdec.source_len,
                                       cfg.d_model), torch.bfloat16)
    return specs
