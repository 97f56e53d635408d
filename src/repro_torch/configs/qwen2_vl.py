"""qwen2-vl-72b [vlm] — M-RoPE, dynamic resolution (vision tower stubbed).
[arXiv:2409.12191] 80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    source="arXiv:2409.12191",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152_064,
    rope_style="mrope",
    rope_theta=1_000_000.0,
    attn_bias=True,           # qwen2 qkv bias
    mlp_act="silu",
    mlp_gated=True,
    num_patch_tokens=1024,    # stub vision frontend token budget
    long_context="swa",
)
