"""chatglm3-6b [dense] — RoPE 2d (half-dim rotary), GQA kv=2.
[arXiv:2406.12793] 28L d_model=4096 32H (GQA kv=2) d_ff=13696 vocab=65024."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    source="arXiv:2406.12793",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    head_dim=128,
    d_ff=13696,
    vocab_size=65_024,
    rope_style="2d",          # rotary over half the head dims
    attn_bias=True,           # chatglm qkv bias
    mlp_act="silu",
    mlp_gated=True,
    long_context="swa",
)
