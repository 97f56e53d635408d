"""tinyllama-1.1b [dense] — llama2-arch small. [arXiv:2401.02385]
22L d_model=2048 32H (GQA kv=4) d_ff=5632 vocab=32000."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="tinyllama-1.1b",
    family="dense",
    source="arXiv:2401.02385",
    num_layers=22,
    d_model=2048,
    num_heads=32,
    num_kv_heads=4,
    head_dim=64,
    d_ff=5632,
    vocab_size=32_000,
    rope_style="full",
    rope_theta=10_000.0,
    mlp_act="silu",
    mlp_gated=True,
    long_context="swa",
)
