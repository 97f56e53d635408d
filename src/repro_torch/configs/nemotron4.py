"""nemotron-4-15b [dense] — GQA, squared-ReLU MLP (non-gated), partial rope.
[arXiv:2402.16819] 32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-15b",
    family="dense",
    source="arXiv:2402.16819",
    num_layers=32,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=256_000,
    rope_style="partial",
    rope_frac=0.5,
    mlp_act="relu2",
    mlp_gated=False,
    norm="layernorm",
    long_context="swa",
)
