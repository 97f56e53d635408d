"""command-r-35b [dense] — GQA, no-bias, parallel attn||mlp block, tied
embeddings. [hf:CohereForAI/c4ai-command-r-v01]
40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    source="hf:CohereForAI/c4ai-command-r-v01",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22528,
    vocab_size=256_000,
    rope_style="full",
    rope_theta=8_000_000.0,
    mlp_act="silu",
    mlp_gated=True,
    parallel_block=True,
    norm="layernorm",
    tie_embeddings=True,
    long_context="swa",
)
