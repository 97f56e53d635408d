"""llama4-maverick-400b-a17b [moe] — MoE, early fusion.
[hf:meta-llama/Llama-4-Scout-17B-16E family; Maverick: 128 experts top-1]
48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e top-1
(+1 shared expert, llama4-style)."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    source="hf:meta-llama/Llama-4-Scout-17B-16E",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    rope_style="full",
    rope_theta=500_000.0,
    mlp_act="silu",
    mlp_gated=True,
    moe=MoEConfig(num_experts=128, top_k=1, d_expert=8192, num_shared=1),
    long_context="swa",
    sliding_window=None,   # enabled only for the long_500k variant
)
