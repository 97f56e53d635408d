"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP.
[arXiv:2412.19437] 61L d_model=7168 128H d_ff(expert)=2048 vocab=129280.
The config's "GQA kv=128" reflects MLA's 128 query heads; KV is
latent-compressed (kv_lora_rank=512) — implemented as true MLA."""
from repro_torch.configs.base import ModelConfig, MoEConfig, MLAConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    source="arXiv:2412.19437",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,          # nominal; MLA latent cache is what's stored
    head_dim=128,
    d_ff=18432,                # dense-layer FFN width (first_k_dense layers)
    vocab_size=129_280,
    rope_style="full",
    rope_theta=10_000.0,
    mlp_act="silu",
    mlp_gated=True,
    moe=MoEConfig(num_experts=256, top_k=8, d_expert=2048, num_shared=1,
                  first_k_dense=3),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128),
    mtp_depth=1,
    long_context="swa",
)
