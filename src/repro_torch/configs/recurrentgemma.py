"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2:1 pattern.
[arXiv:2402.19427 (Griffin)] 38L(~) d_model=4096 16H (MQA kv=1) d_ff=12288
vocab=256000. Pattern: (rglru, rglru, local-attn) cycled; 36 layers = 12
full cycles (38 rounded to the pattern period, noted in DESIGN.md)."""
from repro_torch.configs.base import ModelConfig, RGLRUConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    source="arXiv:2402.19427",
    num_layers=36,             # 38 in the card; rounded to 12 x (2:1) cycles
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    block_pattern=("rglru", "rglru", "attn_local"),
    rope_style="partial",
    rope_frac=0.5,
    mlp_act="gelu",
    mlp_gated=True,
    rglru=RGLRUConfig(lru_width=4096, d_conv=4, local_window=2048),
    logit_softcap=30.0,
    long_context="native",     # recurrent + local attn: natively sub-quadratic
)
