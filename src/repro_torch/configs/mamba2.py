"""mamba2-2.7b [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060] 64L d_model=2560 ssm_state=128 vocab=50280 (padded
50432). d_inner = 2*d_model = 5120, head_dim 64 -> 80 SSD heads."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=64,
    d_model=2560,
    num_heads=80,              # = d_inner / head_dim (informational)
    num_kv_heads=80,
    head_dim=64,
    d_ff=0,                    # no separate channel MLP
    vocab_size=50_280,
    block_pattern=("ssd",),
    rope_style="none",
    mlp_act="silu",
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  chunk=128, n_groups=1),
    long_context="native",     # recurrent decode: O(1) per token
)
