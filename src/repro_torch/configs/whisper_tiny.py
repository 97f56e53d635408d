"""whisper-tiny [audio] — enc-dec, conv/mel frontend STUBBED.
[arXiv:2212.04356] 4L d_model=384 6H d_ff=1536 vocab=51865 (padded 51968).
The reference skips its 512k-token decode shape for this arch
(``long_context="skip"``): an enc-dec with <=1.5k source frames and a
448-token real decoder."""
from repro_torch.configs.base import ModelConfig, EncDecConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    source="arXiv:2212.04356",
    num_layers=4,              # decoder layers; encoder in encdec
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    head_dim=64,
    d_ff=1536,
    vocab_size=51_865,
    rope_style="none",
    attn_bias=True,
    mlp_act="gelu",
    mlp_gated=False,
    mlp_bias=True,
    norm="layernorm",
    tie_embeddings=True,
    encdec=EncDecConfig(num_layers=4, source_len=1500),
    long_context="skip",
)
