"""Architecture registry: --arch <id> -> ModelConfig.

The reference knows ten architectures (``repro.configs.registry``), and
the port has the configs of all of them: the dense family (chatglm3's 2d
RoPE among them), the SSM (mamba2), the hybrid RG-LRU one
(recurrentgemma), the vlm (qwen2-vl: M-RoPE, patch embeddings), the
audio enc-dec (whisper) and the MoE one (llama4-maverick; deepseek-v3
with MLA and multi-token prediction).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "tinyllama-1.1b": "repro_torch.configs.tinyllama",
    "nemotron-4-15b": "repro_torch.configs.nemotron4",
    "command-r-35b": "repro_torch.configs.command_r",
    "mamba2-2.7b": "repro_torch.configs.mamba2",
    "recurrentgemma-9b": "repro_torch.configs.recurrentgemma",
    "chatglm3-6b": "repro_torch.configs.chatglm3",
    "qwen2-vl-72b": "repro_torch.configs.qwen2_vl",
    "whisper-tiny": "repro_torch.configs.whisper_tiny",
    "llama4-maverick-400b-a17b": "repro_torch.configs.llama4_maverick",
    "deepseek-v3-671b": "repro_torch.configs.deepseek_v3",
}

# the reference's architectures not ported yet: none is left
PENDING: tuple = ()

ARCHS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(ARCHS)}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def list_archs() -> list[str]:
    return list(ARCHS)
