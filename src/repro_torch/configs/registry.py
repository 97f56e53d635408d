"""Architecture registry: --arch <id> -> ModelConfig.

The reference knows ten architectures (``repro.configs.registry``); the
port has the configs of the ones it trains and serves: the dense family
(chatglm3's 2d RoPE among them), the SSM (mamba2), the hybrid RG-LRU one
(recurrentgemma), the vlm (qwen2-vl: M-RoPE, patch embeddings) and the
audio enc-dec (whisper). The two MoE archs are named, so that asking for
one says where it stands instead of calling it unknown.
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
}

# the reference's other architectures, not ported yet
PENDING = ("llama4-maverick-400b-a17b", "deepseek-v3-671b")

ARCHS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch in PENDING:
        raise NotImplementedError(
            f"arch {arch!r} is not ported yet (ROADMAP.md, Queue 1 item 12: "
            f"MoE, then MLA with multi-token prediction, are what is "
            f"left); "
            f"ported: {list(ARCHS)}")
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: "
                       f"{list(ARCHS) + list(PENDING)}")
    return importlib.import_module(_MODULES[arch]).CONFIG


def list_archs() -> list[str]:
    return list(ARCHS)
