"""Architecture registry: --arch <id> -> ModelConfig.

Every architecture of the JAX package is listed and its configuration
copies over verbatim; `models.build_model` builds every family (the
dense and MoE attention LMs, Mamba2, the Jamba hybrid, the VLM with
M-RoPE and the encoder-decoder), and `launch.train` trains all but
Mamba2 and Jamba.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, reduced

_MODULES = {
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "jamba-v0.1-52b": "jamba_v0_1_52b",
    "qwen3-0.6b": "qwen3_0_6b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "yi-34b": "yi_34b",
    "granite-3-8b": "granite_3_8b",
    "whisper-base": "whisper_base",
    "mamba2-130m": "mamba2_130m",
    "qwen2-vl-7b": "qwen2_vl_7b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def get_reduced(arch: str, **overrides) -> ModelConfig:
    return reduced(get_config(arch), **overrides)
