"""Model configurations of the port: ``get_config(arch_id)`` /
``get_reduced(arch_id)`` over the architectures the port runs (the
counterpart of ``repro.configs``): every arch of the reference's zoo.
An unknown arch raises a ``KeyError``."""

from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig

_MODULES = {
    "qwen2-vl-2b": "qwen2_vl_2b",
    "qwen2.5-32b": "qwen2_5_32b",
    "gemma3-1b": "gemma3_1b",
    "qwen2.5-14b": "qwen2_5_14b",
    "stablelm-12b": "stablelm_12b",
    "jamba-v0.1-52b": "jamba_v01_52b",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "rwkv6-3b": "rwkv6_3b",
    "alert-anytime-120m": "alert_anytime",
    "whisper-tiny": "whisper_tiny",
}

ALL_IDS = list(_MODULES)
# The ten assigned architectures (every one but the paper's anytime LM),
# in the reference's order: the archs the data plane's dry run loops over.
ARCH_IDS = ["qwen2-vl-2b", "qwen2.5-32b", "gemma3-1b", "qwen2.5-14b",
            "stablelm-12b", "jamba-v0.1-52b", "qwen3-moe-30b-a3b",
            "olmoe-1b-7b", "whisper-tiny", "rwkv6-3b"]


def _mod(arch_id: str):
    if arch_id not in _MODULES:
        raise KeyError(f"arch {arch_id!r} is unknown; known: {ALL_IDS}")
    return importlib.import_module(f"repro_torch.configs.{_MODULES[arch_id]}")


def get_config(arch_id: str) -> ModelConfig:
    return _mod(arch_id).CONFIG


def get_reduced(arch_id: str) -> ModelConfig:
    return _mod(arch_id).reduced()
