"""Architecture registry of the port: the MoE family of slice 4 and the
dense GQA family of slice 5.

The port serves DeepSeek-V2 and DeepSeek-V3 (MLA attention, CARE-biased
MoE) and the grouped-query-attention models Gemma2-9B, Qwen3-0.6B,
Qwen1.5-4B, SmolLM-135M and the Chameleon-34B backbone.  Hymba, RWKV6 and
Whisper need the SSM and encoder blocks of ROADMAP item 13; asking for one
raises.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, CareConfig, ModelConfig, ShapeConfig  # noqa: F401

_ARCH_MODULES = {
    "smollm-135m": "smollm_135m",
    "qwen1.5-4b": "qwen1p5_4b",
    "qwen3-0.6b": "qwen3_0p6b",
    "gemma2-9b": "gemma2_9b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "chameleon-34b": "chameleon_34b",
}
# Registered in the JAX package, ported with ROADMAP item 13.
_LATER = ("hymba-1.5b", "rwkv6-1.6b", "whisper-small")

ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    """Look up an architecture config by its id."""
    if arch in _LATER:
        raise NotImplementedError(
            f"{arch!r} needs the model blocks of ROADMAP item 13, not ported yet; "
            f"the port serves {sorted(_ARCH_MODULES)}"
        )
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG
