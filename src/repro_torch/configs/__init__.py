"""Architecture registry of the port: the ten architectures of the JAX
package, in its order, each config copied field for field.

DeepSeek-V2 and DeepSeek-V3 (MLA attention, CARE-biased MoE); the
grouped-query-attention models Gemma2-9B, Qwen3-0.6B, Qwen1.5-4B,
SmolLM-135M and the Chameleon-34B backbone; Hymba-1.5B (parallel attention
and Mamba heads), RWKV6-1.6B (attention-free) and Whisper-small
(encoder-decoder).
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, CareConfig, ModelConfig, ShapeConfig  # noqa: F401

_ARCH_MODULES = {
    "hymba-1.5b": "hymba_1p5b",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "smollm-135m": "smollm_135m",
    "qwen1.5-4b": "qwen1p5_4b",
    "qwen3-0.6b": "qwen3_0p6b",
    "gemma2-9b": "gemma2_9b",
    "whisper-small": "whisper_small",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "chameleon-34b": "chameleon_34b",
}
ARCH_IDS = tuple(_ARCH_MODULES)


def get_config(arch: str) -> ModelConfig:
    """Look up an architecture config by its id."""
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def get_shape(shape: str) -> ShapeConfig:
    return SHAPES[shape]


def cells(include_skipped: bool = False):
    """All (arch, shape) cells in the JAX package's order; ``long_500k`` is
    skipped for full-attention archs (``include_skipped`` lists it with its
    flag)."""
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            skip = shape.name == "long_500k" and not cfg.supports_long_context
            if include_skipped or not skip:
                out.append((arch, shape.name, skip))
    return out
