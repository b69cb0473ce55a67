"""Analytic model statistics from a model built on the ``meta`` device
(shapes only, no memory).

Port of ``repro/launch/model_stats.py``, which uses ``jax.eval_shape``.
Counts are summed over the JAX package's parameter leaves
(``partitioning.leaf_shapes``), so they equal the reference's.
"""
from __future__ import annotations

import math

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import model, partitioning


def abstract_params(cfg: ModelConfig) -> dict[str, tuple]:
    """``{JAX path: shape}`` of the model's parameters, built on ``meta``."""
    return partitioning.leaf_shapes(model.Model(cfg, device=torch.device("meta")))


def count_params(cfg: ModelConfig) -> int:
    return int(sum(math.prod(shape) for shape in abstract_params(cfg).values()))


def count_active_params(cfg: ModelConfig) -> int:
    """Active parameters per token (MoE: top-k routed + shared + dense)."""
    total = count_params(cfg)
    if not cfg.moe:
        return total
    e, k = cfg.n_routed_experts, cfg.moe_top_k
    l_moe = cfg.num_layers - cfg.first_dense_layers
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    routed_total = l_moe * e * per_expert
    routed_active = l_moe * k * per_expert
    return total - routed_total + routed_active
