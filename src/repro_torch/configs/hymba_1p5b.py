"""Hymba-1.5B: hybrid parallel attention + Mamba heads [arXiv:2411.13676].

32L d_model=1600 25H (GQA kv=5) d_ff=5504 vocab=32001, ssm_state=16.
Sliding-window attention everywhere except 3 full-attention layers
(first / middle / last, per the paper); meta tokens and cross-layer KV
sharing omitted (as in the JAX package).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    ssm_state=16,
    ssm_expand=2,
    sliding_window=1024,
    layer_pattern="mostly_local",
    global_layers=(0, 15, 31),
    rope_theta=10_000.0,
)
