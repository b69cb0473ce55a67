"""RWKV-6 "Finch" 1.6B: attention-free, data-dependent decay [arXiv:2404.05892].

24L d_model=2048 d_ff=7168 vocab=65536.  WKV6 recurrence with per-channel
data-dependent decay, token-shift ddlerp, head dim 64 (32 heads).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,       # wkv heads = d_model / rwkv_head_dim
    num_kv_heads=32,
    d_ff=7168,
    vocab_size=65536,
    rwkv_head_dim=64,
    glu=False,
)
