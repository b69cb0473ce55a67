"""Gemma2-9B: alternating local/global attention, logit softcaps
[arXiv:2408.00118].

42L d_model=3584 16H (GQA kv=8) d_ff=14336 vocab=256000, window 4096,
attn softcap 50, final softcap 30, GeGLU, pre+post norms, query scale
1/sqrt(256), sqrt(d_model) embedding scale.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    sliding_window=4096,
    layer_pattern="alt_local_global",
    attn_softcap=50.0,
    final_softcap=30.0,
    act="gelu",
    post_norms=True,
    embed_scale=True,
    query_scale=0.0625,  # 1/sqrt(256)
    tie_embeddings=True,
)
