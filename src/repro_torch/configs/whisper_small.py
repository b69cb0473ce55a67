"""Whisper-small backbone: encoder-decoder [arXiv:2212.04356].

12L enc + 12L dec, d_model=768 12H d_ff=3072 vocab=51865.  The conv audio
frontend is a stub, as in the JAX package: the model takes precomputed
(B, 1500, 768) frame embeddings.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small",
    family="audio",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=12,
    head_dim=64,
    d_ff=3072,
    vocab_size=51865,
    encoder_decoder=True,
    encoder_layers=12,
    encoder_seq=1500,
    act="gelu",
    glu=False,
)
