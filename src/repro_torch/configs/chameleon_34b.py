"""Chameleon-34B backbone: early-fusion VLM [arXiv:2405.09818].

48L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=65536 (text + VQ image
tokens share the vocabulary, so the backbone is a dense GQA transformer
with qk-norm).  The VQ tokenizer frontend is a STUB: input_specs()
provides fused token ids.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=22016,
    vocab_size=65536,
    qk_norm=True,
)
