"""SmolLM-135M: llama-architecture small model [hf:HuggingFaceTB/SmolLM-135M].

30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
)
