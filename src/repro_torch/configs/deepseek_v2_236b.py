"""DeepSeek-V2 236B: MLA + 160-expert MoE [arXiv:2405.04434].

60L d_model=5120 128H, MLA kv_lora=512 (no q-lora in our build of v2-lite
lineage? full v2 uses q_lora 1536 -- kept), 2 shared + 160 routed top-6
(softmax gating), expert hidden 1536, first layer dense (hidden 12288),
vocab 102400.
"""
from repro_torch.configs.base import CareConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    d_ff=12288,
    vocab_size=102400,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    moe=True,
    n_routed_experts=160,
    n_shared_experts=2,
    moe_top_k=6,
    moe_d_ff=1536,
    first_dense_layers=1,
    gate_fn="softmax",
    care=CareConfig(enabled=True, comm="dt", x=8, bias_alpha=2.0),
)
