"""DeepSeek-V3 671B: MLA + 256-expert MoE + MTP [arXiv:2412.19437].

61L d_model=7168 128H, MLA (kv_lora 512, q_lora 1536, rope head 64),
1 shared + 256 routed experts top-8 (sigmoid gating), expert hidden 2048,
first 3 layers dense (hidden 18432), vocab 129280, MTP depth 1.
The CARE balancer replaces the per-step exact bias update (DESIGN 2.1).
"""
from repro_torch.configs.base import CareConfig, ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,
    d_ff=18432,
    vocab_size=129280,
    use_mla=True,
    q_lora_rank=1536,
    kv_lora_rank=512,
    qk_rope_head_dim=64,
    qk_nope_head_dim=128,
    v_head_dim=128,
    moe=True,
    n_routed_experts=256,
    n_shared_experts=1,
    moe_top_k=8,
    moe_d_ff=2048,
    first_dense_layers=3,
    gate_fn="sigmoid",
    mtp=True,
    care=CareConfig(enabled=True, comm="dt", x=8, bias_alpha=2.0),
)
