"""Model / run configuration: a copy of ``repro/configs/base.py``.

One flat frozen dataclass drives every architecture; per-arch modules in
this package instantiate it with the published settings.  ``reduced()``
derives the small same-family config of the CPU tests.  The port has no
``use_pallas_router`` / ``use_pallas_attention``: it picks a kernel or its
plain version by the device a tensor lies on (``kernels/ops.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Literal

Family = Literal["dense", "moe", "ssm", "hybrid", "audio", "vlm"]


@dataclasses.dataclass(frozen=True)
class CareConfig:
    """CARE balancer settings for MoE routing (core/moe_balancer.py)."""

    enabled: bool = True
    comm: str = "dt"  # "dt" (sync every x steps) | "et" (error triggered)
    x: int = 8  # sync period / error threshold (tokens per expert, in
    #              units of the per-expert mean load)
    bias_alpha: float = 0.3  # proportional JSAQ bias gain on gate scores
    bias_clip: float = 2.0  # clip on the relative-overload signal
    gamma: float = 0.05  # integral bias gain (DeepSeek-V3-style update,
    #                       driven by the CARE-approximated load)
    drain: float = 0.85  # MSR drain factor per step (emulated service)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: Family = "dense"
    num_layers: int = 4
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: int = 0  # 0 => d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 32000

    # --- attention options -------------------------------------------------
    qkv_bias: bool = False
    qk_norm: bool = False
    attn_softcap: float = 0.0  # 0 => off (gemma2: 50.0)
    final_softcap: float = 0.0  # 0 => off (gemma2: 30.0)
    sliding_window: int = 0  # 0 => all-global
    # "global" | "alt_local_global" (gemma2) | "mostly_local" (hymba)
    layer_pattern: str = "global"
    global_layers: tuple[int, ...] = ()  # explicit global layers (hymba)
    rope_theta: float = 10_000.0
    post_norms: bool = False  # gemma2 post-attn/post-ffn norms
    embed_scale: bool = False  # gemma2 sqrt(d_model) embedding scale
    query_scale: float = 0.0  # 0 => 1/sqrt(head_dim)

    # --- MLA (deepseek) ----------------------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0  # 0 => direct q projection
    kv_lora_rank: int = 512
    qk_rope_head_dim: int = 64
    qk_nope_head_dim: int = 128
    v_head_dim: int = 128

    # --- FFN / MoE ----------------------------------------------------------
    act: str = "silu"  # "silu" (swiglu) | "gelu" (geglu / plain)
    glu: bool = True
    moe: bool = False
    n_routed_experts: int = 0
    n_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0  # routed/shared expert hidden size
    first_dense_layers: int = 0  # deepseek: leading dense layers
    gate_fn: str = "softmax"  # "softmax" (v2) | "sigmoid" (v3)
    moe_capacity_factor: float = 1.5
    care: CareConfig = CareConfig()

    # --- SSM ------------------------------------------------------------------
    ssm_state: int = 16  # mamba state size (hymba)
    rwkv_head_dim: int = 64
    ssm_expand: int = 2  # mamba inner expansion
    conv_kernel: int = 4

    # --- encoder-decoder -----------------------------------------------------
    encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 1500  # whisper 30s @ 50Hz after conv stub

    # --- extras ----------------------------------------------------------------
    mtp: bool = False  # deepseek-v3 multi-token prediction head
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: bool = False  # activation checkpointing per layer

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic state: SSM / hybrid run the 500k decode shape."""
        return self.family in ("ssm", "hybrid")

    def reduced(self) -> "ModelConfig":
        """Same-family tiny config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2 if self.family != "hybrid" else 2),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=32,
            d_ff=256,
            vocab_size=512,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            q_lora_rank=64 if self.q_lora_rank else 0,
            kv_lora_rank=32,
            qk_rope_head_dim=16,
            qk_nope_head_dim=32,
            v_head_dim=32,
            n_routed_experts=8 if self.moe else 0,
            n_shared_experts=min(self.n_shared_experts, 1),
            moe_top_k=min(self.moe_top_k, 2),
            moe_d_ff=64 if self.moe else 0,
            moe_capacity_factor=4.0,
            first_dense_layers=min(self.first_dense_layers, 1),
            encoder_layers=2 if self.encoder_decoder else 0,
            encoder_seq=16 if self.encoder_decoder else 1500,
            rwkv_head_dim=32,
            global_layers=(0,) if self.global_layers else (),
            param_dtype="float32",
            compute_dtype="float32",
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """An assigned (input-shape) cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: Literal["train", "prefill", "decode"]


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}
