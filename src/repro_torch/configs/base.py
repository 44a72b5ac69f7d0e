"""Model architecture config (the port's copy of the reference's fields:
decoder-only transformers, dense, MoE and the VLM backbone; the Mamba2 / SSD
state-space model; the hybrid of both; the encoder-decoder).

One ``ModelConfig`` per published architecture, built from its exact
dimensions; ``smoke()`` derives the reduced config the CPU tests use, with
the same rules as the reference's. Dtypes are torch dtypes.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description. All families share this one record."""

    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int

    d_head: int = 0  # 0 -> d_model // num_heads
    activation: str = "swiglu"  # swiglu | squared_relu | geglu | gelu
    qkv_bias: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5
    rope_theta: float = 10_000.0
    use_qk_norm: bool = False
    # -- MoE
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    moe_d_ff: int = 0  # per-expert FFN width
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    # pad the expert weight arrays to this count (0 = none); routing stays
    # over the real num_experts, the pad experts are never routed to
    expert_pad_to: int = 0
    # -- SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv_width: int = 4
    ssm_chunk: int = 128  # SSD chunk length
    ssm_n_groups: int = 1
    # -- hybrid (zamba2-style shared attention blocks)
    attn_every: int = 0  # a shared attn + MLP block after every k SSM layers
    # -- encoder-decoder (whisper-style)
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    max_encoder_len: int = 1_500  # whisper: 30 s of audio -> 1,500 frames
    frontend: str = "none"  # none | audio_stub | vision_stub
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    sliding_window: int = 0  # 0 = full attention (the hybrid caps its window)

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // max(self.num_heads, 1))

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.family == "ssm"

    @property
    def is_hybrid(self) -> bool:
        return self.family == "hybrid"

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    @property
    def attn_invocations(self) -> int:
        """Number of shared-attention invocations in a hybrid stack."""
        if self.attn_every <= 0:
            return 0
        return self.num_layers // self.attn_every

    @property
    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]

    @property
    def cdtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def smoke(self) -> "ModelConfig":
        """Reduced config of the same family for CPU tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=max(2, min(3, self.num_layers)),
            d_model=64,
            num_heads=4,
            num_kv_heads=min(max(1, self.num_kv_heads * 4 // max(self.num_heads, 1)), 4),
            d_head=16,
            d_ff=128,
            vocab_size=256,
            moe_d_ff=32 if self.is_moe else 0,
            num_experts=8 if self.is_moe else 0,
            moe_top_k=min(self.moe_top_k, 2) if self.is_moe else 0,
            num_shared_experts=min(self.num_shared_experts, 1),
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=16,
            attn_every=2 if self.attn_every else 0,
            encoder_layers=2 if self.is_encoder_decoder else 0,
            max_encoder_len=32,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            param_dtype="float32",
            compute_dtype="float32",
        )
