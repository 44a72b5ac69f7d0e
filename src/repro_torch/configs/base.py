"""Model architecture config (the port's copy of the reference's fields
for decoder-only transformers: dense, MoE and the VLM backbone).

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
    """Architecture description of a decoder-only transformer."""

    name: str
    family: str  # dense | moe | vlm (the families the port has so far)
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
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    sliding_window: int = 0  # 0 = full attention
    frontend: str = "none"  # none | vision_stub (chameleon: token ids in)

    def __post_init__(self):
        if self.d_head == 0:
            object.__setattr__(self, "d_head", self.d_model // max(self.num_heads, 1))

    @property
    def is_moe(self) -> bool:
        return self.num_experts > 0

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
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else 0,
            param_dtype="float32",
            compute_dtype="float32",
        )
