"""qwen2-moe-a2.7b: 60 routed experts top-4 + 4 shared
[hf:Qwen/Qwen1.5-MoE-A2.7B]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=151936,
    activation="swiglu",
    qkv_bias=True,
    num_experts=60,
    num_shared_experts=4,
    moe_top_k=4,
    moe_d_ff=1408,
    expert_pad_to=64,  # routing stays over 60
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
