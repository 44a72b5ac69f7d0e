"""qwen2.5-32b: dense GQA with QKV bias [hf:Qwen/Qwen2.5 family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    d_ff=27648,
    vocab_size=152064,
    activation="swiglu",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
