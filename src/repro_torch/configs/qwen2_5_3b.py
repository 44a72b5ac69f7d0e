"""qwen2.5-3b: dense GQA with QKV bias [hf:Qwen/Qwen2.5-0.5B family]."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-3b",
    family="dense",
    num_layers=36,
    d_model=2048,
    num_heads=16,
    num_kv_heads=2,
    d_ff=11008,
    vocab_size=151936,
    activation="swiglu",
    qkv_bias=True,
    tie_embeddings=True,
    rope_theta=1_000_000.0,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
