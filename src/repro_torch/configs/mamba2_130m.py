"""mamba2-130m: pure SSM, SSD (state-space duality) [arXiv:2405.21060].

Attention-free: no KV cache; the decode carries an O(1) state per layer.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,  # attention-free
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv_width=4,
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
