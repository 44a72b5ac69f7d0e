"""zamba2-1.2b: hybrid Mamba2 stack + shared attention blocks [arXiv:2411.15242].

38 Mamba2 layers; one shared (weight-tied) attention + MLP block is invoked
after every 6th SSM layer (6 invocations). Attention is MHA (32 KV heads)
over a sliding window, so the hybrid stays sub-quadratic end to end.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32000,
    activation="gelu",
    ssm_state=64,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_chunk=256,
    attn_every=6,
    sliding_window=4096,
    tie_embeddings=True,
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
