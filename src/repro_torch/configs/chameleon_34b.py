"""chameleon-34b: early-fusion VLM, VQ image tokens [arXiv:2405.09818].

The transformer backbone only; image VQ tokenizer frontend is a stub —
``input_specs()`` provides precomputed token ids drawn from the unified
(text + image-codebook) vocabulary. Uses qk-norm as in the paper.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="chameleon-34b",
    family="vlm",
    num_layers=48,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22016,
    vocab_size=65536,
    activation="swiglu",
    use_qk_norm=True,
    frontend="vision_stub",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
