"""whisper-tiny: encoder-decoder, conv audio frontend (stubbed)
[arXiv:2212.04356].

Backbone only: the encoder takes precomputed frame embeddings (what the 2x
conv1d stem would produce); the decoder is a causal transformer with
cross-attention. 4 encoder + 4 decoder layers.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,  # decoder layers
    encoder_layers=4,
    is_encoder_decoder=True,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    activation="gelu",
    max_encoder_len=1500,
    frontend="audio_stub",
    param_dtype="bfloat16",
    compute_dtype="bfloat16",
)
