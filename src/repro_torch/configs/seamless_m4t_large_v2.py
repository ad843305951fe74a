"""seamless-m4t-large-v2 [audio]: enc-dec, multimodal [arXiv:2308.11596].

Audio frontend is a stub: input_specs provide precomputed frame embeddings
for the encoder; the decoder consumes text tokens.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=8192, vocab=256206,
    enc_layers=24, ffn_kind="gelu",
    frontend="audio_stub",
)
