"""internvl2-2b [vlm]: InternViT + InternLM2 backbone [arXiv:2404.16821; hf].

The ViT frontend is a stub per the assignment: input_specs provide
precomputed patch embeddings (B, 256, d_model).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92553,
    frontend="vision_stub", frontend_len=256,
)
