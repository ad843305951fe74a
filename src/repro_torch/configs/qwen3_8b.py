"""qwen3-8b [dense]: qk_norm, GQA [hf:Qwen/Qwen3-8B]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-8b", family="dense",
    n_layers=36, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=12288, vocab=151936,
    qk_norm=True, head_dim=128, rope_theta=1e6,
)
