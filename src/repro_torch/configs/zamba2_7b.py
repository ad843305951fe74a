"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention [arXiv:2411.15242]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    shared_attn_every=6,
    head_dim=112,
    supports_long_context=True,
)
