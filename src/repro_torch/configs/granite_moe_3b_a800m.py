"""granite-moe-3b-a800m [moe]: 40 experts top-8, d_ff=512 per expert
[hf:ibm-granite]. NOTE the assignment line says "MoE 40e top-8" while its
comment says "32 experts"; we follow the structured field (40 experts) —
padded to 48 on a 16-way model axis for expert parallelism.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab=49155,
    n_experts=40, top_k=8,
)
