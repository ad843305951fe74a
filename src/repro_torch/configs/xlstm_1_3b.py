"""xlstm-1.3b [ssm]: sLSTM + mLSTM blocks [arXiv:2405.04517].

d_ff=0 per the assignment: xLSTM blocks carry their own up/down projections
(pf=2 expansion); there is no separate FFN.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-1.3b", family="ssm",
    n_layers=48, d_model=2048, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    ssm_expand=2,
    supports_long_context=True,
)
