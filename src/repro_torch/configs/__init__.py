"""Architecture registry: --arch <id> → ModelConfig (+ reduced smoke configs)."""
from __future__ import annotations

import dataclasses

from .base import (ALL_SHAPES, DECODE_32K, LONG_500K, PREFILL_32K,
                   TRAIN_4K, ModelConfig, ShapeConfig, shape_applies)
from .internvl2_2b import CONFIG as INTERNVL2_2B
from .zamba2_7b import CONFIG as ZAMBA2_7B
from .xlstm_1_3b import CONFIG as XLSTM_1_3B
from .dbrx_132b import CONFIG as DBRX_132B
from .granite_moe_3b_a800m import CONFIG as GRANITE_MOE_3B
from .seamless_m4t_large_v2 import CONFIG as SEAMLESS_M4T
from .qwen3_8b import CONFIG as QWEN3_8B
from .gemma2_2b import CONFIG as GEMMA2_2B
from .qwen2_5_14b import CONFIG as QWEN2_5_14B
from .granite_20b import CONFIG as GRANITE_20B

CONFIGS = {
    c.name: c
    for c in [
        INTERNVL2_2B, ZAMBA2_7B, XLSTM_1_3B, DBRX_132B, GRANITE_MOE_3B,
        SEAMLESS_M4T, QWEN3_8B, GEMMA2_2B, QWEN2_5_14B, GRANITE_20B,
    ]
}


def get_config(name: str) -> ModelConfig:
    return CONFIGS[name]


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Tiny same-family config for CPU smoke tests."""
    r = dict(
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
        vocab=512, head_dim=16, remat=False,
        ssm_head_dim=16, ssm_state=16,
        local_window=16 if cfg.local_window else 0,
    )
    if cfg.family == "moe":
        r.update(n_experts=4, top_k=2)
    if cfg.family == "vlm":
        r.update(frontend_len=8)
    if cfg.family == "encdec":
        r.update(enc_layers=2, n_layers=2)
    if cfg.family == "hybrid":
        r.update(n_layers=8, shared_attn_every=3, head_dim=16)
    if cfg.family == "ssm":
        r.update(n_layers=8)
    if cfg.n_kv_heads == 1:
        r.update(n_kv_heads=1)
    if cfg.n_kv_heads == cfg.n_heads:
        r.update(n_kv_heads=4)
    return dataclasses.replace(cfg, **r)
