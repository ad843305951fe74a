"""FFN blocks: SwiGLU (llama-family) and GELU — the counterpart of
``repro.models.mlp``."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .common import dense, make_dense


def init_ffn(cfg) -> dict:
    d, ff = cfg.d_model, cfg.d_ff
    if cfg.ffn_kind == "swiglu":
        return {
            "w_gate": make_dense(d, ff),
            "w_up": make_dense(d, ff),
            "w_down": make_dense(ff, d),
        }
    return {"w_up": make_dense(d, ff), "w_down": make_dense(ff, d)}


def ffn(p, x: torch.Tensor, cfg) -> torch.Tensor:
    if cfg.ffn_kind == "swiglu":
        g = dense(p["w_gate"], x)
        u = dense(p["w_up"], x)
        h = F.silu(g.to(torch.float32)).to(x.dtype) * u
    else:   # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(dense(p["w_up"], x).to(torch.float32),
                   approximate="tanh").to(x.dtype)
    return dense(p["w_down"], h)
