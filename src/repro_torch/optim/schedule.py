"""LR schedules (warmup-stable-decay) — the counterpart of
``repro.optim.schedule``, in f32 as the reference computes it.  Every
division is by a 0-d tensor: the card divides by a host scalar through its
reciprocal, which can round otherwise."""
from __future__ import annotations

import torch


def wsd_schedule(step, *, peak_lr=3e-4, warmup=100, stable=1000, decay=1000,
                 floor_frac=0.1) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), an f32
    0-d tensor on the step's device."""
    s = torch.as_tensor(step).to(torch.float32)

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=s.device)

    warm = peak_lr * torch.clamp(s / f32(max(warmup, 1)), max=1.0)
    in_decay = torch.clamp((s - warmup - stable) / f32(max(decay, 1)),
                           0.0, 1.0)
    dec = peak_lr * (1.0 - (1.0 - floor_frac) * in_decay)
    return torch.where(s < warmup + stable, warm, dec)
