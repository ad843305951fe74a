"""AdamW with global-norm clipping — the counterpart of
``repro.optim.adamw``.  The states mirror the parameter tree; master
parameters, gradients and moments are f32.

The global norm sums each leaf's sum of squares in JAX's leaf order (a
dict's keys sorted, ``checkpoint.manager.flatten_state``), as the
reference's ``sum`` over ``tree_leaves`` does, so the clip scale is the
reference's f32 value.  The update runs one leaf at a time, in place
under ``torch.no_grad()``, with the reference's operations in its order
(``p - lr · (m̂ / (√v̂ + eps) + wd · p)``), so no temporary of the whole
tree exists.  The reference has no kernel here: plain torch is the port.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.checkpoint.manager import flatten_state


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0


def _zeros(tree):
    if isinstance(tree, dict):
        return {k: _zeros(v) for k, v in tree.items()}
    return torch.zeros(tree.shape, dtype=torch.float32, device=tree.device)


def adamw_init(params) -> dict:
    """{"m", "v": f32 zeros of the parameters' shapes, "step": int32 0},
    on the parameters' device."""
    leaves, _ = flatten_state(params)
    dev = leaves[0].device if leaves else None
    return {"m": _zeros(params), "v": _zeros(params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, in JAX's leaf order, of each leaf's f32 sum of
    squares."""
    total = 0
    for leaf in flatten_state(tree)[0]:
        total = total + torch.sum(torch.square(leaf.to(torch.float32)))
    return torch.sqrt(torch.as_tensor(total, dtype=torch.float32))


@torch.no_grad()
def adamw_update(params, grads, opt_state, lr,
                 cfg: AdamWConfig = AdamWConfig()) -> Tuple[object, dict]:
    """One step: clip ``grads`` to ``cfg.clip_norm`` by the global norm,
    then the bias-corrected moments and the decoupled weight decay.  The
    f32 ``params`` and the moments are updated in place; returns (params,
    the new optimizer state).  ``lr`` is a float or an f32 0-d tensor."""
    step = opt_state["step"] + 1
    dev = step.device
    gnorm = global_norm(grads)
    clip = torch.tensor(cfg.clip_norm, dtype=torch.float32, device=dev)
    scale = torch.clamp(clip / torch.clamp(gnorm, min=1e-9), max=1.0)
    t = step.to(torch.float32)
    bc1 = 1 - torch.tensor(cfg.b1, dtype=torch.float32, device=dev) ** t
    bc2 = 1 - torch.tensor(cfg.b2, dtype=torch.float32, device=dev) ** t
    lr = torch.as_tensor(lr, dtype=torch.float32, device=dev)
    p_leaves, _ = flatten_state(params)
    for p, g, m, v in zip(p_leaves, flatten_state(grads)[0],
                          flatten_state(opt_state["m"])[0],
                          flatten_state(opt_state["v"])[0]):
        g = g.to(torch.float32) * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))
        v.mul_(cfg.b2).add_(torch.square(g).mul_(1 - cfg.b2))
        del g
        upd = m / bc1
        upd.div_((v / bc2).sqrt_().add_(cfg.eps))
        upd.add_(cfg.weight_decay * p).mul_(lr)
        p.sub_(upd)
    return params, {"m": opt_state["m"], "v": opt_state["v"], "step": step}
