"""Mixture-of-Experts FFN on one device — the counterpart of
``repro.models.moe`` with a model axis of 1 (tp = 1: no expert padding, no
``shard_map``, no ``psum``).

The arithmetic is the reference's: an f32 router, softmax, top-k and
renormalisation of the gates; a first-come-first-served capacity of C
tokens per expert over the whole batch (pad positions compete like real
ones, earlier tokens win); the expert products of bf16 operands with f32
accumulation and f32 results, SwiGLU or GELU between them; the gate
weighting in f32; and the Switch load-balance aux loss.

Two steps are written so that the card gives the reference's bits and the
same bits on every call:

* **The capacity selection** takes each expert's first C routed tokens in
  token order (a cumulative count of ``routed`` along T) and fills the free
  slots with the first unrouted tokens, which is what the reference's
  ``lax.top_k`` over the score ``T - t`` picks; a stable sort stands in for
  ``top_k``, whose order among equal scores is not defined.
* **The combine** (the reference's ``out.at[idx].add(y)``, which XLA
  applies in update order: ascending expert, then slot) adds each token's
  kept expert outputs onto zeros in ascending expert order, one add per
  rank of the top-k — no atomics, so the f32 sum's order is fixed.

The aux loss is differentiable (through the router's softmax, as the
reference's), and so is the output, through the gate weights and the
expert products; training sums the aux over the layers.

The expert weights are decoded whole (``wval``, the codec kernel's decode
for posit leaves) once per call, as the reference decodes them.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .common import param, wval


def init_moe(cfg) -> dict:
    """The reference's tree with its expert axis unpadded (a model axis of
    1: its ``padded_experts(E, 1)`` is E)."""
    d, ff, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    return {
        "router": param((d, E), scale=0.02),
        "w_gate": param((E, d, ff)),
        "w_up": param((E, d, ff)),
        "w_down": param((E, ff, d)),
    }


def _capacity(tokens_local: int, cfg) -> int:
    c = int(tokens_local * cfg.top_k / max(cfg.n_experts, 1)
            * cfg.moe_capacity_factor)
    return min(max(8, (c + 7) // 8 * 8), tokens_local)


def route(xf: torch.Tensor, router_w: torch.Tensor, k: int):
    """(gates (T, E), normalised top-k gate values (T, k), chosen experts
    (T, k)), all from the f32 router logits."""
    logits = xf.to(torch.float32) @ router_w
    gates = torch.softmax(logits, dim=-1)
    gatev, assign = torch.topk(gates, k, dim=-1, sorted=True)
    gatev = gatev / torch.clamp(gatev.sum(-1, keepdim=True), min=1e-9)
    return gates, gatev, assign


def select(assign: torch.Tensor, gatev: torch.Tensor, n_experts: int,
           C: int):
    """First-come-first-served capacity: (idx (E, C) the tokens each
    expert computes, w_tok (E, C) their gate weights — 0 for a filler —
    rank (E, T) each routed token's place in its expert's queue, kept
    (E, T) whether it made the capacity)."""
    T = assign.shape[0]
    eids = torch.arange(n_experts, device=assign.device)
    hit = assign[None, :, :] == eids[:, None, None]          # (E, T, k)
    tok_gate = torch.sum(hit * gatev[None], dim=-1)           # (E, T)
    routed = hit.any(-1)
    rank = torch.cumsum(routed.to(torch.int32), dim=1) - 1
    kept = routed & (rank < C)
    # the reference's top_k of (T - t) over routed tokens, 0 elsewhere:
    # routed tokens in token order, then the unrouted ones in token order
    score = torch.where(routed, T - torch.arange(T, device=assign.device),
                        0)
    idx = torch.sort(score, dim=1, descending=True, stable=True).indices[:,
                                                                         :C]
    valid = torch.gather(routed, 1, idx)
    w_tok = torch.gather(tok_gate, 1, idx) * valid
    return idx, w_tok, rank, kept


def _expert_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(E, C, i)·(E, i, o) of bf16 operands, accumulated and returned in
    f32 (the reference's ``preferred_element_type=float32``).  The card's
    ``bmm(..., out_dtype=)`` has no derivative, so a product that autograd
    records takes the operands upcast to f32 (exact) there too."""
    if a.is_cuda and not (torch.is_grad_enabled()
                          and (a.requires_grad or w.requires_grad)):
        return torch.bmm(a, w, out_dtype=torch.float32)
    return torch.bmm(a.to(torch.float32), w.to(torch.float32))


def combine(y: torch.Tensor, assign: torch.Tensor, rank: torch.Tensor,
            kept: torch.Tensor) -> torch.Tensor:
    """(T, d) f32: each token's kept expert outputs ``y`` (E, C, d) added
    onto zeros in ascending expert order."""
    E, C, d = y.shape
    T = assign.shape[0]
    tok = torch.arange(T, device=y.device)[:, None]
    experts = torch.sort(assign, dim=-1).values                # (T, k)
    ok = kept[experts, tok]                                    # (T, k)
    slot = torch.where(ok, rank[experts, tok], 0)
    contrib = y.reshape(E * C, d)[experts * C + slot]          # (T, k, d)
    contrib = torch.where(ok[..., None], contrib, 0.0)
    out = torch.zeros((T, d), dtype=torch.float32, device=y.device)
    for j in range(experts.shape[1]):
        out = out + contrib[:, j]
    return out


def moe_ffn(p, x: torch.Tensor, cfg) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, d) → (out in x's dtype, the f32 aux loss)."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(-1, d)
    T = xf.shape[0]
    C = _capacity(T, cfg)
    gates, gatev, assign = route(xf, wval(p["router"], torch.float32), k)
    idx, w_tok, rank, kept = select(assign, gatev, E, C)

    gath = xf[idx.reshape(-1)].reshape(E, C, d)
    h = _expert_matmul(gath, wval(p["w_gate"]))
    if cfg.ffn_kind == "swiglu":
        u = _expert_matmul(gath, wval(p["w_up"]))
        h = F.silu(h) * u
    else:   # jax.nn.gelu's default is the tanh approximation
        h = F.gelu(h, approximate="tanh")
    y = _expert_matmul(h.to(x.dtype), wval(p["w_down"]))
    y = y * w_tok[..., None]
    out = combine(y, assign, rank, kept)

    # Load-balance aux loss (Switch-style): E * Σ_e f_e · P_e.
    f_e = torch.mean((assign[..., None] == torch.arange(
        E, device=x.device)).any(1).to(torch.float32), dim=0)
    p_e = torch.mean(gates, dim=0)
    aux = E * torch.sum(f_e * p_e)
    return out.to(x.dtype).reshape(B, S, d), aux
