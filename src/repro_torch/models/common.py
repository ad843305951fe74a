"""Shared building blocks of the decoder: parameter specs and their
initializer, norms, rotary embeddings, token embedding and head, the
dense projection and the training loss — the counterpart of
``repro.models.common``.

Parameters are a tree of nested dicts, with the reference's names and
shapes: per-layer leaves are stacked along a leading layer axis.  Posit
weight leaves (``PositTensor``) are decoded by ``wval`` through the codec
kernel's wrapper on every use, as the reference decodes them.  The large
products are plain ``torch.matmul``/``einsum`` in bf16 with f32
accumulation, as the reference leaves them to XLA; the attention logits,
P·V and the unembedding keep f32 outputs (bf16 operands upcast exactly).
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Sequence

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core.quant import PositTensor

COMPUTE_DTYPE = torch.bfloat16
PARAM_DTYPE = torch.float32


# ---------------------------------------------------------------------------
# Parameter specs and the initializer
# ---------------------------------------------------------------------------

class ParamSpec(NamedTuple):
    """Shape and initializer of one parameter (of one layer)."""

    shape: tuple
    init: str = "normal"            # normal | zeros | ones | uniform_pm
    scale: Optional[float] = None   # normal std; None → 1/sqrt(fan_in)


def param(shape: Sequence[int], init: str = "normal",
          scale: Optional[float] = None) -> ParamSpec:
    return ParamSpec(tuple(int(s) for s in shape), init, scale)


def _scale(spec: ParamSpec) -> Optional[float]:
    """A normal leaf's std: its own, else the reference's 1/sqrt(fan_in)."""
    if spec.init != "normal" or spec.scale is not None:
        return spec.scale
    shape = spec.shape
    return 1.0 / math.sqrt(shape[-2] if len(shape) >= 2 else shape[-1])


def stacked(n: int, specs):
    """``specs`` with a leading axis of ``n`` on every leaf: ``n`` layers
    stacked inside one layer of an outer stack (the reference's two-level
    ``stacked``).  A normal leaf keeps one layer's fan-in scale."""
    if isinstance(specs, ParamSpec):
        return ParamSpec((n, *specs.shape), specs.init, _scale(specs))
    return {k: stacked(n, v) for k, v in specs.items()}


def _fill(t: torch.Tensor, spec: ParamSpec, gen: torch.Generator) -> None:
    if spec.init == "zeros":
        t.zero_()
    elif spec.init == "ones":
        t.fill_(1.0)
    elif spec.init == "normal":
        t.normal_(0.0, _scale(spec), generator=gen)
    elif spec.init == "uniform_pm":     # the SSM's A_log: uniform on [1, 16)
        t.uniform_(1.0, 16.0, generator=gen)
    else:
        raise ValueError(spec.init)


def materialize(specs, gen: torch.Generator, device: torch.device,
                layers: Optional[int] = None):
    """Allocate a spec tree on ``device`` and fill it from ``gen``.  With
    ``layers``, every leaf gets a leading layer axis and is filled layer by
    layer (all of layer 0's leaves, then layer 1's, ...), so no per-layer
    copy is ever stacked."""
    leaves = []

    def alloc(tree):
        if isinstance(tree, ParamSpec):
            shape = tree.shape if layers is None else (layers, *tree.shape)
            t = torch.empty(shape, dtype=PARAM_DTYPE, device=device)
            leaves.append((t, tree))
            return t
        return {k: alloc(v) for k, v in tree.items()}

    out = alloc(specs)
    for i in range(1 if layers is None else layers):
        for t, spec in leaves:
            _fill(t if layers is None else t[i], spec, gen)
    return out


def tree_map(fn, tree):
    """Apply ``fn`` to every leaf (tensor or ``PositTensor``) of a tree of
    nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def unstack(tree, n: int):
    """Per-layer views of a layer-stacked tree.  A tensor leaf is cut by
    ``unbind``, so under autograd one backward stacks every layer's
    gradient (``t[i]`` would zero-fill and add a whole stack per layer)."""
    def cut(t):
        return t.unbind(0) if isinstance(t, torch.Tensor) else [
            t[i] for i in range(n)]

    def pick(tree, i):
        if isinstance(tree, dict):
            return {k: pick(v, i) for k, v in tree.items()}
        return tree[i]

    cols = tree_map(cut, tree)
    return [pick(cols, i) for i in range(n)]


def remat_call(remat: bool, fn, *args):
    """``fn(*args)``; with ``remat``, under ``torch.utils.checkpoint`` (the
    reference's ``jax.checkpoint``): only the inputs are kept, and the
    forward runs again in the backward.  No block draws random numbers,
    so no RNG state is stashed."""
    if remat:
        return checkpoint(fn, *args, use_reentrant=False,
                          preserve_rng_state=False)
    return fn(*args)


def to_device(tree, device):
    """The tree with every leaf on ``device`` (leaves already there are
    kept as they are)."""
    def mv(x):
        if isinstance(x, PositTensor):
            return PositTensor(x.bits.to(device), x.fmt,
                               None if x.scale is None else
                               x.scale.to(device))
        return x.to(device)
    return tree_map(mv, tree)


# ---------------------------------------------------------------------------
# Normalization / positional
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, gamma: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    xf = x.to(torch.float32)
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + gamma.to(torch.float32))
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D); positions: (..., S)."""
    d = x.shape[-1]
    half = d // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32,
                                       device=x.device))
    freqs = torch.exp(-log_theta * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., :, None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    xf1 = x[..., :half].to(torch.float32)
    xf2 = x[..., half:].to(torch.float32)
    out = torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    if cap <= 0:
        return x
    return (cap * torch.tanh(x.to(torch.float32) / cap)).to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def init_embedding(vocab_padded: int, d: int) -> Dict[str, ParamSpec]:
    return {"table": param((vocab_padded, d), scale=0.02)}


def embed(params, tokens: torch.Tensor) -> torch.Tensor:
    table = params["table"]
    if isinstance(table, PositTensor):
        # gather the narrow bits first, decode only the gathered rows
        return wval(table[tokens], COMPUTE_DTYPE)
    return table[tokens].to(COMPUTE_DTYPE)


def unembed(params, x: torch.Tensor, final_cap: float = 0.0) -> torch.Tensor:
    """f32 logits: the bf16 operands upcast exactly, as the reference's
    ``preferred_element_type=float32``."""
    w = wval(params["table"], x.dtype).T
    logits = torch.matmul(x.to(torch.float32), w.to(torch.float32))
    return softcap(logits, final_cap)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """Mean CE over the tokens, the padded vocab ids masked out of the f32
    logits (to -1e30, as the reference's).  Where the table has no padded
    rows the mask would change nothing, and its copy of the logits is
    skipped (gemma2-2b: 2.1 GB of f32 logits at B = 4, S = 512)."""
    logits = logits.to(torch.float32)
    V = logits.shape[-1]
    if V > vocab:
        mask = torch.arange(V, device=logits.device) < vocab
        logits = torch.where(mask, logits, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def wval(leaf, dtype: torch.dtype = COMPUTE_DTYPE) -> torch.Tensor:
    """Weight value: decode ``PositTensor`` leaves (the PRAU-decode
    analogue).  Without a scale the decode kernel writes ``dtype``
    directly, the same bits as decoding to f32 and casting."""
    if isinstance(leaf, PositTensor):
        if leaf.scale is None:
            return leaf.dequant(dtype)
        return leaf.dequant(torch.float32).to(dtype)
    return leaf.to(dtype)


def make_dense(d_in: int, d_out: int, bias: bool = False
               ) -> Dict[str, ParamSpec]:
    p = {"w": param((d_in, d_out))}
    if bias:
        p["b"] = param((d_out,), init="zeros")
    return p


def dense(p, x: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in x's dtype: a bf16 product accumulates in f32 and rounds
    once (with reduced-precision reductions off on the card)."""
    y = torch.matmul(x, wval(p["w"], x.dtype))
    if "b" in p:
        y = y + wval(p["b"], y.dtype)
    return y
