"""Mamba2 (SSD) block: the chunked parallel scan for prefill, the
recurrent update for decode — the counterpart of ``repro.models.ssm``.

The recurrent state stays f32.  A Python loop over the chunks replaces
``lax.scan``; every expression is the reference's, in its order: the
decays of one chunk are a ``cumsum`` whose pairwise differences are masked
to -1e30 *before* ``exp`` (an ``exp`` masked after would give inf · 0 =
NaN), since ``A_log``'s init on [1, 16) drives ``log_a`` to -1e7 a step.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from .common import dense, make_dense, param, rms_norm, wval

CHUNK = 256


@dataclasses.dataclass
class SSMCache:
    """Decode-time cache: conv window + recurrent state."""

    conv: torch.Tensor   # (B, K-1, conv_dim), the pre-conv xBC's dtype
    state: torch.Tensor  # (B, H, P, N) f32


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def ssm_dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    P_ = cfg.ssm_head_dim
    N = cfg.ssm_state
    G = 1  # single B/C group
    conv_dim = d_in + 2 * G * N
    return d_in, H, P_, N, G, conv_dim


def init_ssm(cfg) -> dict:
    d = cfg.d_model
    d_in, H, P_, N, G, conv_dim = ssm_dims(cfg)
    return {
        "in_proj": make_dense(d, 2 * d_in + 2 * G * N + H),
        "conv_w": param((cfg.ssm_conv, conv_dim)),
        "conv_b": param((conv_dim,), init="zeros"),
        "A_log": param((H,), init="uniform_pm"),
        "D": param((H,), init="ones"),
        "dt_bias": param((H,), init="zeros"),
        "norm_gamma": param((d_in,), init="zeros"),
        "out_proj": make_dense(d_in, d),
    }


def _split_proj(p, x, cfg):
    d_in, H, P_, N, G, conv_dim = ssm_dims(cfg)
    zxbcdt = dense(p["in_proj"], x)
    return torch.split(zxbcdt, [d_in, conv_dim, H], dim=-1)


def _causal_conv(p, xBC, cache_conv=None):
    """Depthwise causal conv, kernel K. xBC: (B,S,C)."""
    K = p["conv_w"].shape[0]
    w = wval(p["conv_w"], torch.float32)
    bias = wval(p["conv_b"], torch.float32)
    xf = xBC.to(torch.float32)
    if cache_conv is None:
        pad = torch.zeros((xf.shape[0], K - 1, xf.shape[-1]),
                          dtype=torch.float32, device=xf.device)
    else:
        pad = cache_conv.to(torch.float32)
    xp = torch.cat([pad, xf], dim=1)
    S = xf.shape[1]
    out = sum(xp[:, i:i + S] * w[i] for i in range(K)) + bias
    new_conv = xp[:, -(K - 1):] if K > 1 else xp[:, :0]
    return F.silu(out).to(xBC.dtype), new_conv.to(xBC.dtype)


def _gates(p, dt):
    """Per-head discretization: a = exp(-softplus(dt+bias) * exp(A_log))."""
    dtf = softplus(dt.to(torch.float32) + wval(p["dt_bias"], torch.float32))
    A = torch.exp(wval(p["A_log"], torch.float32))
    log_a = -dtf * A  # (B,S,H), <= 0
    return dtf, log_a


def _gated_out(p, y, z, x):
    """rms_norm(y · silu(z)) through ``out_proj``, in x's dtype."""
    y = rms_norm(y * F.silu(z.to(torch.float32)).to(x.dtype),
                 p["norm_gamma"])
    return dense(p["out_proj"], y)


def ssm_train(p, x: torch.Tensor, cfg, chunk: int = CHUNK) -> torch.Tensor:
    y, _ = ssm_forward(p, x, cfg, chunk)
    return y


def ssm_prefill(p, x: torch.Tensor, cfg, chunk: int = CHUNK):
    """Chunked forward that also returns the decode-ready cache."""
    return ssm_forward(p, x, cfg, chunk)


def _chunk_step(h, xdt_k, B_k, C_k, la_k):
    """One chunk of the scan: the carried state ``h`` (B,H,P,N) and the
    chunk's (B,chunk,H,P), (B,chunk,N), (B,chunk,N), (B,chunk,H) inputs →
    (h', y (B,chunk,H,P))."""
    chunk = la_k.shape[1]
    cum = torch.cumsum(la_k, dim=1)                    # (B,chunk,H)
    total = cum[:, -1]                                 # (B,H)
    # intra-chunk: L[t,s] = exp(cum_t - cum_s) for s<=t
    diff = cum[:, :, None, :] - cum[:, None, :, :]     # (B,t,s,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=la_k.device))
    L = torch.exp(torch.where(tri[None, :, :, None], diff, -1e30))
    CB = torch.einsum("btn,bsn->bts", C_k, B_k)         # (B,t,s)
    M = CB[..., None] * L                              # (B,t,s,H)
    y_intra = torch.einsum("btsh,bshp->bthp", M, xdt_k)
    # inter-chunk: contribution of the carried state
    y_inter = torch.einsum("btn,bhpn->bthp", C_k, h) * \
        torch.exp(cum)[..., None]
    # h' = exp(total) h + Σ_s exp(total - cum_s) B_s ⊗ xdt_s
    w_s = torch.exp(total[:, None] - cum)              # (B,chunk,H)
    dh = torch.einsum("bsh,bsn,bshp->bhpn", w_s, B_k, xdt_k)
    h_new = torch.exp(total)[:, :, None, None] * h + dh
    return h_new, y_intra + y_inter


def ssm_forward(p, x: torch.Tensor, cfg, chunk: int = CHUNK):
    """Chunked SSD over the full sequence → (y, SSMCache)."""
    B, S, d = x.shape
    d_in, H, P_, N, G, conv_dim = ssm_dims(cfg)
    z, xBC_raw, dt = _split_proj(p, x, cfg)
    K = cfg.ssm_conv
    conv_tail = xBC_raw[:, -(K - 1):] if K > 1 else xBC_raw[:, :0]
    xBC, _ = _causal_conv(p, xBC_raw)
    xs, Bmat, Cmat = torch.split(xBC, [d_in, G * N, G * N], dim=-1)
    xs = xs.reshape(B, S, H, P_)
    dtf, log_a = _gates(p, dt)
    xdt = xs.to(torch.float32) * dtf[..., None]        # (B,S,H,P)

    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"ssm_forward: the chunk {chunk} does not divide "
                         f"S = {S}")
    Bf = Bmat.reshape(B, S, N).to(torch.float32)       # G = 1
    Cf = Cmat.reshape(B, S, N).to(torch.float32)
    h = torch.zeros((B, H, P_, N), dtype=torch.float32, device=x.device)
    ys = []
    for lo in range(0, S, chunk):
        hi = lo + chunk
        h, y = _chunk_step(h, xdt[:, lo:hi], Bf[:, lo:hi], Cf[:, lo:hi],
                           log_a[:, lo:hi])
        ys.append(y)
    y = torch.cat(ys, dim=1)
    y = y + xs.to(torch.float32) * wval(p["D"], torch.float32)[:, None]
    y = y.reshape(B, S, d_in).to(x.dtype)
    return _gated_out(p, y, z, x), SSMCache(conv_tail, h)


def ssm_decode(p, x: torch.Tensor, cfg, cache: SSMCache
               ) -> Tuple[torch.Tensor, SSMCache]:
    """Single-step recurrence: h' = a·h + (dt·B)⊗x ; y = C·h' + D·x."""
    B, S1, d = x.shape
    if S1 != 1:
        raise ValueError(f"ssm_decode: one position at a time, got {S1}")
    d_in, H, P_, N, G, conv_dim = ssm_dims(cfg)
    z, xBC, dt = _split_proj(p, x, cfg)
    xBC, new_conv = _causal_conv(p, xBC, cache_conv=cache.conv)
    xs, Bmat, Cmat = torch.split(xBC, [d_in, G * N, G * N], dim=-1)
    xs = xs.reshape(B, H, P_)
    Bv = Bmat.reshape(B, N).to(torch.float32)
    Cv = Cmat.reshape(B, N).to(torch.float32)
    dtf, log_a = _gates(p, dt)
    a = torch.exp(log_a.reshape(B, H))
    xdt = xs.to(torch.float32) * dtf.reshape(B, H)[..., None]
    h_new = a[:, :, None, None] * cache.state + \
        torch.einsum("bn,bhp->bhpn", Bv, xdt)
    y = torch.einsum("bhpn,bn->bhp", h_new, Cv)
    y = y + xs.to(torch.float32) * wval(p["D"], torch.float32)[:, None]
    y = y.reshape(B, 1, d_in).to(x.dtype)
    new_conv = new_conv.to(cache.conv.dtype)  # keep carry types stable
    return _gated_out(p, y, z, x), SSMCache(new_conv, h_new)


def init_ssm_cache(cfg, batch: int, device=None) -> SSMCache:
    d_in, H, P_, N, G, conv_dim = ssm_dims(cfg)
    K = cfg.ssm_conv
    return SSMCache(
        conv=torch.zeros((batch, K - 1, conv_dim), dtype=torch.bfloat16,
                         device=device),
        state=torch.zeros((batch, H, P_, N), dtype=torch.float32,
                          device=device),
    )


def ssm_sequential_ref(p, x: torch.Tensor, cfg) -> torch.Tensor:
    """Step-by-step oracle used by tests to validate the chunked path."""
    B, S, d = x.shape
    cache = init_ssm_cache(cfg, B, x.device)
    ys = []
    for t in range(S):
        y, cache = ssm_decode(p, x[:, t:t + 1], cfg, cache)
        ys.append(y[:, 0])
    return torch.stack(ys, dim=1)
