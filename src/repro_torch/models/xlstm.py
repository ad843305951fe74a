"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) and sLSTM
(scalar memory, sequential) — the counterpart of ``repro.models.xlstm``.

The mLSTM's chunked form carries (C, n, m) across chunks with a running
max stabilizer; a Python loop over the chunks replaces ``lax.scan`` and
``torch.cummax`` the associative max scan.  Every expression is the
reference's, in its order, the -1e30 mask inside the ``exp``.  The sLSTM
runs a Python loop over time; its recurrent weight ``w_h`` (a posit leaf
under a posit weight policy) is decoded once per forward pass and handed
to every step — the same bits as decoding it at each step, since the
decode is elementwise.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F

from .common import dense, make_dense, param, rms_norm, wval
from .ssm import softplus

CHUNK = 256


def mlstm_dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model      # up-projection factor 2
    H = cfg.n_heads                          # 4 for xlstm-1.3b
    Dh = d_in // H
    return d_in, H, Dh


@dataclasses.dataclass
class MLSTMCache:
    C: torch.Tensor  # (B,H,Dk,Dv) f32 matrix memory
    n: torch.Tensor  # (B,H,Dk)    f32 normalizer
    m: torch.Tensor  # (B,H)       f32 max stabilizer


def init_mlstm(cfg) -> dict:
    d = cfg.d_model
    d_in, H, Dh = mlstm_dims(cfg)
    return {
        "w_up": make_dense(d, d_in),
        "w_z": make_dense(d, d_in),
        "wq": make_dense(d_in, d_in),
        "wk": make_dense(d_in, d_in),
        "wv": make_dense(d_in, d_in),
        "w_i": param((d_in, H), scale=0.02),
        "w_f": param((d_in, H), scale=0.02),
        "b_i": param((H,), init="zeros"),
        "b_f": param((H,), init="ones"),
        "norm_gamma": param((d_in,), init="zeros"),
        "w_down": make_dense(d_in, d),
    }


def _mlstm_qkvif(p, x, cfg):
    B, S, _ = x.shape
    d_in, H, Dh = mlstm_dims(cfg)
    u = dense(p["w_up"], x)
    z = dense(p["w_z"], x)
    q = dense(p["wq"], u).reshape(B, S, H, Dh)
    k = dense(p["wk"], u).reshape(B, S, H, Dh)
    # the scale rounded to k's dtype first, as the reference's weak scalar
    k = k * torch.tensor(Dh ** -0.5, dtype=k.dtype)
    v = dense(p["wv"], u).reshape(B, S, H, Dh)
    uf = u.to(torch.float32)
    log_i = (uf @ wval(p["w_i"], torch.float32)) + \
        wval(p["b_i"], torch.float32)
    # forget gate: sigmoid in log space → log f = -softplus(-pre)
    pre_f = (uf @ wval(p["w_f"], torch.float32)) + \
        wval(p["b_f"], torch.float32)
    log_f = -softplus(-pre_f)                # (B,S,H), <= 0
    return q, k, v, log_i, log_f, z


def _mlstm_out(p, y, z, x):
    """rms_norm(y) · silu(z) through ``w_down``, in x's dtype."""
    y = rms_norm(y, p["norm_gamma"]) * \
        F.silu(z.to(torch.float32)).to(x.dtype)
    return dense(p["w_down"], y)


def mlstm_train(p, x: torch.Tensor, cfg, chunk: int = CHUNK) -> torch.Tensor:
    y, _ = mlstm_forward(p, x, cfg, chunk)
    return y


def _mlstm_chunk(carry: MLSTMCache, q_k, k_k, v_k, li_k, lf_k):
    """One chunk: the carried (C, n, m) and the chunk's q, k, v (B,chunk,
    H,D) and log gates (B,chunk,H) → (carry', y (B,chunk,H,D))."""
    C, n, m = carry.C, carry.n, carry.m
    chunk = li_k.shape[1]
    qf = q_k.to(torch.float32)
    kf = k_k.to(torch.float32)
    vf = v_k.to(torch.float32)
    cumf = torch.cumsum(lf_k, dim=1)         # (B,chunk,H) inclusive
    total = cumf[:, -1]                      # (B,H)
    # log weight of in-chunk source s as seen at step t (s<=t):
    #   cumf_t - cumf_s + li_s
    a_s = li_k - cumf                        # (B,chunk,H): li_s - cumf_s
    # stabilizer per target t: m_t = max(m0 + cumf_t, max_{s<=t}(cumf_t + a_s))
    run_max_a = torch.cummax(a_s, dim=1).values
    m_t = cumf + torch.maximum(m[:, None], run_max_a)   # (B,chunk,H)
    logw = cumf[:, :, None, :] + a_s[:, None, :, :] - m_t[:, :, None, :]
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                device=li_k.device))
    # mask inside the exp (masked entries can overflow)
    w_ts = torch.exp(torch.where(tri[None, :, :, None], logw, -1e30))
    qk = torch.einsum("bthd,bshd->btsh", qf, kf)
    num_intra = torch.einsum("btsh,btsh,bshd->bthd", qk, w_ts, vf)
    den_intra = torch.einsum("btsh,btsh,bsh->bth", qk, w_ts,
                             torch.ones_like(li_k))
    # inter-chunk: the carried memory decayed to step t
    w_old = torch.exp(m[:, None] + cumf - m_t)          # (B,chunk,H)
    num_inter = torch.einsum("bthd,bhde->bthe", qf, C) * w_old[..., None]
    den_inter = torch.einsum("bthd,bhd->bth", qf, n) * w_old
    num = num_intra + num_inter
    den = den_intra + den_inter
    y = num / torch.maximum(torch.abs(den), torch.exp(-m_t))[..., None]
    # carry update
    m_new = torch.maximum(m + total, (total[:, None] + a_s).amax(dim=1))
    w_src = torch.exp(total[:, None] + a_s - m_new[:, None])  # (B,chunk,H)
    decay = torch.exp(m + total - m_new)
    C_new = decay[:, :, None, None] * C + \
        torch.einsum("bsh,bshd,bshe->bhde", w_src, kf, vf)
    n_new = decay[:, :, None] * n + torch.einsum("bsh,bshd->bhd", w_src, kf)
    return MLSTMCache(C_new, n_new, m_new), y


def mlstm_forward(p, x: torch.Tensor, cfg, chunk: int = CHUNK):
    B, S, d = x.shape
    d_in, H, Dh = mlstm_dims(cfg)
    q, k, v, log_i, log_f, z = _mlstm_qkvif(p, x, cfg)
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"mlstm_forward: the chunk {chunk} does not "
                         f"divide S = {S}")
    carry = init_mlstm_cache(cfg, B, x.device)
    ys = []
    for lo in range(0, S, chunk):
        sl = slice(lo, lo + chunk)
        carry, y = _mlstm_chunk(carry, q[:, sl], k[:, sl], v[:, sl],
                                log_i[:, sl], log_f[:, sl])
        ys.append(y)
    y = torch.cat(ys, dim=1).reshape(B, S, d_in).to(x.dtype)
    return _mlstm_out(p, y, z, x), carry


def mlstm_decode(p, x: torch.Tensor, cfg, cache: MLSTMCache
                 ) -> Tuple[torch.Tensor, MLSTMCache]:
    B, S1, d = x.shape
    if S1 != 1:
        raise ValueError(f"mlstm_decode: one position at a time, got {S1}")
    d_in, H, Dh = mlstm_dims(cfg)
    q, k, v, log_i, log_f, z = _mlstm_qkvif(p, x, cfg)
    qf = q[:, 0].to(torch.float32)
    kf = k[:, 0].to(torch.float32)
    vf = v[:, 0].to(torch.float32)
    li, lf = log_i[:, 0], log_f[:, 0]        # (B,H)
    m_new = torch.maximum(lf + cache.m, li)
    w_old = torch.exp(lf + cache.m - m_new)
    w_in = torch.exp(li - m_new)
    C_new = w_old[:, :, None, None] * cache.C + \
        w_in[:, :, None, None] * torch.einsum("bhd,bhe->bhde", kf, vf)
    n_new = w_old[:, :, None] * cache.n + w_in[:, :, None] * kf
    num = torch.einsum("bhd,bhde->bhe", qf, C_new)
    den = torch.einsum("bhd,bhd->bh", qf, n_new)
    y = num / torch.maximum(torch.abs(den), torch.exp(-m_new))[..., None]
    y = y.reshape(B, 1, d_in).to(x.dtype)
    return _mlstm_out(p, y, z, x), MLSTMCache(C_new, n_new, m_new)


def init_mlstm_cache(cfg, batch: int, device=None) -> MLSTMCache:
    d_in, H, Dh = mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return MLSTMCache(C=torch.zeros((batch, H, Dh, Dh), **f32),
                      n=torch.zeros((batch, H, Dh), **f32),
                      m=torch.zeros((batch, H), **f32))


def mlstm_sequential_ref(p, x: torch.Tensor, cfg) -> torch.Tensor:
    B, S, d = x.shape
    cache = init_mlstm_cache(cfg, B, x.device)
    ys = []
    for t in range(S):
        y, cache = mlstm_decode(p, x[:, t:t + 1], cfg, cache)
        ys.append(y[:, 0])
    return torch.stack(ys, dim=1)


# ---------------------------------------------------------------------------
# sLSTM: scalar memory, sequential (the xLSTM paper keeps it recurrent)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SLSTMCache:
    c: torch.Tensor  # (B, d) cell
    n: torch.Tensor  # (B, d) normalizer
    h: torch.Tensor  # (B, d) hidden
    m: torch.Tensor  # (B, d) stabilizer


def init_slstm(cfg) -> dict:
    d = cfg.d_model
    return {
        "w_x": make_dense(d, 4 * d),
        "w_h": param((cfg.n_heads, d // cfg.n_heads, 4 * d // cfg.n_heads),
                     scale=0.02),
        "bias": param((4 * d,), init="zeros"),
        "norm_gamma": param((d,), init="zeros"),
        "w_out": make_dense(d, d),
    }


def _slstm_step(p, cfg, cache: SLSTMCache, xt_proj: torch.Tensor,
                w_h: torch.Tensor) -> Tuple[SLSTMCache, torch.Tensor]:
    """xt_proj: (B, 4d) precomputed input projection for this step; w_h:
    the recurrent weight decoded to f32 (H, d/H, 4d/H)."""
    d = cfg.d_model
    H = cfg.n_heads
    u = d // H
    # recurrent contribution: block-diagonal per head
    hf = cache.h.reshape(-1, H, u)
    rec = torch.einsum("bhu,huv->bhv", hf, w_h)
    pre = xt_proj.to(torch.float32) + rec.reshape(-1, 4 * d) + \
        wval(p["bias"], torch.float32)
    zi, ii, fi, oi = torch.split(pre, d, dim=-1)
    zt = torch.tanh(zi)
    ot = torch.sigmoid(oi)
    log_f = -softplus(-fi)
    m_new = torch.maximum(log_f + cache.m, ii)
    c_new = torch.exp(log_f + cache.m - m_new) * cache.c + \
        torch.exp(ii - m_new) * zt
    n_new = torch.exp(log_f + cache.m - m_new) * cache.n + \
        torch.exp(ii - m_new)
    h_new = ot * c_new / torch.clamp(n_new, min=1.0)
    return SLSTMCache(c_new, n_new, h_new, m_new), h_new


def slstm_train(p, x: torch.Tensor, cfg) -> torch.Tensor:
    y, _ = slstm_forward(p, x, cfg)
    return y


def slstm_forward(p, x: torch.Tensor, cfg):
    B, S, d = x.shape
    xp = dense(p["w_x"], x)  # (B,S,4d)
    w_h = wval(p["w_h"], torch.float32)
    cache = init_slstm_cache(cfg, B, x.device)
    hs = []
    for t in range(S):
        cache, h = _slstm_step(p, cfg, cache, xp[:, t], w_h)
        hs.append(h)
    y = torch.stack(hs, dim=1).to(x.dtype)
    y = rms_norm(y, p["norm_gamma"])
    return dense(p["w_out"], y), cache


def slstm_decode(p, x: torch.Tensor, cfg, cache: SLSTMCache
                 ) -> Tuple[torch.Tensor, SLSTMCache]:
    xp = dense(p["w_x"], x)[:, 0]
    cache, h = _slstm_step(p, cfg, cache, xp, wval(p["w_h"], torch.float32))
    y = rms_norm(h[:, None].to(x.dtype), p["norm_gamma"])
    return dense(p["w_out"], y), cache


def init_slstm_cache(cfg, batch: int, device=None) -> SLSTMCache:
    z = torch.zeros((batch, cfg.d_model), dtype=torch.float32, device=device)
    return SLSTMCache(z, z, z, z)
