"""Attention: GQA/MQA with qk-norm, bias, softcap and local windows, and
the posit-quantized KV cache for decode — the counterpart of
``repro.models.attention`` for serving.

Every posit write of the cache goes through the KV-append kernel's
wrapper (one launch a layer for K, V and every row) and every posit read
through the decode kernel's; a decode step whose cache qualifies
(``_fused_kv_eligible``) attends through the posit-KV attention kernel,
which decodes K/V inside the kernel.  A prefill of more than 1024
positions without ``lengths`` attends through the blocked online softmax
(``chunked_attention``), as the reference's does.  ``attention_train`` is
the full-sequence attention as a forward pass (the encoder's; gradients
wait for queue A item A5, ROADMAP.md), and ``cross_attention`` attends a
decoder's queries over an encoder's precomputed K/V.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.arith import get_fused_kernels, get_round_backend
from repro_torch.core.formats import PositFormat
from repro_torch.core.quant import PositTensor
from repro_torch.kernels.posit_codec import kv_scatter, posit_kv_append
from repro_torch.kernels.posit_kv_attention import posit_kv_attention

from .common import dense, make_dense, param, rms_norm, rope, softcap, wval

NEG_INF = -1e30
BIG_WINDOW = 1 << 30


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KVCache:
    """Fixed-capacity KV cache; storage either bf16 tensors or posit bits.

    One layer's cache holds (B, S, KV, D) storage and a ``length`` that is
    a scalar int32 (every row advances together) or a (B,) vector of
    per-row valid lengths (the serving engine's continuous-batching
    slots).  A model's cache stacks the layers along a leading axis
    ((L, B, S, KV, D) storage, (L,) or (L, B) lengths); ``layer(i)`` gives
    one layer's view.  Unlike the reference's immutable arrays, ``append``
    writes into the storage in place and returns a cache that shares it
    with a new ``length``.
    """

    k: object  # torch.Tensor (.., B, S, KV, D) bf16  |  PositTensor bits
    v: object
    length: torch.Tensor  # int32: () | (B,), stacked (L,) | (L, B)

    @staticmethod
    def _raw(store) -> torch.Tensor:
        return store.bits if isinstance(store, PositTensor) else store

    # -- storage ---------------------------------------------------------
    @staticmethod
    def create(batch: int, capacity: int, kv_heads: int, head_dim: int,
               fmt: Optional[PositFormat] = None, per_row: bool = False,
               device=None, layers: Optional[int] = None) -> "KVCache":
        """Zeroed storage (bf16, or posit bits of ``fmt``); ``layers``
        stacks that many layers' caches."""
        lead = () if layers is None else (layers,)
        shape = (*lead, batch, capacity, kv_heads, head_dim)
        length = torch.zeros((*lead, *((batch,) if per_row else ())),
                             dtype=torch.int32, device=device)
        if fmt is None:
            return KVCache(
                torch.zeros(shape, dtype=torch.bfloat16, device=device),
                torch.zeros(shape, dtype=torch.bfloat16, device=device),
                length)
        return KVCache(
            PositTensor(torch.zeros(shape, dtype=fmt.storage_dtype,
                                    device=device), fmt, None),
            PositTensor(torch.zeros(shape, dtype=fmt.storage_dtype,
                                    device=device), fmt, None),
            length)

    def layer(self, i: int) -> "KVCache":
        """Layer ``i`` of a stacked cache (views of the same storage)."""
        return KVCache(self.k[i], self.v[i], self.length[i])

    def read(self, dtype: torch.dtype = torch.bfloat16):
        return wval(self.k, dtype), wval(self.v, dtype)

    def append(self, k_new: torch.Tensor, v_new: torch.Tensor,
               new_length=None) -> "KVCache":
        """Write S_new positions into the cache (in place).

        Scalar-length caches write at ``length`` (every row in lockstep;
        the start clamps so the block fits, as ``dynamic_update_slice``
        does).  Per-row caches write one position per row at each row's
        own ``length`` when S_new == 1 (continuous-batching decode; a row
        whose length is past the capacity writes nothing, as the
        reference's scatter drops it), or a fresh block at position 0 when
        S_new > 1 (right-padded prefill: ``new_length`` then carries the
        true per-row prompt lengths).  A posit cache is written by
        ``posit_kv_append``; it carries no scale (``create``), and a scaled
        store is refused.
        """
        S_new = k_new.shape[1]
        if isinstance(self.k, PositTensor):
            if self.k.scale is not None or self.v.scale is not None:
                raise ValueError("KVCache.append: a posit KV cache carries "
                                 "no scale")
            posit_kv_append(k_new.contiguous(), v_new.contiguous(),
                            self.k.bits, self.v.bits, self.length,
                            self.k.fmt)
        else:
            kv_scatter(self.k, k_new.to(self.k.dtype), self.length)
            kv_scatter(self.v, v_new.to(self.v.dtype), self.length)
        if new_length is None:
            new_length = self.length + S_new
        else:
            new_length = torch.as_tensor(new_length, dtype=torch.int32,
                                         device=self.length.device)
        return KVCache(self.k, self.v, new_length.to(torch.int32))


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------

def plain_attention(q, k, v, *, causal, window, cap, q_offset=0,
                    kv_len=None):
    """Reference/materialized path (prefill, and decode off the kernel
    route).  ``q_offset`` and ``kv_len`` accept scalars (shared by every
    row) or (B,) vectors — per-row offsets/lengths are how ragged
    right-padded prompts and continuous-batching decode slots mask their
    own context."""
    B, Sq, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    dev = q.device
    qg = q.reshape(B, Sq, KV, G, D)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg.to(torch.float32),
                          k.to(torch.float32))
    logits = logits * (D ** -0.5)
    logits = softcap(logits, cap)
    # (1|B, Sq) query positions vs (S,) key positions
    qpos = (torch.as_tensor(q_offset, device=dev).reshape(-1, 1)
            + torch.arange(Sq, device=dev))
    kpos = torch.arange(S, device=dev)
    m = (qpos[:, :, None] - kpos[None, None, :]) < window
    if causal:
        m = m & (kpos[None, None, :] <= qpos[:, :, None])
    if kv_len is not None:
        m = m & (kpos[None, None, :] < torch.as_tensor(
            kv_len, device=dev).reshape(-1, 1, 1))
    logits = torch.where(m[:, None, None], logits, NEG_INF)
    w = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.reshape(B, Sq, H, D).to(q.dtype)


def chunked_attention(q, k, v, *, causal, window, cap,
                      q_block=512, k_block=512, q_offset=0):
    """Online-softmax blocked attention — never materializes (Sq, Skv).

    Query blocks (outer) and key blocks (inner) with running (max, denom,
    out) carries in f32, as the reference's: the logits and P·V of bf16
    operands accumulate in f32, P is cast to V's dtype before P·V, and the
    denominator sums the f32 P.
    """
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    q_block = min(q_block, Sq)
    k_block = min(k_block, Skv)
    if Sq % q_block or Skv % k_block:
        raise ValueError(f"chunked_attention: blocks ({q_block}, {k_block})"
                         f" do not divide (Sq, Skv) = ({Sq}, {Skv})")
    nq, nk = Sq // q_block, Skv // k_block
    dev = q.device
    qb = q.reshape(B, nq, q_block, KV, G, D)
    kb = k.reshape(B, nk, k_block, KV, D)
    vb = v.reshape(B, nk, k_block, KV, D)
    scale = D ** -0.5
    outs = []
    for qi in range(nq):
        q_blk = qb[:, qi].to(torch.float32)
        qpos = q_offset + qi * q_block + torch.arange(q_block, device=dev)
        m_run = torch.full((B, KV, G, q_block), NEG_INF, dtype=torch.float32,
                           device=dev)
        l_run = torch.zeros((B, KV, G, q_block), dtype=torch.float32,
                            device=dev)
        o_run = torch.zeros((B, KV, G, q_block, D), dtype=torch.float32,
                            device=dev)
        for kj in range(nk):
            v_blk = vb[:, kj]
            kpos = kj * k_block + torch.arange(k_block, device=dev)
            logits = torch.einsum("bqkgd,bskd->bkgqs", q_blk,
                                  kb[:, kj].to(torch.float32)) * scale
            logits = softcap(logits, cap)
            msk = (qpos[:, None] - kpos[None, :]) < window
            if causal:
                msk = msk & (kpos[None, :] <= qpos[:, None])
            logits = torch.where(msk, logits, NEG_INF)
            m_new = torch.maximum(m_run, logits.amax(dim=-1))
            p = torch.exp(logits - m_new[..., None])
            p = torch.where(msk, p, 0.0)
            alpha = torch.exp(m_run - m_new)
            l_run = l_run * alpha + p.sum(dim=-1)
            pv = torch.einsum("bkgqs,bskd->bkgqd",
                              p.to(v_blk.dtype).to(torch.float32),
                              v_blk.to(torch.float32))
            o_run = o_run * alpha[..., None] + pv
            m_run = m_new
        out = o_run / torch.clamp(l_run, min=1e-30)[..., None]
        # (B, KV, G, q_block, D) → (B, q_block, H, D)
        outs.append(out.permute(0, 3, 1, 2, 4).reshape(B, q_block, H, D))
    return torch.cat(outs, dim=1).to(q.dtype)


# ---------------------------------------------------------------------------
# Attention layer (params + apply)
# ---------------------------------------------------------------------------

def init_attention(cfg) -> dict:
    d, H, KV = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    hd = cfg.resolved_head_dim
    p = {
        "wq": make_dense(d, H * hd, bias=cfg.qkv_bias),
        "wk": make_dense(d, KV * hd, bias=cfg.qkv_bias),
        "wv": make_dense(d, KV * hd, bias=cfg.qkv_bias),
        "wo": make_dense(H * hd, d),
    }
    if cfg.qk_norm:
        p["q_gamma"] = param((hd,), init="zeros")
        p["k_gamma"] = param((hd,), init="zeros")
    return p


def _project_qkv(p, x, cfg, positions):
    B, S, _ = x.shape
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = dense(p["wq"], x).reshape(B, S, H, hd)
    k = dense(p["wk"], x).reshape(B, S, KV, hd)
    v = dense(p["wv"], x).reshape(B, S, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_gamma"])
        k = rms_norm(k, p["k_gamma"])
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_train(p, x, cfg, *, window=BIG_WINDOW, causal=True):
    """Full-sequence attention without a cache (the encoder's forward
    pass): the blocked online softmax past 1024 positions, the plain one
    otherwise, as the reference's."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, x, cfg, positions)
    if S > 1024:
        out = chunked_attention(q, k, v, causal=causal, window=window,
                                cap=cfg.attn_softcap)
    else:
        out = plain_attention(q, k, v, causal=causal, window=window,
                              cap=cfg.attn_softcap)
    return dense(p["wo"], out.reshape(B, S, -1))


def attention_prefill(p, x, cfg, cache: KVCache, *, window=BIG_WINDOW,
                      causal=True, lengths=None):
    """Full-sequence attention + cache fill.  Attention uses the fresh bf16
    k/v; the cache stores the quantized copy that decode will read.

    ``lengths`` (B,) marks right-padded prompts: key positions at or past a
    row's length are masked out, and the cache records the true per-row
    lengths instead of the padded S.
    """
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _project_qkv(p, x, cfg, positions)
    cache = cache.append(k, v, new_length=lengths)
    if S > 1024 and lengths is None:
        out = chunked_attention(q, k, v, causal=causal, window=window,
                                cap=cfg.attn_softcap)
    else:
        out = plain_attention(q, k, v, causal=causal, window=window,
                              cap=cfg.attn_softcap, kv_len=lengths)
    return dense(p["wo"], out.reshape(B, S, -1)), cache


def _fused_kv_eligible(cfg, cache: KVCache, S_new: int) -> bool:
    """Route decode attention through the posit-KV attention kernel?

    As the reference decides: posit bit storage without a scale, one query
    position, no logit softcap, no local-window layers, and the round
    backend resolving to the kernel (``auto`` does for a cache on the
    card) with fused kernels on.  Every other combination keeps the
    decode-then-attend route below.
    """
    return (isinstance(cache.k, PositTensor)
            and isinstance(cache.v, PositTensor)
            and cache.k.scale is None and cache.v.scale is None
            and S_new == 1
            and cfg.attn_softcap == 0.0
            and cfg.local_window == 0
            and get_round_backend(cache.k.bits) == "kernel"
            and get_fused_kernels())


def attention_decode(p, x, cfg, cache: KVCache, *, window=BIG_WINDOW):
    """Single-token decode against a (possibly posit-quantized) cache.

    Per-row caches mask and position each row by its own length.  Posit
    caches route through ``posit_kv_attention`` when ``_fused_kv_eligible``
    holds; the decode-then-attend path is its oracle.
    """
    B, S_new, _ = x.shape
    positions = (cache.length.reshape(-1, 1)
                 + torch.arange(S_new, device=x.device)).expand(B, S_new)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions)
    cache = cache.append(k_new, v_new)
    if _fused_kv_eligible(cfg, cache, S_new):
        KV, hd = k_new.shape[2], k_new.shape[3]
        G = q.shape[2] // KV
        out = posit_kv_attention(
            q[:, 0].reshape(B, KV, G, hd).to(torch.float32).contiguous(),
            cache.k.bits, cache.v.bits, cache.length, cache.k.fmt)
        out = out.reshape(B, 1, KV * G, hd).to(x.dtype)
    else:
        k, v = cache.read(dtype=x.dtype)
        out = plain_attention(
            q, k, v, causal=True, window=window, cap=cfg.attn_softcap,
            q_offset=cache.length - S_new, kv_len=cache.length)
    return dense(p["wo"], out.reshape(B, S_new, -1)), cache


def cross_attention(p, x, cfg, enc_k, enc_v, enc_len=None):
    """Decoder-to-encoder attention (seamless): the queries of ``x`` over
    the encoder's precomputed K/V (B, S_src, KV, D), unmasked up to
    ``enc_len`` (a scalar or (B,) valid lengths; None: every position)."""
    B, S_new, _ = x.shape
    H, hd = cfg.n_heads, cfg.resolved_head_dim
    q = dense(p["wq"], x).reshape(B, S_new, H, hd)
    out = plain_attention(q, enc_k, enc_v, causal=False, window=BIG_WINDOW,
                          cap=0.0, kv_len=enc_len)
    return dense(p["wo"], out.reshape(B, S_new, -1))
