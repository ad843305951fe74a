"""Encoder-decoder LM (the seamless-m4t family) — the counterpart of
``repro.models.encdec.EncDecLM``.

The audio frontend is a stub: the caller gives precomputed frame
embeddings (B, S_src, d).  The encoder is bidirectional; the decoder has
causal self-attention over a (posit-quantizable) KV cache and
cross-attention to the encoder's output.  The cross K/V of every decoder
layer are projected once at prefill and, under a KV format, quantized to
posit bits there (one encode launch each); every decode pass dequantizes
them whole, to f32 and then to bf16, as the reference does.

A Python loop over the layers replaces ``lax.scan``; the per-layer
parameters are views of the layer-stacked tree, whose names and shapes are
the reference's (``embed``, ``encoder`` stacked over ``enc_layers``,
``decoder`` stacked over ``n_layers``, ``enc_ln``, ``final_ln``).  The
cross K/V are a list of per-layer (K, V) pairs, where the reference
stacks them.

``loss`` is the training forward, differentiable by ``torch.autograd``:
the encoder, then each decoder layer's causal self-attention
(``attention_train``), cross-attention over its ``_cross_kv`` of the
encoder's output, and FFN; the mean CE of each next token.  Where the
config asks for remat, every encoder and decoder layer runs under
``torch.utils.checkpoint``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quant import PositTensor, quantize

from . import attention as attn
from .common import (COMPUTE_DTYPE, cross_entropy, dense, embed,
                     init_embedding, materialize, param, remat_call,
                     rms_norm, unembed, unstack)
from .mlp import ffn, init_ffn


class EncDecLM:
    """Encoder-decoder LM on one device (``None``: the card)."""

    def __init__(self, cfg: ModelConfig, policy: QuantPolicy = QuantPolicy(),
                 device=None):
        self.cfg = cfg
        self.policy = policy
        self.device = resolve_device(device)

    # -- params -----------------------------------------------------------
    def init(self, gen: torch.Generator):
        """f32 parameters on the model's device, drawn from ``gen`` with
        the reference's scales (see ``DecoderLM.init``)."""
        cfg = self.cfg
        d = (cfg.d_model,)
        enc_layer = {"ln1": param(d, init="zeros"),
                     "ln2": param(d, init="zeros"),
                     "attn": attn.init_attention(cfg),
                     "ffn": init_ffn(cfg)}
        dec_layer = {"ln1": param(d, init="zeros"),
                     "ln_x": param(d, init="zeros"),
                     "ln2": param(d, init="zeros"),
                     "self_attn": attn.init_attention(cfg),
                     "cross_attn": attn.init_attention(cfg),
                     "ffn": init_ffn(cfg)}
        return {
            "embed": materialize(init_embedding(cfg.padded_vocab,
                                                cfg.d_model),
                                 gen, self.device),
            "encoder": materialize(enc_layer, gen, self.device,
                                   layers=cfg.enc_layers),
            "decoder": materialize(dec_layer, gen, self.device,
                                   layers=cfg.n_layers),
            "enc_ln": materialize(param(d, init="zeros"), gen, self.device),
            "final_ln": materialize(param(d, init="zeros"), gen,
                                    self.device),
        }

    # -- encoder ----------------------------------------------------------
    def encode(self, params, frames, remat: bool = False) -> torch.Tensor:
        """The encoder's output (B, S_src, d) bf16 for f32 ``frames``; with
        ``remat``, each layer under ``torch.utils.checkpoint``."""
        cfg = self.cfg
        x = torch.as_tensor(frames, device=self.device).to(COMPUTE_DTYPE)
        for lp in unstack(params["encoder"], cfg.enc_layers):
            x = remat_call(remat, self._enc_layer, lp, x)
        return rms_norm(x, params["enc_ln"])

    def _enc_layer(self, lp, x):
        h = rms_norm(x, lp["ln1"])
        x = x + attn.attention_train(lp["attn"], h, self.cfg, causal=False)
        h = rms_norm(x, lp["ln2"])
        return x + ffn(lp["ffn"], h, self.cfg)

    def _cross_kv(self, lp, enc_out):
        """Decoder layer ``lp``'s cross K and V (B, S_src, KV, D) of the
        encoder's output."""
        cfg = self.cfg
        B, S, _ = enc_out.shape
        KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
        k = dense(lp["cross_attn"]["wk"], enc_out).reshape(B, S, KV, hd)
        v = dense(lp["cross_attn"]["wv"], enc_out).reshape(B, S, KV, hd)
        return k, v

    # -- training ---------------------------------------------------------
    def _dec_layer_train(self, lp, x, enc_out):
        cfg = self.cfg
        h = rms_norm(x, lp["ln1"])
        x = x + attn.attention_train(lp["self_attn"], h, cfg)
        h = rms_norm(x, lp["ln_x"])
        k, v = self._cross_kv(lp, enc_out)
        x = x + attn.cross_attention(lp["cross_attn"], h, cfg, k, v)
        h = rms_norm(x, lp["ln2"])
        return x + ffn(lp["ffn"], h, cfg)

    def loss(self, params, batch):
        """(ce, {"ce"}): the mean CE of each next token of
        ``batch["tokens"]`` given ``batch["frames"]``, f32 scalars."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["frames"], remat=cfg.remat)
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        x = embed(params["embed"], tokens.long())
        for lp in unstack(params["decoder"], cfg.n_layers):
            x = remat_call(cfg.remat, self._dec_layer_train, lp, x, enc_out)
        x = rms_norm(x, params["final_ln"])
        logits = unembed(params["embed"], x[:, :-1])
        ce = cross_entropy(logits, tokens[:, 1:], cfg.vocab)
        return ce, {"ce": ce}

    # -- serving ----------------------------------------------------------
    def init_cache(self, batch: int, capacity: int):
        """The decoder's self-attention caches, one scalar length per
        layer (the reference's encdec cache has no per-row lengths)."""
        cfg = self.cfg
        return attn.KVCache.create(
            batch, capacity, cfg.n_kv_heads, cfg.resolved_head_dim,
            fmt=self.policy.fmt("kv_cache"), device=self.device,
            layers=cfg.n_layers)

    def prefill(self, params, batch, capacity: Optional[int] = None):
        """Encode the source frames, take every decoder layer's cross K/V
        (posit bits under a KV format, quantized once here), and prime the
        decoder with the BOS tokens; returns the last position's logits
        and the decode state ``(caches, cross)``."""
        cfg = self.cfg
        enc_out = self.encode(params, batch["frames"])
        fmt = self.policy.fmt("kv_cache")
        cross = []
        for lp in unstack(params["decoder"], cfg.n_layers):
            k, v = self._cross_kv(lp, enc_out)
            if fmt is not None:
                k, v = (quantize(k, fmt, scaled=False),
                        quantize(v, fmt, scaled=False))
            cross.append((k, v))
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        caches = self.init_cache(tokens.shape[0],
                                 capacity or tokens.shape[1])
        logits, caches = self._decode(params, tokens, caches, cross)
        return logits, (caches, cross)

    def _decode(self, params, tokens, caches, cross):
        cfg = self.cfg
        x = embed(params["embed"], tokens)
        lengths = []
        for i, lp in enumerate(unstack(params["decoder"], cfg.n_layers)):
            h = rms_norm(x, lp["ln1"])
            h2, cache = attn.attention_decode(lp["self_attn"], h, cfg,
                                              caches.layer(i))
            lengths.append(cache.length)
            x = x + h2
            h = rms_norm(x, lp["ln_x"])
            ck, cv = cross[i]
            if isinstance(ck, PositTensor):
                ck = ck.dequant(torch.float32).to(x.dtype)
                cv = cv.dequant(torch.float32).to(x.dtype)
            x = x + attn.cross_attention(lp["cross_attn"], h, cfg, ck, cv)
            h = rms_norm(x, lp["ln2"])
            x = x + ffn(lp["ffn"], h, cfg)
        caches = attn.KVCache(caches.k, caches.v, torch.stack(lengths))
        x = rms_norm(x, params["final_ln"])
        return unembed(params["embed"], x[:, -1:]), caches

    def decode_step(self, params, tokens, state):
        """tokens: (B, 1) → next-token logits; the self-attention caches'
        storage is written in place and returned with the advanced
        lengths, the cross K/V as they were."""
        caches, cross = state
        tokens = torch.as_tensor(tokens, device=self.device).long()
        logits, caches = self._decode(params, tokens, caches, cross)
        return logits, (caches, cross)
