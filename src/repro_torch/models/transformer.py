"""Decoder-only LM for the ``dense`` (qwen, gemma2, granite), ``moe``
(granite-moe, dbrx) and ``vlm`` (internvl2) families — the serving half of
``repro.models.transformer.DecoderLM``.

A Python loop over the layers replaces ``lax.scan``; the per-layer
parameters are views of the layer-stacked tree.  gemma2's logit softcaps,
alternating local windows, sandwich norms and embedding scale are ported,
so the plain decode route is exercised too.  A ``moe`` layer runs
``moe.moe_ffn`` where a dense one runs its FFN; serving drops the aux loss,
as the reference's does.  A ``vlm`` model's ``vision_stub`` frontend puts
the caller's precomputed patch embeddings (``batch["frontend"]``) before
the prompt's tokens; they take cache positions, and a decode step's
positions follow from the cache length.  Training (``loss``) waits for a
later slice (ROADMAP.md, queue A item A5).
"""
from __future__ import annotations

from typing import List, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quant import fake_quant

from . import attention as attn
from .common import (COMPUTE_DTYPE, embed, init_embedding, materialize,
                     param, rms_norm, unembed, unstack)
from .mlp import ffn, init_ffn
from .moe import init_moe, moe_ffn

BIG_WINDOW = attn.BIG_WINDOW


class DecoderLM:
    """Dense, MoE or VLM decoder LM on one device (``None``: the card)."""

    def __init__(self, cfg: ModelConfig, policy: QuantPolicy = QuantPolicy(),
                 device=None):
        if cfg.frontend not in ("none", "vision_stub"):
            raise NotImplementedError(
                f"DecoderLM has no {cfg.frontend!r} frontend: the "
                f"reference's audio model is the encdec family (EncDecLM)")
        self.cfg = cfg
        self.policy = policy
        self.device = resolve_device(device)

    # -- params -----------------------------------------------------------
    def layer_spec(self) -> dict:
        cfg = self.cfg
        p = {
            "ln1": param((cfg.d_model,), init="zeros"),
            "ln2": param((cfg.d_model,), init="zeros"),
            "attn": attn.init_attention(cfg),
        }
        if cfg.attn_softcap > 0:  # gemma2 sandwich norms
            p["ln1_post"] = param((cfg.d_model,), init="zeros")
            p["ln2_post"] = param((cfg.d_model,), init="zeros")
        if cfg.n_experts:
            p["moe"] = init_moe(cfg)
        else:
            p["ffn"] = init_ffn(cfg)
        return p

    def init(self, gen: torch.Generator):
        """f32 parameters on the model's device, drawn from ``gen`` (a
        generator on that device) with the reference's scales: 1/sqrt(fan
        in) for projections, 0.02 for the embedding table, zeros for norm
        gains.  The layers are filled one after another."""
        cfg = self.cfg
        return {
            "embed": materialize(init_embedding(cfg.padded_vocab,
                                                cfg.d_model),
                                 gen, self.device),
            "layers": materialize(self.layer_spec(), gen, self.device,
                                  layers=cfg.n_layers),
            "final_ln": materialize(param((cfg.d_model,), init="zeros"),
                                    gen, self.device),
        }

    # per-layer local/global pattern (gemma2: even layers local)
    def _windows(self) -> List[int]:
        cfg = self.cfg
        if cfg.local_window > 0:
            return [cfg.local_window if i % 2 == 0 else BIG_WINDOW
                    for i in range(cfg.n_layers)]
        return [BIG_WINDOW] * cfg.n_layers

    # -- blocks -----------------------------------------------------------
    def _block(self, lp, x, attend):
        """One layer: ``attend(h) -> (h, cache)`` is the prefill or the
        decode attention of the normed residual stream."""
        h, cache = attend(rms_norm(x, lp["ln1"]))
        if "ln1_post" in lp:
            h = rms_norm(h, lp["ln1_post"])
        x = x + h
        h = rms_norm(x, lp["ln2"])
        if "moe" in lp:
            h, _ = moe_ffn(lp["moe"], h, self.cfg)
        else:
            h = ffn(lp["ffn"], h, self.cfg)
        if "ln2_post" in lp:
            h = rms_norm(h, lp["ln2_post"])
        return self._act_quant(x + h), cache

    def _block_decode(self, lp, x, window, cache):
        return self._block(lp, x, lambda h: attn.attention_decode(
            lp["attn"], h, self.cfg, cache, window=window))

    def _block_prefill(self, lp, x, window, cache, lengths):
        return self._block(lp, x, lambda h: attn.attention_prefill(
            lp["attn"], h, self.cfg, cache, window=window, lengths=lengths))

    def _act_quant(self, x):
        """Block-boundary activation rounding (QuantPolicy.activations):
        the residual stream is snapped onto the posit lattice between
        blocks, while compute stays in the wide dtype."""
        if self.policy.activations is None:
            return x
        return fake_quant(x.to(torch.float32),
                          self.policy.activations).to(x.dtype)

    def _inputs_embed(self, params, batch):
        """The prompt's embeddings, after the ``vision_stub`` frontend's
        patch rows (f32, cast to bf16) where the config has one."""
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        x = embed(params["embed"], tokens)
        if self.cfg.frontend == "vision_stub":
            fe = torch.as_tensor(batch["frontend"], device=self.device)
            x = torch.cat([fe.to(COMPUTE_DTYPE), x], dim=1)
        return self._embed_scale(x)

    def _embed_scale(self, x):
        """gemma scales the embeddings by sqrt(d_model), in bf16."""
        if self.cfg.attn_softcap > 0:
            return x * torch.tensor(self.cfg.d_model, dtype=COMPUTE_DTYPE,
                                    device=x.device) ** 0.5
        return x

    def _run_layers(self, params, x, caches, step):
        """Run ``step(lp, x, window, cache) -> (x, cache)`` over the layers
        and restack the caches' lengths."""
        lengths = []
        for i, (lp, window) in enumerate(zip(
                unstack(params["layers"], self.cfg.n_layers),
                self._windows())):
            x, c = step(lp, x, window, caches.layer(i))
            lengths.append(c.length)
        return x, attn.KVCache(caches.k, caches.v, torch.stack(lengths))

    def loss(self, params, batch):
        raise NotImplementedError("DecoderLM.loss waits for the training "
                                  "slice of the port (ROADMAP.md, queue A "
                                  "item A5)")

    # -- serving ----------------------------------------------------------
    def init_cache(self, batch: int, capacity: int, per_row: bool = False):
        cfg = self.cfg
        return attn.KVCache.create(
            batch, capacity, cfg.n_kv_heads, cfg.resolved_head_dim,
            fmt=self.policy.fmt("kv_cache"), per_row=per_row,
            device=self.device, layers=cfg.n_layers)

    def prefill(self, params, batch, capacity: Optional[int] = None):
        """Encode a prompt, fill a fresh cache, return last-position logits.

        ``batch["lengths"]`` (B,) marks right-padded ragged prompts: pad
        positions are masked out of every prefill attention, the caches
        carry per-row lengths, and the returned logits are each row's LAST
        REAL token's — so padded-batch prefill logits match per-prompt
        unbatched prefill.  A ``vision_stub`` model takes no ``lengths``
        (patch rows would shift each row's token offsets) and adds its
        ``frontend_len`` patch rows to the capacity.
        """
        cfg = self.cfg
        lengths = batch.get("lengths")
        B, S = batch["tokens"].shape
        capacity = capacity or S
        if cfg.frontend == "vision_stub":
            if lengths is not None:
                raise NotImplementedError(
                    "ragged prompts + vision frontend: patch rows would "
                    "shift every row's real-token offsets")
            capacity += cfg.frontend_len  # patches occupy cache positions
        if lengths is not None:
            lengths = torch.as_tensor(lengths, dtype=torch.int32,
                                      device=self.device)
        caches = self.init_cache(B, capacity, per_row=lengths is not None)
        x = self._inputs_embed(params, batch)
        x, caches = self._run_layers(
            params, x, caches,
            lambda lp, x, w, c: self._block_prefill(lp, x, w, c, lengths))
        x = rms_norm(x, params["final_ln"])
        if lengths is None:
            x_last = x[:, -1:]
        else:  # each row's last real token (right-padded layout)
            idx = torch.clamp(lengths - 1, 0, S - 1).long()
            x_last = x[torch.arange(B, device=x.device), idx][:, None, :]
        return unembed(params["embed"], x_last, cfg.final_softcap), caches

    def decode_step(self, params, tokens, caches):
        """tokens: (B, 1) → next-token logits; the caches' storage is
        written in place and returned with the advanced lengths."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        x = self._embed_scale(embed(params["embed"], tokens))
        x, caches = self._run_layers(params, x, caches, self._block_decode)
        x = rms_norm(x, params["final_ln"])
        return unembed(params["embed"], x, self.cfg.final_softcap), caches
