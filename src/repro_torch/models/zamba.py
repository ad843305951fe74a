"""Zamba2-style hybrid: a Mamba2 backbone and one *shared* attention + MLP
block invoked every ``shared_attn_every`` layers (its weights reused, a
gate per group) — the counterpart of ``repro.models.zamba.ZambaLM``.

For n_layers = 81, every = 6: 13 groups of 6 mamba layers, each followed
by the shared block, then a 3-layer mamba tail.  The parameters keep the
reference's names and shapes (``groups`` stacked (n_groups, every, ...)
for the mamba layers and (n_groups, ...) for the gates, ``tail`` stacked
(tail, ...), one ``shared`` block); Python loops over the groups and
layers replace the two-level ``lax.scan``.  The shared block's attention
goes through ``attention_prefill`` and ``attention_decode``, so a posit
KV cache takes the KV-append kernel at every call and, on a decode step
that qualifies, the posit-KV attention kernel.  Its weights are decoded
again at each of its calls, as ``dense`` decodes every weight it uses.

The decode state is ``{"ssm": [...], "kv": KVCache}``: one ``SSMCache``
per mamba layer in a list, where the reference stacks them, and the
groups' KV caches stacked along a leading axis, as the reference's.

``loss`` is the training forward, differentiable by ``torch.autograd``:
each group's mamba layers (``ssm_train``), then the shared block
(``attention_train`` + MLP, the group's gate); then the tail and the mean
CE of each next token.  The shared block's one tree of weights is used by
every group, so autograd sums its 13 calls' gradients (full width) into
one gradient a leaf.  Where the config asks for remat, each mamba layer
and each group runs under ``torch.utils.checkpoint``, as the reference
nests ``jax.checkpoint``.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.policy import QuantPolicy

from . import attention as attn
from .common import (cross_entropy, embed, init_embedding, materialize,
                     param, remat_call, rms_norm, stacked, unembed, unstack)
from .mlp import ffn, init_ffn
from .ssm import (init_ssm, init_ssm_cache, ssm_decode, ssm_prefill,
                  ssm_train)


class ZambaLM:
    """Mamba2 + shared-attention hybrid LM on one device (``None``: the
    card)."""

    def __init__(self, cfg: ModelConfig, policy: QuantPolicy = QuantPolicy(),
                 device=None):
        self.cfg = cfg
        self.policy = policy
        self.device = resolve_device(device)
        self.every = cfg.shared_attn_every
        self.n_groups = cfg.n_layers // self.every
        self.tail = cfg.n_layers - self.n_groups * self.every

    # -- params -----------------------------------------------------------
    def init(self, gen: torch.Generator):
        """f32 parameters on the model's device, drawn from ``gen`` with
        the reference's initializers (see ``DecoderLM.init``)."""
        cfg = self.cfg
        d = (cfg.d_model,)
        mamba = {"ln": param(d, init="zeros"), "ssm": init_ssm(cfg)}
        params = {
            "embed": materialize(init_embedding(cfg.padded_vocab,
                                                cfg.d_model),
                                 gen, self.device),
            "groups": materialize(
                {"mamba": stacked(self.every, mamba),
                 "gate": param(d, init="zeros")},
                gen, self.device, layers=self.n_groups),
        }
        if self.tail:
            params["tail"] = materialize(mamba, gen, self.device,
                                         layers=self.tail)
        params["shared"] = materialize(
            {"ln1": param(d, init="zeros"), "ln2": param(d, init="zeros"),
             "attn": attn.init_attention(cfg), "ffn": init_ffn(cfg)},
            gen, self.device)
        params["final_ln"] = materialize(param(d, init="zeros"), gen,
                                         self.device)
        return params

    # -- training ---------------------------------------------------------
    def _mamba_layer_train(self, lp, x):
        return x + ssm_train(lp["ssm"], rms_norm(x, lp["ln"]), self.cfg)

    def _mamba_train(self, layers, n, x):
        for lp in unstack(layers, n):
            x = remat_call(self.cfg.remat, self._mamba_layer_train, lp, x)
        return x

    def _group_train(self, gp, sp, x):
        x = self._mamba_train(gp["mamba"], self.every, x)
        return self._shared(sp, x, gp["gate"], lambda h: (
            attn.attention_train(sp["attn"], h, self.cfg), None))[0]

    def loss(self, params, batch):
        """(ce, {"ce"}): the mean CE of each next token, f32 scalars."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        x = embed(params["embed"], tokens.long())
        for gp in unstack(params["groups"], self.n_groups):
            x = remat_call(cfg.remat, self._group_train, gp,
                           params["shared"], x)
        if self.tail:
            x = self._mamba_train(params["tail"], self.tail, x)
        x = rms_norm(x, params["final_ln"])
        logits = unembed(params["embed"], x[:, :-1])
        ce = cross_entropy(logits, tokens[:, 1:], cfg.vocab)
        return ce, {"ce": ce}

    # -- blocks -----------------------------------------------------------
    def _shared(self, sp, x, gate, attend):
        """The shared block: ``attend(h) -> (h, cache)`` is the prefill or
        the decode attention of the normed residual stream."""
        h, cache = attend(rms_norm(x, sp["ln1"]))
        x = x + h * (1.0 + gate.to(h.dtype))
        h = rms_norm(x, sp["ln2"])
        return x + ffn(sp["ffn"], h, self.cfg), cache

    def _shared_prefill(self, sp, x, gate, cache):
        return self._shared(sp, x, gate, lambda h: attn.attention_prefill(
            sp["attn"], h, self.cfg, cache))

    def _shared_decode(self, sp, x, gate, cache):
        return self._shared(sp, x, gate, lambda h: attn.attention_decode(
            sp["attn"], h, self.cfg, cache))

    def _mamba_layers(self, params):
        """Every mamba layer's parameters in order, each with the index of
        the group whose shared block follows it (None inside a group)."""
        out = []
        for g, gp in enumerate(unstack(params["groups"], self.n_groups)):
            layers = unstack(gp["mamba"], self.every)
            out += [(lp, None) for lp in layers[:-1]]
            out.append((layers[-1], (g, gp["gate"])))
        if self.tail:
            out += [(lp, None) for lp in unstack(params["tail"], self.tail)]
        return out

    # -- serving ----------------------------------------------------------
    def init_cache(self, batch: int, capacity: int):
        cfg = self.cfg
        return {"ssm": [init_ssm_cache(cfg, batch, self.device)
                        for _ in range(cfg.n_layers)],
                "kv": self._kv_cache(batch, capacity)}

    def _kv_cache(self, batch: int, capacity: int):
        cfg = self.cfg
        return attn.KVCache.create(
            batch, capacity, cfg.n_kv_heads, cfg.resolved_head_dim,
            fmt=self.policy.fmt("kv_cache"), device=self.device,
            layers=self.n_groups)

    def _run(self, params, x, caches, mamba, shared):
        """The layers in order: ``mamba(p, h, i) -> (y, ssm cache)`` on
        each mamba layer ``i``'s normed input, and after each group ``g``
        ``shared(sp, x, gate, kv cache g) -> (x, kv cache)``.  Returns x,
        the SSM caches and the KV caches with their lengths restacked."""
        sp = params["shared"]
        ssm, lengths = [], []
        for i, (lp, group) in enumerate(self._mamba_layers(params)):
            y, c = mamba(lp["ssm"], rms_norm(x, lp["ln"]), i)
            x = x + y
            ssm.append(c)
            if group is not None:
                g, gate = group
                x, kv = shared(sp, x, gate, caches.layer(g))
                lengths.append(kv.length)
        return x, ssm, attn.KVCache(caches.k, caches.v, torch.stack(lengths))

    def prefill(self, params, batch, capacity: Optional[int] = None):
        """Chunked SSD forward that also emits the decode-ready SSM states
        and fills the shared attention's KV caches; returns the last
        position's logits and the decode state."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        B, S = tokens.shape
        x = embed(params["embed"], tokens)
        x, ssm, kv = self._run(
            params, x, self._kv_cache(B, capacity or S),
            lambda p, h, i: ssm_prefill(p, h, cfg), self._shared_prefill)
        x = rms_norm(x, params["final_ln"])
        return unembed(params["embed"], x[:, -1:]), {"ssm": ssm, "kv": kv}

    def decode_step(self, params, tokens, caches):
        """tokens: (B, 1) → next-token logits and the new state (the KV
        caches' storage written in place)."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        x = embed(params["embed"], tokens)
        old = caches["ssm"]
        x, ssm, kv = self._run(
            params, x, caches["kv"],
            lambda p, h, i: ssm_decode(p, h, cfg, old[i]),
            self._shared_decode)
        x = rms_norm(x, params["final_ln"])
        return unembed(params["embed"], x), {"ssm": ssm, "kv": kv}
