"""xLSTM LM: groups of 7 mLSTM + 1 sLSTM blocks — the counterpart of
``repro.models.xlstm_model.XLSTMLM``.

The parameters keep the reference's names and shapes: ``groups`` holds
each group's ``mlstm`` stack (n_groups, 7, ...) and ``slstm`` block
(n_groups, ...); Python loops over the groups and layers replace the
two-level ``lax.scan``.  The family has no KV cache: the decode state is
``{"mlstm": [[MLSTMCache] * 7] * n_groups, "slstm": [SLSTMCache] *
n_groups}``, lists where the reference stacks.

``loss`` is the training forward, differentiable by ``torch.autograd``:
the chunked mLSTM (``mlstm_train``, each block under
``torch.utils.checkpoint`` where the config asks for remat) and the
sLSTM's Python loop over time (``slstm_train``), then the mean CE of each
next token.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.device import resolve_device
from repro_torch.core.policy import QuantPolicy

from .common import (cross_entropy, embed, init_embedding, materialize,
                     param, remat_call, rms_norm, stacked, unembed, unstack)
from .xlstm import (init_mlstm, init_mlstm_cache, init_slstm,
                    init_slstm_cache, mlstm_decode, mlstm_forward,
                    mlstm_train, slstm_decode, slstm_forward, slstm_train)

GROUP = 8  # 7 mLSTM + 1 sLSTM per group


class XLSTMLM:
    """xLSTM LM on one device (``None``: the card)."""

    def __init__(self, cfg: ModelConfig, policy: QuantPolicy = QuantPolicy(),
                 device=None):
        if cfg.n_layers % GROUP:
            raise ValueError(f"XLSTMLM: {cfg.n_layers} layers are not whole "
                             f"groups of {GROUP}")
        self.cfg = cfg
        self.policy = policy
        self.device = resolve_device(device)
        self.n_groups = cfg.n_layers // GROUP

    # -- params -----------------------------------------------------------
    def init(self, gen: torch.Generator):
        """f32 parameters on the model's device, drawn from ``gen`` with
        the reference's initializers (see ``DecoderLM.init``)."""
        cfg = self.cfg
        d = (cfg.d_model,)
        group = {
            "mlstm": stacked(GROUP - 1, {"ln": param(d, init="zeros"),
                                         "cell": init_mlstm(cfg)}),
            "slstm": {"ln": param(d, init="zeros"), "cell": init_slstm(cfg)},
        }
        return {
            "embed": materialize(init_embedding(cfg.padded_vocab,
                                                cfg.d_model),
                                 gen, self.device),
            "groups": materialize(group, gen, self.device,
                                  layers=self.n_groups),
            "final_ln": materialize(param(d, init="zeros"), gen,
                                    self.device),
        }

    def loss(self, params, batch):
        """(ce, {"ce"}): the mean CE of each next token, f32 scalars."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device)
        x, _ = self._run(
            params, embed(params["embed"], tokens.long()),
            lambda p, h, g, j: (remat_call(cfg.remat, mlstm_train, p, h,
                                           cfg), None),
            lambda p, h, g: (slstm_train(p, h, cfg), None))
        logits = unembed(params["embed"], x[:, :-1])
        ce = cross_entropy(logits, tokens[:, 1:], cfg.vocab)
        return ce, {"ce": ce}

    # -- forward ----------------------------------------------------------
    def _run(self, params, x, mlstm, slstm):
        """Every group in order: ``mlstm(cell, h, g, j) -> (y, cache)`` on
        each mLSTM block's normed input, then ``slstm(cell, h, g)``.
        Returns the final-normed x and the caches."""
        mc, sc = [], []
        for g, gp in enumerate(unstack(params["groups"], self.n_groups)):
            caches = []
            for j, lp in enumerate(unstack(gp["mlstm"], GROUP - 1)):
                y, c = mlstm(lp["cell"], rms_norm(x, lp["ln"]), g, j)
                x = x + y
                caches.append(c)
            y, c = slstm(gp["slstm"]["cell"],
                         rms_norm(x, gp["slstm"]["ln"]), g)
            x = x + y
            mc.append(caches)
            sc.append(c)
        return rms_norm(x, params["final_ln"]), {"mlstm": mc, "slstm": sc}

    # -- serving ----------------------------------------------------------
    def init_cache(self, batch: int, capacity: int = 0):
        cfg = self.cfg
        return {"mlstm": [[init_mlstm_cache(cfg, batch, self.device)
                           for _ in range(GROUP - 1)]
                          for _ in range(self.n_groups)],
                "slstm": [init_slstm_cache(cfg, batch, self.device)
                          for _ in range(self.n_groups)]}

    def prefill(self, params, batch, capacity: Optional[int] = None):
        """The chunked forward over the prompt; returns the last
        position's logits and the decode state (``capacity`` is unused:
        the state does not grow)."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        x, caches = self._run(
            params, embed(params["embed"], tokens),
            lambda p, h, g, j: mlstm_forward(p, h, cfg),
            lambda p, h, g: slstm_forward(p, h, cfg))
        return unembed(params["embed"], x[:, -1:]), caches

    def decode_step(self, params, tokens, caches):
        """tokens: (B, 1) → next-token logits and the new state."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        old = caches
        x, caches = self._run(
            params, embed(params["embed"], tokens),
            lambda p, h, g, j: mlstm_decode(p, h, cfg, old["mlstm"][g][j]),
            lambda p, h, g: slstm_decode(p, h, cfg, old["slstm"][g]))
        return unembed(params["embed"], x), caches
