"""Deterministic, shardable, resumable synthetic LM token pipeline — the
counterpart of ``repro.data.tokens``: the reference's numpy code, batches
returned as ``torch.int32`` on the CPU (the model moves them to its
device).

Every batch is a pure function of (seed, step): restart/resume needs only
the step counter from the checkpoint, and each data-parallel host can
materialize exactly its shard (``host_slice``) without coordination.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class TokenPipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    # markov-ish structure so a small LM has something to learn
    n_states: int = 64


class TokenPipeline:
    def __init__(self, cfg: TokenPipelineConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        # fixed sparse transition structure: each state prefers 4 tokens
        self._emit = rng.integers(0, cfg.vocab,
                                  size=(cfg.n_states, 4)).astype(np.int32)
        self._next = rng.integers(0, cfg.n_states,
                                  size=(cfg.n_states, 4)).astype(np.int32)

    def batch_at(self, step: int,
                 host_slice: Optional[slice] = None
                 ) -> Dict[str, torch.Tensor]:
        cfg = self.cfg
        B = cfg.global_batch
        rows = range(B)[host_slice] if host_slice else range(B)
        out = np.empty((len(rows), cfg.seq_len), np.int32)
        for i, r in enumerate(rows):
            rng = np.random.default_rng(
                (cfg.seed * 1_000_003 + step) * 131_071 + r)
            state = rng.integers(0, cfg.n_states)
            choices = rng.integers(0, 4, size=cfg.seq_len)
            toks = np.empty(cfg.seq_len, np.int32)
            for t in range(cfg.seq_len):
                toks[t] = self._emit[state, choices[t]]
                state = self._next[state, choices[t]]
            out[i] = toks
        return {"tokens": torch.from_numpy(out)}

    def __iter__(self) -> Iterator[Dict[str, torch.Tensor]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
