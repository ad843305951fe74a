"""Continuous-batching serving engine over posit KV caches — the
counterpart of ``repro.serve.engine`` on one device (``None``: the card).

The engine owns one "lane" per ``ServePolicy`` (shared quantized weights,
a per-row-length stacked KV cache), the ``Scheduler`` owns admission and
slot lifecycle, and the ``TokenLedger`` prices every token (wall time +
nJ, with the KV traffic term at the lane's storage width).

Request flow: ``submit()`` → scheduler queue → ``step()`` admits into a
free slot (B=1 right-padded prefill, rows installed into the lane cache in
place), then one batched decode per lane per step; EOS/budget retires the
slot into a bounded completion queue while the other rows keep decoding.

Sampling: greedy tokens equal the reference's.  A sampled token draws
Gumbel noise from a CPU ``torch.Generator`` seeded from (engine seed,
rid, step), so repeated prompts on one engine draw distinct streams and
the same seed reproduces them, but the draws are not ``jax.random``'s:
sampled tokens differ from the reference's.

Observability mirrors the stream engine's: a metrics registry the
``TokenLedger`` is bound into (``bind_serving_engine``), the reference's
program-cache probes (``jit_programs_total`` counts one decode callable per
lane and one prefill shape per (lane, prompt bucket); ``jit_cache_hits_total``
the prefills that reuse a bucket), and an optional tracer with the
engine's span tree from host stamps: each ``step`` with its admissions
(and their prefills), decodes and per-row accounting, the model's
layers inside a prefill or decode (``obs/trace.py``), and retire
instants.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.core.device import resolve_device
from repro_torch.core.formats import get_format
from repro_torch.core.policy import QuantPolicy
from repro_torch.core.quant import quantize_params
from repro_torch.models.attention import KVCache
from repro_torch.models.common import to_device
from repro_torch.obs import MetricsRegistry, bind_serving_engine
from repro_torch.obs.trace import span, traced
from repro_torch.stream.engine import bucket_size

from .accounting import (TokenLedger, kv_traffic_bytes, prefill_energy_nj,
                         token_energy_nj)
from .policy import ServePolicy
from .scheduler import Completion, Request, Scheduler


@dataclasses.dataclass
class ServeConfig:
    batch_size: int = 8          # slots per precision lane
    max_prompt: int = 128
    max_new_tokens: int = 32     # per-request default budget
    temperature: float = 0.0     # 0 → greedy
    seed: int = 0                # engine sampling root (with rid, step)
    max_completions: Optional[int] = 256  # drop-oldest completion backlog


def sample_token(lv: torch.Tensor, temperature: float, seed: int, rid: int,
                 step: int) -> int:
    """One categorical draw from the logits row ``lv`` at ``temperature``
    (Gumbel-max), with noise from a generator seeded by (seed, rid, step)."""
    state = np.random.SeedSequence([seed, rid, step]).generate_state(
        1, np.uint64)[0]
    gen = torch.Generator().manual_seed(int(state))
    u = torch.rand(lv.shape, generator=gen, dtype=torch.float32)
    gumbel = -torch.log(-torch.log(
        torch.clamp(u, min=torch.finfo(torch.float32).tiny)))
    return int(torch.argmax(lv.cpu().to(torch.float32) / temperature
                            + gumbel))


def _install(big: KVCache, small: KVCache, slot: int) -> None:
    """Copy the B=1 rows of ``small`` into row ``slot`` of ``big``, in
    place: every leaf is (L, B, ...)."""
    for b, s in ((big.k, small.k), (big.v, small.v)):
        KVCache._raw(b)[:, slot] = KVCache._raw(s)[:, 0]
    big.length[:, slot] = small.length[:, 0]


class _Lane:
    """Device state of one precision lane: model + quantized params +
    stacked per-row caches + per-slot host bookkeeping."""

    def __init__(self, engine: "ServingEngine", sp: ServePolicy):
        cfg = engine.model.cfg
        self.policy = sp
        self.model = type(engine.model)(cfg, sp.quant_policy(),
                                        device=engine.device)
        self.params = engine._params_for(sp.weights)
        B = engine.cfg.batch_size
        self.capacity = engine.cfg.max_prompt + engine.cfg.max_new_tokens
        self.caches = self.model.init_cache(B, self.capacity, per_row=True)
        self.cur = torch.zeros((B,), dtype=torch.int64, device=engine.device)
        # host-side per-slot metadata
        self.rids = np.zeros((B,), np.int64)
        self.steps = np.zeros((B,), np.int64)
        self.temps = np.zeros((B,), np.float32)
        self.active = np.zeros((B,), bool)
        self.ctx = np.zeros((B,), np.int64)  # valid cache length per row
        self._seen_ppad: set = set()  # prompt buckets already prefilled
        # lane creation builds exactly one decode callable per lane
        engine.metrics.counter(
            "jit_programs_total", "compiled programs by site").inc(
                site="serve.decode", lane=sp.lane)

    def decode(self, seed: int) -> np.ndarray:
        """One batched decode step: next token per row (greedy, or sampled
        for rows with a temperature); inactive rows decode garbage and
        keep their lengths, so the next occupant's install starts clean."""
        vocab = self.model.cfg.vocab
        logits, new = self.model.decode_step(self.params, self.cur[:, None],
                                             self.caches)
        with span("serve", "serve.sample"):
            lv = logits[:, -1, :vocab].to(torch.float32)
            nxt = torch.argmax(lv, dim=-1)
            active = torch.from_numpy(self.active).to(lv.device)
            self.caches = KVCache(new.k, new.v, torch.where(
                active, new.length, self.caches.length))
            toks = nxt.cpu().numpy()
            for i in np.flatnonzero(self.active & (self.temps > 0)):
                toks[i] = sample_token(lv[i], float(self.temps[i]), seed,
                                       int(self.rids[i]), int(self.steps[i]))
        self.cur = torch.from_numpy(toks).to(lv.device)
        return toks


_RECURRENT = ("its prefill takes no per-row prompt lengths, and its "
              "recurrent state is not the per-row KV cache the slots "
              "install into")
# families whose model API the engine's admission and per-row caches do not
# fit, with the reason (the reference's engine fails on each of them)
_NOT_SERVED = {
    "vlm": "its prefill refuses the per-row prompt lengths that admission "
           "passes (patch rows would shift each row's token offsets)",
    "encdec": "its self-attention cache has one length for every row, not "
              "the per-row lengths of the engine's slots",
    "ssm": _RECURRENT,
    "hybrid": _RECURRENT,
}


class ServingEngine:
    """Multi-lane continuous-batching engine on one device.

    ``policy`` may be a ``ServePolicy`` or a ``QuantPolicy`` — it sets the
    default lane for ``submit``/``generate``; per-request policies open
    further lanes.  ``params`` is the model's raw (f32) tree; it is kept,
    and quantized once per weight format.  ``metrics`` (``None``: a
    private registry; ``NULL_METRICS``: off) and ``tracer`` (default off)
    are the observability plane, as on the stream engine.
    """

    def __init__(self, model, params, cfg: ServeConfig,
                 policy: Union[ServePolicy, QuantPolicy] = None,
                 device=None, metrics=None, tracer=None):
        family = model.cfg.family
        if family in _NOT_SERVED:
            raise NotImplementedError(
                f"ServingEngine does not serve the {family!r} family: "
                f"{_NOT_SERVED[family]}, as the reference's engine fails on "
                f"it; call the model's prefill and decode_step (ROADMAP.md, "
                f"queue A item A3)")
        self.device = resolve_device(device)
        self.model = model
        self.cfg = cfg
        if policy is None:
            policy = ServePolicy(weights=None, kv=None)
        elif isinstance(policy, QuantPolicy):
            policy = ServePolicy.from_quant_policy(policy)
        self.policy = policy
        self._raw_params = to_device(params, self.device)
        self._quantized: Dict[Optional[str], object] = {}
        self._lanes: Dict[str, _Lane] = {}
        self.ledger = TokenLedger()
        self.metrics = MetricsRegistry() if metrics is None else metrics
        self.tracer = tracer
        bind_serving_engine(self.metrics, self)
        self._jit_programs = self.metrics.counter(
            "jit_programs_total", "compiled programs by site")
        self._jit_hits = self.metrics.counter(
            "jit_cache_hits_total", "compiled-program cache hits by site")
        self.scheduler = Scheduler(cfg.batch_size, cfg.max_completions,
                                   metrics=self.metrics)

    # -- params -----------------------------------------------------------
    def _params_for(self, weights_fmt: Optional[str]):
        """Quantize the raw weights once per storage format; lanes that
        share a weights format share one device copy."""
        if weights_fmt not in self._quantized:
            p = self._raw_params
            if weights_fmt is not None:
                p = quantize_params(p, get_format(weights_fmt),
                                    cast_rest=torch.bfloat16)
            self._quantized[weights_fmt] = p
        return self._quantized[weights_fmt]

    def _lane(self, sp: ServePolicy) -> _Lane:
        if sp.lane not in self._lanes:
            self._lanes[sp.lane] = _Lane(self, sp)
        return self._lanes[sp.lane]

    # -- request API ------------------------------------------------------
    def submit(self, prompt, max_new_tokens: Optional[int] = None,
               temperature: Optional[float] = None,
               eos_id: Optional[int] = None,
               policy: Optional[ServePolicy] = None) -> int:
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if len(prompt) == 0 or len(prompt) > self.cfg.max_prompt:
            raise ValueError(f"prompt length {len(prompt)} outside "
                             f"(0, {self.cfg.max_prompt}]")
        req = Request(
            rid=-1, prompt=prompt,
            max_new_tokens=min(max_new_tokens or self.cfg.max_new_tokens,
                               self.cfg.max_new_tokens),
            temperature=(self.cfg.temperature if temperature is None
                         else temperature),
            eos_id=eos_id, policy=policy or self.policy)
        return self.scheduler.submit(req)

    # -- admission: B=1 ragged prefill, install rows into the lane --------
    def _admit(self, req: Request, slot: int) -> None:
        lane = self._lane(req.policy)
        P = len(req.prompt)
        P_pad = bucket_size(P, self.cfg.max_prompt)
        # one prefill shape per (lane, prompt bucket): count new buckets vs
        # reuses, so a bucketing regression shows up as a metric
        if P_pad not in lane._seen_ppad:
            lane._seen_ppad.add(P_pad)
            self._jit_programs.inc(site="serve.prefill", lane=req.policy.lane)
        else:
            self._jit_hits.inc(site="serve.prefill", lane=req.policy.lane)
        toks = np.zeros((1, P_pad), np.int64)
        toks[0, :P] = req.prompt  # right-pad; lengths mask the tail
        with span("serve", "serve.prefill", rid=req.rid, P=P, P_pad=P_pad,
                  slot=slot) as sp:
            t0 = time.perf_counter()
            logits, new_caches = lane.model.prefill(
                lane.params,
                {"tokens": torch.from_numpy(toks).to(self.device),
                 "lengths": torch.tensor([P], dtype=torch.int32,
                                         device=self.device)},
                lane.capacity)
            _install(lane.caches, new_caches, slot)
            # the first token comes from the prefill logits (step 0)
            with span("serve", "serve.sample"):
                lv = logits[0, -1, :self.model.cfg.vocab].to(torch.float32)
                if req.temperature > 0:
                    tok = sample_token(lv, req.temperature, self.cfg.seed,
                                       req.rid, 0)
                else:
                    tok = int(torch.argmax(lv))  # waits for the install too
            t1 = time.perf_counter()
            sp.at(t0, t1)
        self.ledger.record_prefill(
            req.policy.lane, P, t1 - t0,
            prefill_energy_nj(self.model.cfg, P, req.policy))
        if self.scheduler.on_token(req.policy.lane, slot, tok):
            if self.tracer is not None:
                self.tracer.instant("serve", "serve.retire",
                                    track=f"lane:{req.policy.lane}",
                                    args={"rid": req.rid, "slot": slot})
            return
        lane.cur[slot] = tok
        lane.rids[slot] = req.rid
        lane.steps[slot] = 1
        lane.temps[slot] = req.temperature
        lane.active[slot] = True
        lane.ctx[slot] = P

    # -- one engine tick --------------------------------------------------
    @traced("serve", "serve.step")
    def step(self) -> int:
        """Admit what fits, then run one batched decode step per active
        lane.  Returns the number of real tokens emitted."""
        tr = self.tracer
        for req, slot in self.scheduler.take_admissions():
            with span("serve", "serve.admit", lane=req.policy.lane,
                      rid=req.rid, slot=slot):
                self._admit(req, slot)
        emitted = 0
        for lane_name in self.scheduler.active_lanes():
            lane = self._lanes[lane_name]
            rows = self.scheduler.active_rows(lane_name)
            lane.active[:] = False
            lane.active[rows] = True
            with span("serve", "serve.decode", lane=lane_name,
                      rows=len(rows)) as sp:
                t0 = time.perf_counter()
                toks = lane.decode(self.cfg.seed)   # ends on a host copy
                wall = time.perf_counter() - t0
                sp.at(t0, t0 + wall)
            with span("serve", "serve.account", lane=lane_name,
                      rows=len(rows)):
                energy = 0.0
                kv_read = 0.0
                for i in rows:
                    lane.ctx[i] += 1
                    energy += token_energy_nj(self.model.cfg,
                                              int(lane.ctx[i]), lane.policy)
                    kv_read += kv_traffic_bytes(self.model.cfg,
                                                int(lane.ctx[i]),
                                                lane.policy.kv_bits)[0]
                    lane.steps[i] += 1
                    if self.scheduler.on_token(lane_name, i, int(toks[i])):
                        lane.active[i] = False
                        if tr is not None:
                            tr.instant("serve", "serve.retire",
                                       track=f"lane:{lane_name}",
                                       args={"rid": int(lane.rids[i]),
                                             "slot": int(i)})
                emitted += len(rows)
                self.ledger.record_decode(
                    lane_name, len(rows), self.cfg.batch_size - len(rows),
                    wall, energy, kv_read)
        return emitted

    def run(self) -> List[Completion]:
        """Drive steps until every submitted request has finished."""
        while not self.scheduler.idle:
            self.step()
        return self.scheduler.pop_completions()

    # -- legacy contract --------------------------------------------------
    def generate(self, prompts: List[np.ndarray]) -> List[np.ndarray]:
        """Decode a batch of prompts, outputs in input order."""
        rids = [self.submit(p) for p in prompts]
        by_rid = {c.rid: c.tokens for c in self.run()}
        return [by_rid[r] for r in rids]
