"""Driver of closed-loop serving: ``clients`` clients each send a request,
wait for its last token and send the next, through the program's
``ServingEngine`` with one lane (the configuration's weight and KV
formats).

Prompt lengths and output budgets follow the cell's log-normal
(``median``, ``sigma``): each round of requests (a client's k-th) takes
the ``clients`` quantiles at (i + 1/2) / clients once each, dealt out in
a fixed order of the round, so every seed runs the same schedule of
lengths; the seed draws the token ids (uniform over the vocabulary), the
weights and which client takes which schedule.  Greedy, no EOS (each
request runs its whole budget).  Set-up builds the model and the weights
on the card, admits every client's first request (every prompt bucket's
prefill) and runs ``warm_steps`` engine steps; the first requests are
already under way, each with a fixed share of a budget of the round left,
so the window starts near the steady state.  The window then drives
``engine.step`` for ``--seconds``; each token is stamped with the host
clock when the step that made it returns.
"""
from __future__ import annotations

import dataclasses
import math
import time
from statistics import NormalDist
from typing import Dict, List

import numpy as np

from portbench.lib import harness
from portbench.reference import granite_moe as ref


@dataclasses.dataclass
class Req:
    client: int
    prompt: np.ndarray
    budget: int
    times: List[float] = dataclasses.field(default_factory=list)
    tokens: np.ndarray = None


def model_config(cfg: Dict):
    """The program's ``ModelConfig`` from the configuration file, which
    has to state the scales the program runs: none of granite's
    multipliers, attention scaled by 1/sqrt(head_dim)."""
    from repro_torch.configs.base import ModelConfig
    runs = {"embedding_multiplier": 1.0, "residual_multiplier": 1.0,
            "logits_scaling": 1.0, "attention_multiplier":
            (cfg["hidden_size"] // cfg["num_attention_heads"]) ** -0.5}
    off = {k: cfg[k] for k, v in runs.items() if not math.isclose(cfg[k], v)}
    if off:
        raise ValueError(f"the program runs none of granite's multipliers; "
                         f"the configuration states {off}")
    return ModelConfig(
        name=cfg["name"], family="moe",
        n_layers=cfg["num_hidden_layers"], d_model=cfg["hidden_size"],
        n_heads=cfg["num_attention_heads"],
        n_kv_heads=cfg["num_key_value_heads"],
        d_ff=cfg["intermediate_size"], vocab=cfg["vocab_size"],
        rope_theta=float(cfg["rope_theta"]),
        n_experts=cfg["num_local_experts"],
        top_k=cfg["num_experts_per_tok"],
        moe_capacity_factor=float(cfg["moe_capacity_factor"]))


class Run:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg, self.t = cell.config, cell.traffic
        self.attempted = self.failed = 0
        self.done: List[Req] = []

    def _lengths(self) -> None:
        """The quantiles each round deals out, and the budgets left to
        the first requests: a fixed share (spread over (0, 1] by the
        golden ratio) of each budget of the round."""
        n = self.t["clients"]
        z = np.array([NormalDist().inv_cdf((i + 0.5) / n) for i in range(n)])

        def quantiles(spec):
            return np.maximum(1, np.round(
                spec["median"] * np.exp(spec["sigma"] * z))).astype(np.int64)
        self.prompt_set = quantiles(self.t["prompt"])
        self.budget_set = quantiles(self.t["output"])
        share = ((np.arange(n) + 0.5) * 0.6180339887498949) % 1.0
        self.first_set = np.maximum(1, np.ceil(
            self.budget_set * share)).astype(np.int64)
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed % (1 << 63), 6]))
        self.client_of = rng.permutation(n)
        self._rounds: Dict[int, tuple] = {}

    def _round(self, k: int) -> tuple:
        """Round ``k``'s prompt lengths and budgets, one per schedule: the
        same for every seed."""
        r = self._rounds.get(k)
        if r is None:
            rng = np.random.default_rng(np.random.SeedSequence([6, k]))
            r = (rng.permutation(self.prompt_set),
                 rng.permutation(self.first_set if k == 0
                                 else self.budget_set))
            self._rounds[k] = r
        return r

    def _draw(self, client: int, k: int) -> Req:
        prompts, budgets = self._round(k)
        i = self.client_of[client]
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed % (1 << 63), 7, client, k]))
        prompt = rng.integers(0, self.cfg["vocab_size"],
                              int(prompts[i])).astype(np.int32)
        return Req(client, prompt, int(budgets[i]))

    def _submit(self, client: int) -> None:
        k = self.sent[client]
        self.sent[client] += 1
        r = self._draw(client, k)
        rid = self.engine.submit(r.prompt, max_new_tokens=r.budget)
        self.live[rid] = r

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.models import build_model
        from repro_torch.serve import ServeConfig, ServePolicy, ServingEngine
        t, cfg = self.t, self.cfg
        self.mcfg = model_config(cfg)
        policy = ServePolicy(weights=cfg["weights"], kv=cfg["kv_cache"])
        self.model = build_model(self.mcfg, policy.quant_policy(),
                                 device=self.device)
        self.params = ref.make_params(cfg, self.seed, self.device)
        self._lengths()
        self.engine = ServingEngine(
            self.model, self.params,
            ServeConfig(batch_size=t["batch_size"],
                        max_prompt=int(self.prompt_set.max()),
                        max_new_tokens=int(self.budget_set.max()),
                        seed=self.seed % (1 << 31)),
            policy=policy, device=self.device)
        self.lane = policy.lane
        self.sent = [0] * t["clients"]
        self.live: Dict[int, Req] = {}
        for c in range(t["clients"]):
            self._submit(c)
        for _ in range(t["warm_steps"]):
            self._step()
        self.done = []

    def _step(self) -> int:
        """One engine step; stamps its tokens, retires what finished and
        sends each finished client's next request."""
        eng = self.engine
        n = eng.step()
        now = time.perf_counter()
        for s in eng.scheduler.slots.get(self.lane, []):
            if s is not None:
                r = self.live[s.request.rid]
                r.times.extend([now] * (len(s.tokens) - len(r.times)))
        for c in eng.scheduler.pop_completions():
            r = self.live.pop(c.rid)
            r.times.extend([now] * (len(c.tokens) - len(r.times)))
            r.tokens = c.tokens
            self.done.append(r)
            self._submit(r.client)
        return n

    # -- the window -----------------------------------------------------------
    def window(self, seconds: float) -> Dict[str, float]:
        g0 = dataclasses.replace(self.engine.ledger.stats[self.lane])
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self._step()
        t1 = time.perf_counter()
        self.t0, self.t1 = t0, t1
        g1 = self.engine.ledger.stats[self.lane]
        self.ledger = {f.name: getattr(g1, f.name) - getattr(g0, f.name)
                       for f in dataclasses.fields(g1)}
        reqs = self.done + list(self.live.values())
        toks = sum(sum(t0 < x <= t1 for x in r.times) for r in reqs)
        # the gap after a request's first token is left out: its prefill's
        # token and its first decode's come out of one engine step
        gaps = [b - a for r in reqs for a, b in zip(r.times[1:], r.times[2:])
                if t0 < b <= t1]
        self.done = [r for r in self.done if r.times[-1] > t0]
        self.attempted = len(self.done)
        self.failed = sum(len(r.tokens) != r.budget for r in self.done)
        self.gaps = gaps
        return {"tokens_per_s": toks / (t1 - t0),
                "itl_p95_ms": 1e3 * harness.percentile(gaps, 95)}

    # -- tracing --------------------------------------------------------------
    def layer_context(self) -> Dict:
        g = self.ledger
        return {"decode_steps": g["decode_steps"], "decode_s": g["decode_s"],
                "prefills": g["requests"], "prefill_s": g["prefill_s"]}

    def traced_window(self, tr) -> None:
        """``trace_steps`` more engine steps under the profiler; the rows
        and filled positions of each decode step are read from the lane."""
        from portbench import counts
        from portbench.lib.kernel_counts import KernelCounts
        self.counts = KernelCounts()
        lane = self.engine._lanes[self.lane]
        g0 = dataclasses.replace(self.engine.ledger.stats[self.lane])
        step_counts = {"flops": 0.0, "bytes": 0.0, "steps": 0}
        with self.counts:
            for _ in range(self.t["trace_steps"]):
                before = self.engine.ledger.stats[self.lane].decode_tokens
                tr.mark("step")
                self._step()
                rows = self.engine.ledger.stats[self.lane].decode_tokens \
                    - before
                # positions the decoding rows hold after the step's append
                filled = int(lane.ctx[lane.active].sum()) - rows
                if rows:
                    c = counts.moe_decode_step(
                        self.cfg, rows, filled,
                        int(self.cfg["weights"][len("posit"):]),
                        int(self.cfg["kv_cache"][len("posit"):]))
                    step_counts["flops"] += c["flops"]
                    step_counts["bytes"] += c["bytes"]
                    step_counts["steps"] += 1
        tr.close()
        g1 = self.engine.ledger.stats[self.lane]
        self.traced_decode_s = g1.decode_s - g0.decode_s
        self.step_counts = step_counts

    def traced_context(self, tr) -> Dict:
        return {"kernels": self.counts.totals,
                "steps": self.step_counts,
                "traced_decode_s": self.traced_decode_s}

    # -- the check ------------------------------------------------------------
    def release(self) -> None:
        del self.engine, self.model

    def sample(self) -> List[Req]:
        """A seeded sample of the requests finished in the window, the one
        with most served tokens always in it, up to ``check_tokens``
        served tokens."""
        done = sorted(self.done, key=lambda r: -len(r.tokens))
        if not done:
            return []
        rng = np.random.default_rng(np.random.SeedSequence(
            [self.seed % (1 << 63), 11]))
        pick = [done[0]]
        total = len(done[0].tokens)
        for i in rng.permutation(len(done) - 1) + 1:
            if total >= self.t["check_tokens"]:
                break
            pick.append(done[i])
            total += len(done[i].tokens)
        return pick

    def check(self) -> Dict[str, Dict[str, float]]:
        lim = self.cfg["limits"]
        reference = ref.Reference(self.cfg, self.params)
        widest = 0.0
        for r in self.sample():
            g = ref.served_gaps(reference, r.prompt, r.tokens)
            widest = max(widest, float(g.max()))
        got = {"served_logit_gap_max": widest,
               "requests_short": float(self.failed),
               "requests_finished_none": float(not self.done)}
        return {k: {"value": v, "limit": lim[k]} for k, v in got.items()}

    def control(self) -> Dict[str, float]:
        """The widest reference gap of the tokens that the reference in the
        configuration's lower precision (``control``) puts first, at each
        position of the same sampled prompts and served tokens."""
        c = self.cfg["control"]
        full = ref.Reference(self.cfg, self.params)
        low = ref.Reference(self.cfg, self.params, weights=c["weights"],
                            kv=c["kv"])
        widest = 0.0
        for r in self.sample():
            widest = max(widest, float(
                ref.control_gaps(full, low, r.prompt, r.tokens).max()))
        return {"served_logit_gap_max": widest}
