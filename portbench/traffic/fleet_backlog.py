"""Driver of a fleet backlog: many patients' short uploads offered at once.

The cell's patients (half cough, half ECG, each ``windows`` windows) are
made at set-up from the seed, cut into ragged chunks and interleaved in a
seeded order.  The window replays that set pass after pass, each under
fresh patient ids: every chunk ingested (the engine dispatches whenever a
group fills ``max_batch``), then ``drain``, then each stream's tracker
finalized and released.  Set-up runs one pass, which builds every kernel
and warms every batch shape the passes use.  The rate is all windows
scored over all the time of the whole passes run.  Every pass's results
are tallied by (patient, window): a window missing, scored twice or
scored for no stream breaks the configuration's guarantee
(``windows_unscored``).
"""
from __future__ import annotations

import collections
import sys
import time
from typing import Dict, List

import numpy as np

from portbench.lib import fleet


class Run:
    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        self.cfg, self.t = cell.config, cell.traffic
        self.attempted = self.failed = 0
        self.passes = 0
        self.unscored = 0
        self.answers: List[Dict[int, fleet.Answer]] = []

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        t = self.t
        n = t["patients"]
        self.rec = fleet.make_recordings(self.seed, n // 2, n - n // 2,
                                         t["windows"], t["cough_pool"])
        self.trees = fleet.train_forest(self.cfg, self.seed, self.device)
        self.schedule = fleet.ragged_schedule(self.rec, self.seed,
                                              t["chunks"])
        self.engine = fleet.build_engine(self.cfg, self.trees,
                                         t["max_batch"], self.device)
        self._pass("warm")
        self.engine.reset()

    def _pass(self, tag: str, wanted: Dict[str, int] = None, tick=None):
        """One pass of the whole backlog under ids ``tag-...``: returns the
        sampled patients' answers and the pass's results."""
        import torch
        eng, rec = self.engine, self.rec
        names = [fleet.pid(tag, p, rec)
                 for p in range(rec.n_cough + rec.n_ecg)]
        for k, (p, task, mod, chunk) in enumerate(self.schedule):
            eng.ingest(names[p], task, mod, chunk)
            if tick is not None and k % 64 == 0:
                tick("ingest")
        if tick is not None:
            tick("drain")
        eng.drain()
        if tick is not None:
            tick("finalize")
        tails = {}
        for p, name in enumerate(names):
            task = "cough" if p < rec.n_cough else "rpeak"
            if task == "rpeak":
                tails[p] = eng.finalize_patient(name, task)
            eng.release_patient(name, task)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        results = eng.pop_results()
        if not wanted:
            return {}, results
        got = fleet.collect(results, wanted)
        for p, a in got.items():
            a.tail = tails.get(p)
        return got, results

    def _unscored(self, tag: str, results) -> int:
        """Windows of pass ``tag`` not scored exactly once: each due
        (patient, window) missing or repeated, and each result for none."""
        seen = collections.Counter((r.patient, r.widx) for r in results)
        rec, w = self.rec, self.t["windows"]
        due = [(fleet.pid(tag, p, rec), i)
               for p in range(rec.n_cough + rec.n_ecg) for i in range(w)]
        bad = sum(abs(seen.pop(key, 0) - 1) for key in due)
        return bad + sum(seen.values())

    def _sample(self, k: int) -> Dict[str, int]:
        """The patients of pass ``k`` whose answers are checked: a seeded
        draw of each kind."""
        rng = fleet.seed_seq(self.seed, 10, k)
        rec, t = self.rec, self.t
        c = rng.choice(rec.n_cough, min(t["check_cough"], rec.n_cough),
                       replace=False)
        e = rec.n_cough + rng.choice(rec.n_ecg, min(t["check_ecg"],
                                                    rec.n_ecg),
                                     replace=False)
        tag = f"p{k}"
        return {fleet.pid(tag, int(p), rec): int(p)
                for p in np.concatenate([c, e])}

    # -- the window -----------------------------------------------------------
    def window(self, seconds: float) -> Dict[str, float]:
        per_pass = self.rec.n_cough * self.t["windows"] \
            + self.rec.n_ecg * self.t["windows"]
        scored = 0
        t0 = time.perf_counter()
        self.pass_s = []
        while True:
            k = self.passes
            tp = time.perf_counter()
            ans, results = self._pass(f"p{k}", self._sample(k) if k
                                      < self.t["check_passes"] else None)
            self.pass_s.append(time.perf_counter() - tp)
            n = len(results)
            self.passes += 1
            if ans:
                self.answers.append(ans)
            scored += n
            u = self._unscored(f"p{k}", results)
            self.unscored += u
            self.attempted += per_pass
            self.failed += u
            if time.perf_counter() - t0 >= seconds:
                break
        self.wall = time.perf_counter() - t0
        print("portbench: passes " + " ".join(f"{x:.2f}" for x in
                                              self.pass_s) + " s",
              file=sys.stderr)
        self.ledger = {k: v for k, v in self.engine.ledger.stats.items()}
        return {"windows_per_s": scored / self.wall}

    # -- tracing --------------------------------------------------------------
    def layer_context(self) -> Dict:
        st = self.ledger
        by_task: Dict[str, int] = {}
        for (task, _), g in st.items():
            by_task[task] = by_task.get(task, 0) + g.windows
        return {"dispatches": sum(g.batches for g in st.values()),
                "dispatch_s": sum(g.latency_s for g in st.values()),
                "windows": sum(g.windows for g in st.values()),
                "padded": sum(g.padded_windows for g in st.values()),
                "windows_by_task": by_task, "cfg": self.cfg}

    def traced_window(self, tr) -> None:
        """One more pass, traced until ``trace_seconds`` have passed (the
        rest of the pass runs untraced)."""
        from portbench.lib.kernel_counts import KernelCounts
        self.counts = KernelCounts()
        limit = self.t["trace_seconds"]

        def tick(what):
            # past ``limit``, close once the window holds a call of each
            # kernel the readers time.  The cough dispatches come in
            # bursts, and how late the first comes depends on the seed's
            # order and the host's speed, so there is no earlier cut: at
            # the latest the pass's drain dispatches the rest.
            if tr.open:
                tr.mark(what)
                k = self.counts.totals
                if time.perf_counter() - tr.t0 >= limit \
                        and k["posit_fft_stages"]["calls"] \
                        and k["posit_matmul_round"]["calls"]:
                    self.counts.stop()
                    tr.close()

        with self.counts:
            _, results = self._pass("traced", None, tick)
        tr.close()
        self.traced_windows = sum(r.done_wall <= tr.closed_at
                                  for r in results)
        k = self.counts.totals
        print(f"portbench: traced {tr.window_s:.2f} s, "
              f"{len(tr.events)} device events, "
              f"{k['posit_fft_stages']['calls']} FFT and "
              f"{k['posit_matmul_round']['calls']} matmul calls, "
              f"{self.traced_windows} windows", file=sys.stderr)

    def traced_context(self, tr) -> Dict:
        return {"kernels": self.counts.totals, "cfg": self.cfg,
                "traced_windows": self.traced_windows}

    # -- the check ------------------------------------------------------------
    def release(self) -> None:
        del self.engine

    def check(self) -> Dict[str, Dict[str, float]]:
        got = fleet.compare(self.cfg, self.trees, self.rec, self.answers,
                            self.t["windows"], self.device)
        got["windows_unscored"] = float(self.unscored)
        lim = self.cfg["limits"]
        return {k: {"value": v, "limit": lim[k]} for k, v in got.items()}

    def control(self) -> Dict[str, float]:
        """The compared numbers of the reference put in the program's
        place in the configuration's lower precision (``control``)."""
        c = self.cfg["control"]
        return fleet.compare(self.cfg, self.trees, self.rec, self.answers,
                             self.t["windows"], self.device,
                             cough_fmt=c["cough"], ecg_base=c["rpeak"])
