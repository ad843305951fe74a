"""R-peak detection in plain posit arithmetic: BayeSlope's window scores
(stages 1-2), the cross-window tracker (stages 3-4) and the precision
router's quality-feedback escalation, replayed for one patient.

A frozen copy of the port's ``apps/bayeslope.py`` (``enhance``,
``glf_normalize``, the reservoir, the warm-started 2-means threshold,
``stitch_peaks``, ``recover_gaps``, ``RPeakFold``), ``apps/kmeans.py``,
``stream/tracker.py``'s quality signal and ``stream/router.py``'s
escalation ladder, with every op through this package's ``Arith``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .arith import Arith

ECG_FS = 250
REFRACTORY_S = 0.22
RESERVOIR_SIZE = 500
RESERVOIR_STRIDE = 5
RR_BOOT = 8
TAIL_MAX_S = 8.0
PEAK_THRESHOLD = 0.5       # the pipeline's candidate count
COUNT_REFRACTORY_S = 0.1


def enhance(ar: Arith, sig: torch.Tensor) -> torch.Tensor:
    x = ar.rnd(sig)
    n = x.shape[-1]
    d = ar.sub(x[..., 1:], x[..., :-1])
    ad = torch.abs(d)
    enh = ar.mul(ad[..., :-1], ad[..., 1:])
    enh = torch.cat([enh[..., :1], enh, enh[..., -1:]], dim=-1)
    K = 25
    contrib = ar.div(enh, float(K))
    zeros = torch.zeros((*enh.shape[:-1], K - 1), dtype=enh.dtype,
                        device=enh.device)
    pad = torch.cat([zeros, contrib], dim=-1)
    acc = pad[..., :n] * 0.0
    for i in range(K):
        acc = ar.add(acc, pad[..., i: i + n])
    return acc


def glf_normalize(ar: Arith, enh: torch.Tensor) -> torch.Tensor:
    mu = ar.mean(enh, axis=-1)
    scale = torch.clamp(mu, min=1e-12)[..., None]
    z = ar.div(enh, scale)
    e = ar.exp(torch.clamp(ar.sub(1.0, z), -30.0, 30.0))
    return ar.div(1.0, ar.add(1.0, e))


def window_scores(fmt: str, windows: torch.Tensor) -> torch.Tensor:
    """(B, n) ECG windows → (B, n) GLF scores in ``fmt``."""
    ar = Arith.make(fmt)
    return glf_normalize(ar, enhance(ar, windows))


def peak_counts(scores: torch.Tensor, fs: int = ECG_FS) -> torch.Tensor:
    """The pipeline's per-window candidate count: above threshold and the
    maximum of its ±refractory neighbourhood (≥ to the past, > to the
    future)."""
    refr = max(int(round(COUNT_REFRACTORY_S * fs)), 1)
    is_peak = scores > PEAK_THRESHOLD
    B = scores.shape[0]
    ones = torch.ones((B, 1), dtype=torch.bool, device=scores.device)
    for d in range(1, refr + 1):
        edge = ones.expand(B, d)
        ge_past = torch.cat([edge, scores[:, d:] >= scores[:, :-d]], dim=1)
        gt_future = torch.cat([scores[:, :-d] > scores[:, d:], edge], dim=1)
        is_peak &= ge_past & gt_future
    return is_peak.sum(dim=1).to(torch.int32)


def kmeans_1d(ar: Arith, x: torch.Tensor, k: int = 2, iters: int = 12,
              init: torch.Tensor = None) -> torch.Tensor:
    x = ar.rnd(x)
    if init is not None:
        cent = ar.rnd(torch.as_tensor(init, device=x.device).to(x.dtype))
    else:
        lo, hi = torch.min(x), torch.max(x)
        frac = torch.arange(k, dtype=x.dtype, device=x.device) / max(k - 1, 1)
        cent = lo + (hi - lo) * frac
        if k > 1:
            cent[-1] = hi
        cent = ar.rnd(cent)
    for _ in range(iters):
        d = torch.abs(ar.sub(x[:, None], cent[None, :]))
        assign = torch.argmin(d, dim=1)
        new = []
        for j in range(k):
            m = assign == j
            cnt = torch.clamp(m.sum(), min=1).to(x.dtype)
            contrib = ar.div(torch.where(m, x, torch.zeros_like(x)), cnt)
            new.append(ar.sum(contrib, axis=-1))
        cent = torch.stack(new)
    return cent


def stitch_peaks(e, start, committed, commit_to, end, thr, refractory,
                 taken: List[int]) -> List[int]:
    lo = max(committed, 1)
    hi = min(commit_to, end - 1)
    if hi <= lo or not np.isfinite(thr):
        return []
    idx = np.arange(lo, hi)
    v = e[idx - start]
    is_max = (v > thr) & (v >= e[idx - start - 1]) & (v >= e[idx - start + 1])
    cand = idx[is_max]
    if not len(cand):
        return []
    order = cand[np.argsort(-e[cand - start], kind="stable")]
    accepted: List[int] = []
    for p in order:
        p = int(p)
        if any(p - refractory <= q < p + refractory for q in taken):
            continue
        taken.append(p)
        accepted.append(p)
    accepted.sort()
    return accepted


def recover_gaps(e, start, out: List[int], nxt: int, rr: float, thr: float,
                 refractory: int) -> float:
    gap = nxt - out[-1]
    while gap > 1.55 * rr:
        expect = out[-1] + rr
        lo = int(max(out[-1] + refractory, expect - 0.4 * rr))
        hi = int(min(nxt - refractory, expect + 0.4 * rr))
        lo = max(lo, start)
        hi = min(hi, start + len(e))
        if hi <= lo:
            break
        t = np.arange(lo, hi)
        prior = np.exp(-((t - expect) ** 2) / (2 * (0.3 * rr) ** 2))
        j = int(np.argmax(e[lo - start: hi - start] * prior))
        p = lo + j
        if np.isfinite(thr) and e[p - start] > 0.25 * thr:
            out.append(p)
            rr = 0.8 * rr + 0.2 * (out[-1] - out[-2])
            gap = nxt - out[-1]
        else:
            break
    out.append(nxt)
    if len(out) >= 2:
        rr = 0.8 * rr + 0.2 * min(nxt - out[-2], 1.5 * rr)
    return rr


class Fold:
    """BayeSlope stages 3-4 across windows (the port's ``RPeakFold``)."""

    def __init__(self, device, fs: int = ECG_FS):
        self.device = device
        self.refractory = int(REFRACTORY_S * fs)
        self.tail_max = int(TAIL_MAX_S * fs)
        self.reservoir = np.zeros(0, np.float32)
        self.cents: Optional[np.ndarray] = None
        self.thr = float("nan")
        self.tail = np.zeros(0, np.float64)
        self.tail_start = 0
        self.end = 0
        self.committed = 0
        self.taken: List[int] = []
        self.pending: List[int] = []
        self.out: List[int] = []
        self.rr: Optional[float] = None
        self.emitted = 0
        self.finalized = False

    def _threshold(self, ar: Arith) -> None:
        x = torch.as_tensor(self.reservoir, dtype=torch.float32,
                            device=self.device)
        init = (None if self.cents is None else
                torch.as_tensor(self.cents, dtype=torch.float32,
                                device=self.device))
        cents = kmeans_1d(ar, x, k=2, init=init).cpu().numpy().astype(
            np.float32)
        c = np.sort(np.asarray(cents, np.float64))
        thr = 0.3 * c[0] + 0.7 * c[1]
        self.thr = float(thr) if np.isfinite(thr) else float("nan")
        self.cents = cents if np.all(np.isfinite(cents)) else None

    def push(self, ar: Arith, scores: np.ndarray, final: bool = False
             ) -> np.ndarray:
        s32 = np.asarray(scores, np.float32).reshape(-1)
        s = np.nan_to_num(np.asarray(s32, np.float64),
                          nan=0.0, posinf=0.0, neginf=0.0)
        if len(s32):
            sub = np.asarray(s, np.float32).reshape(-1)[::RESERVOIR_STRIDE]
            self.reservoir = np.concatenate(
                [self.reservoir, sub])[-RESERVOIR_SIZE:]
            self._threshold(ar)
        self.tail = np.concatenate([self.tail, s])
        self.end += len(s)
        commit_to = self.end if final else max(
            self.end - (self.refractory + 1), self.committed)
        new_cands = stitch_peaks(self.tail, self.tail_start, self.committed,
                                 commit_to, self.end, self.thr,
                                 self.refractory, self.taken)
        self.committed = max(self.committed, commit_to)
        self.taken = [q for q in self.taken
                      if q >= self.committed - self.refractory]
        for c in new_cands:
            if self.rr is None:
                self.pending.append(c)
                if len(self.pending) >= RR_BOOT:
                    self._bootstrap()
            else:
                self.rr = recover_gaps(self.tail, self.tail_start, self.out,
                                       c, self.rr, self.thr, self.refractory)
        if final:
            self.finalized = True
            if self.rr is None:
                if len(self.pending) >= 3:
                    self._bootstrap()
                else:
                    self.out.extend(self.pending)
                    self.pending = []
        self._trim()
        new = np.asarray(self.out[self.emitted:], np.int64)
        self.emitted = len(self.out)
        return new

    def _bootstrap(self) -> None:
        self.rr = float(np.median(np.diff(self.pending)))
        self.out.append(self.pending[0])
        for c in self.pending[1:]:
            self.rr = recover_gaps(self.tail, self.tail_start, self.out, c,
                                   self.rr, self.thr, self.refractory)
        self.pending = []

    def _trim(self) -> None:
        anchors = [self.committed - (self.refractory + 1)]
        if self.out:
            anchors.append(self.out[-1])
        if self.pending:
            anchors.append(self.pending[0])
        keep_from = max(min(anchors), self.end - self.tail_max,
                        self.tail_start, 0)
        if keep_from > self.tail_start:
            self.tail = self.tail[keep_from - self.tail_start:]
            self.tail_start = keep_from

    def boundary_gap(self, scores: np.ndarray) -> float:
        thr = self.thr
        if not np.isfinite(thr) or len(scores) < 3:
            return float("inf")
        s = np.nan_to_num(np.asarray(scores, np.float64),
                          nan=0.0, posinf=0.0, neginf=0.0)
        mx = (s[1:-1] >= s[:-2]) & (s[1:-1] >= s[2:])
        if not mx.any():
            return float("inf")
        return float(np.min(np.abs(s[1:-1][mx] - thr)))

    def mid_refractory(self) -> bool:
        return any(q + self.refractory > self.committed for q in self.taken)


@dataclasses.dataclass(frozen=True)
class Ladder:
    """The router's escalation policy (``stream/router.py``'s defaults)."""

    rungs: Tuple[str, ...] = ("posit8", "posit10", "posit16")
    margin: float = 0.08
    hold_windows: int = 4
    hysteresis: int = 2


class Escalation:
    """One stream's rung on the ladder (the router's ``observe``)."""

    def __init__(self, base: str, ladder: Optional[Ladder]):
        self.ladder = ladder
        self.base_fmt = base
        on = ladder is not None and base in ladder.rungs
        self.base = ladder.rungs.index(base) if on else None
        self.rung, self.hold, self.clean = self.base, 0, 0
        self.seen = False

    @property
    def fmt(self) -> str:
        if self.base is None or not self.seen:
            return self.base_fmt
        return self.ladder.rungs[max(self.rung, self.base)]

    def observe(self, gap: float, mid_refractory: bool) -> None:
        if self.base is None:
            return
        pol = self.ladder
        self.seen = True
        if gap <= pol.margin:
            self.clean = 0
            if self.rung < len(pol.rungs) - 1:
                self.rung += 1
            self.hold = pol.hold_windows
        else:
            self.clean += 1
            if self.rung > self.base:
                self.hold = max(self.hold - 1, 0)
                if (self.hold == 0 and self.clean >= pol.hysteresis
                        and not mid_refractory):
                    self.rung -= 1
                    self.hold = (pol.hold_windows if self.rung > self.base
                                 else 0)


def replay_patient(scores_by_fmt: Dict[str, np.ndarray],
                   counts_by_fmt: Dict[str, np.ndarray], base_fmt: str,
                   ladder: Optional[Ladder], groups: List[List[int]],
                   used: Optional[List[str]] = None,
                   device="cpu") -> Dict[str, object]:
    """One ECG patient's windows in order through the tracker and the
    escalation ladder.  ``scores_by_fmt[fmt]`` holds every window's (W, n)
    scores in ``fmt`` (``window_scores`` of the whole recording in each
    format it may route to), ``counts_by_fmt`` their candidate counts.

    ``groups`` are the dispatches the windows went out in, in order: the
    format of a dispatch is the stream's route before it, and the ladder
    observes each of its windows after it, as the engine does.  ``used``
    (the program's format of each window) makes the replay follow those
    formats, so that one disagreement about a rung is counted once and
    does not change every later window; without it the replay follows its
    own route.  Returns {"route": the format the ladder routes each window
    to, "fmt": the format each was computed in, "scores", "count",
    "peaks": every confirmed peak, the final flush's included}."""
    fold = Fold(device)
    esc = Escalation(base_fmt, ladder)
    route, fmts, scores, counts = {}, {}, {}, {}
    peaks: List[int] = []
    for group in groups:
        want = esc.fmt
        for w in group:
            fmt = used[w] if used is not None else want
            s = scores_by_fmt[fmt][w]
            route[w], fmts[w], scores[w] = want, fmt, s
            counts[w] = int(counts_by_fmt[fmt][w])
            peaks.extend(int(p) for p in fold.push(Arith.make(fmt), s))
            esc.observe(fold.boundary_gap(s), fold.mid_refractory())
    peaks.extend(int(p) for p in fold.push(
        Arith.make(esc.fmt), np.zeros(0, np.float32), final=True))
    order = sorted(route)
    return {"route": [route[w] for w in order],
            "fmt": [fmts[w] for w in order],
            "scores": np.stack([scores[w] for w in order]),
            "count": np.asarray([counts[w] for w in order]),
            "peaks": peaks}
