"""BayeSlope R-peak detection (paper §IV-B), format-parametrized.

The counterpart of ``repro.apps.bayeslope``:
  1. slope-product peak enhancement (amplitudes in ADC-scale units),
  2. generalized-logistic normalization,
  3. k-means (2 clusters) → adaptive R-vs-baseline threshold,
  4. Bayesian filter: Gaussian prior on the next R position from the running
     RR estimate.

Stages 1-2 run batched in the target format over fixed windows
(``rpeak_window_scores``), on a torch device.  Stages 3-4 are window-
incremental host code (``threshold_update``, ``stitch_peaks``,
``recover_gaps``) threaded through ``RPeakFold``; ``detect_rpeaks`` folds
over the windows of a full recording and the streaming ``RPeakTracker``
drives the same fold one window at a time, so streaming peaks equal offline
peaks for any chunking.  The k-means threshold runs in the window's format
on the fold's device.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.arith import Arith
from repro_torch.core.device import resolve_device
from repro_torch.data.biosignals import ECG_FS, ecg_dataset
from repro_torch.obs.trace import current, span

from .kmeans import kmeans_1d, kmeans_route
from .metrics import rpeak_f1

# Canonical fold/stream window (the streaming runtime's R-peak hop grid).
RPEAK_WINDOW_S = 2.0
# Greedy-refractory spacing between accepted peaks (~270 bpm ceiling).
REFRACTORY_S = 0.22
# At most this many subsampled scores feed the 2-means threshold.
RESERVOIR_SIZE = 500
# Every RESERVOIR_STRIDE-th score of each window enters the reservoir.
RESERVOIR_STRIDE = 5
# Lloyd iterations of the threshold's 2-means, every window.
KMEANS_ITERS = 12
# Candidates collected before the RR estimate bootstraps (median of diffs).
RR_BOOT = 8
# Retained score-tail cap: how far back the Bayesian gap walk can search.
TAIL_MAX_S = 8.0


def enhance(ar: Arith, sig: torch.Tensor) -> torch.Tensor:
    """|slope_t| * |slope_{t+1}|, 25-tap in-format moving sum — steep on
    both sides ⇒ R.  Works over the LAST axis: one 1-D segment or a
    (..., B, n) batch of windows go through the same ops."""
    x = ar.rnd(sig)
    n = x.shape[-1]
    d = ar.sub(x[..., 1:], x[..., :-1])
    ad = torch.abs(d)
    enh = ar.mul(ad[..., :-1], ad[..., 1:])
    enh = torch.cat([enh[..., :1], enh, enh[..., -1:]], dim=-1)
    # moving-window integration (~0.1 s), every add/div in-format;
    # pre-scaled accumulation: divide first
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
    """Generalized logistic squashing around the running scale (last axis)."""
    mu = ar.mean(enh, axis=-1)
    scale = torch.clamp(mu, min=1e-12)[..., None]
    z = ar.div(enh, scale)
    # y = 1 / (1 + exp(-(z - 1)))  computed with rounded ops
    e = ar.exp(torch.clamp(ar.sub(1.0, z), -30.0, 30.0))
    return ar.div(1.0, ar.add(1.0, e))


def rpeak_window_scores(ar: Arith, windows: torch.Tensor) -> torch.Tensor:
    """BayeSlope stages 1–2 over the last axis: slope-product enhancement +
    GLF normalization."""
    return glf_normalize(ar, enhance(ar, windows))


# ---------------------------------------------------------------------------
# Stages 3-4 as pure window-incremental functions
# ---------------------------------------------------------------------------

def reservoir_update(reservoir: np.ndarray, scores: np.ndarray,
                     size: int = RESERVOIR_SIZE,
                     stride: int = RESERVOIR_STRIDE) -> np.ndarray:
    """FIFO reservoir of subsampled window scores feeding the threshold.

    Keeps the LAST ``size`` entries, so the threshold always reflects recent
    signal — never more than ``size`` values regardless of stream length.
    """
    sub = np.asarray(scores, np.float32).reshape(-1)[::stride]
    return np.concatenate([reservoir, sub])[-size:]


def threshold_update(ar: Arith, reservoir: np.ndarray,
                     init: Optional[np.ndarray] = None, device=None
                     ) -> Tuple[float, np.ndarray]:
    """Incremental 2-means threshold over the reservoir, in ``ar``'s format.

    ``init`` warm-starts the centroids from the previous window's solution.
    Returns (thr, centroids): thr = 0.3·low + 0.7·high (weighted toward the
    R cluster), NaN when the arithmetic collapsed.  The 2-means runs on
    ``device`` (default: the card); ``init`` stays on the host, from where
    the one-launch route passes it to its kernel by value.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(reservoir, dtype=torch.float32, device=dev)
    if init is not None:
        init = np.asarray(init, np.float32)
    cents = kmeans_1d(ar, x, k=2, iters=KMEANS_ITERS,
                      init=init).cpu().numpy().astype(np.float32)
    c = np.sort(np.asarray(cents, np.float64))
    thr = 0.3 * c[0] + 0.7 * c[1]
    return (float(thr) if np.isfinite(thr) else float("nan")), cents


def stitch_peaks(e: np.ndarray, start: int, committed: int, commit_to: int,
                 end: int, thr: float, refractory: int,
                 taken: List[int]) -> List[int]:
    """Greedy-refractory candidate peaks on the newly committable region.

    ``e`` is the retained score tail (float64, NaN→0) with ``e[0]`` at
    absolute sample ``start``; candidates are finalized for absolute
    positions [``committed``, ``commit_to``) — the caller leaves a
    refractory+1 lookahead margin uncommitted until the next window (or the
    final flush), so a peak straddling a window boundary is judged with both
    neighbours present.  ``taken`` holds recently accepted peaks (absolute);
    accepted candidates are appended to it.  Returns the newly accepted
    candidates in ascending order.
    """
    lo = max(committed, 1)              # first sample has no left neighbour
    hi = min(commit_to, end - 1)        # last sample has no right neighbour
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


def recover_gaps(e: np.ndarray, start: int, out: List[int], nxt: int,
                 rr: float, thr: float, refractory: int) -> float:
    """Bayesian RR-prior gap walk between ``out[-1]`` and candidate ``nxt``.

    For inter-peak gaps much longer than the running RR estimate, re-search
    the retained score tail with a Gaussian prior on the expected position
    and a relaxed threshold.  Appends recovered peaks plus ``nxt`` to ``out``
    and returns the updated RR estimate.
    """
    gap = nxt - out[-1]
    while gap > 1.55 * rr:
        expect = out[-1] + rr
        lo = int(max(out[-1] + refractory, expect - 0.4 * rr))
        hi = int(min(nxt - refractory, expect + 0.4 * rr))
        lo = max(lo, start)                   # tail-trim clamp
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


class RPeakFold:
    """Cross-window BayeSlope stages 3-4 state machine.

    One instance per ECG stream; ``push`` consumes consecutive windows'
    stage 1-2 scores and returns newly *confirmed* peaks (absolute sample
    indices, ascending across calls).  The offline ``detect_rpeaks`` and the
    streaming ``RPeakTracker`` both drive this class with the identical call
    sequence — every push with ``final=False``, then one empty ``finalize``
    flush — which is what makes streaming output equal offline output for
    any chunking of the input.

    State carried across windows:
      * score ``reservoir`` + warm-started centroids → adaptive threshold,
      * a retained score ``tail`` (bounded by ``tail_max_s``) for boundary
        stitching and gap re-search,
      * the deferred commit frontier (refractory+1 lookahead) so candidates
        at a window edge are judged with both neighbours present,
      * recently accepted candidates (``taken``) enforcing the refractory
        across boundaries,
      * the RR estimate (bootstrapped from the first ``rr_boot`` candidates,
        then EMA-updated exactly as the paper's stage 4).
    """

    def __init__(self, fs: int = ECG_FS,
                 reservoir_size: int = RESERVOIR_SIZE,
                 reservoir_stride: int = RESERVOIR_STRIDE,
                 rr_boot: int = RR_BOOT, tail_max_s: float = TAIL_MAX_S,
                 device=None):
        self.device = resolve_device(device)
        self.fs = fs
        self.refractory = int(REFRACTORY_S * fs)
        self.reservoir_size = reservoir_size
        self.reservoir_stride = reservoir_stride
        self.rr_boot = rr_boot
        self.tail_max = int(tail_max_s * fs)
        self.reservoir = np.zeros(0, np.float32)
        self.cents: Optional[np.ndarray] = None   # warm-start centroids
        self.thr = float("nan")
        self.tail = np.zeros(0, np.float64)
        self.tail_start = 0
        self.end = 0                    # absolute samples consumed
        self.committed = 0              # candidates finalized for [0, here)
        self.taken: List[int] = []      # recent accepted candidates
        self.pending: List[int] = []    # candidates before the RR bootstrap
        self.out: List[int] = []        # confirmed peak stream
        self.rr: Optional[float] = None
        self.emitted = 0
        self.finalized = False

    def push(self, ar: Arith, scores: np.ndarray,
             final: bool = False) -> np.ndarray:
        """Consume the next window's scores; return newly confirmed peaks."""
        if self.finalized:
            raise RuntimeError("RPeakFold already finalized")
        s32 = np.asarray(scores, np.float32).reshape(-1)
        s = np.nan_to_num(np.asarray(s32, np.float64),
                          nan=0.0, posinf=0.0, neginf=0.0)
        if len(s32):
            # threshold from the bounded reservoir, in this window's format.
            # The SANITIZED scores enter the reservoir: one NaN/Inf artifact
            # window must not poison the threshold for the reservoir's whole
            # FIFO lifetime after the arithmetic recovers.  NaN centroids
            # (collapsed arithmetic) never warm-start the next k-means.
            self.reservoir = reservoir_update(
                self.reservoir, s, self.reservoir_size,
                self.reservoir_stride)
            args = {"iters": KMEANS_ITERS}
            if current() is not None:       # the route, read when traced
                args["route"] = kmeans_route(ar, self.device)
            with span("stream", "rpeak.threshold", **args):
                self.thr, cents = threshold_update(ar, self.reservoir,
                                                   init=self.cents,
                                                   device=self.device)
            self.cents = cents if np.all(np.isfinite(cents)) else None
        with span("stream", "rpeak.stitch"):
            self._stitch(s, final)
        new = np.asarray(self.out[self.emitted:], np.int64)
        self.emitted = len(self.out)
        return new

    def _stitch(self, s: np.ndarray, final: bool) -> None:
        """Stage 4 on the window's sanitized scores ``s``: candidates up to
        the commit frontier, the RR bootstrap and gap walk, the tail trim."""
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
                if len(self.pending) >= self.rr_boot:
                    self._bootstrap()
            else:
                self.rr = recover_gaps(self.tail, self.tail_start, self.out,
                                       c, self.rr, self.thr, self.refractory)
        if final:
            self.finalized = True
            if self.rr is None:
                if len(self.pending) >= 3:
                    self._bootstrap()
                else:           # too few beats for an RR prior: emit as-is
                    self.out.extend(self.pending)
                    self.pending = []
        self._trim()

    def finalize(self, ar: Arith) -> np.ndarray:
        """End-of-stream flush: commit the deferred lookahead margin."""
        if self.finalized:
            return np.zeros(0, np.int64)
        return self.push(ar, np.zeros(0, np.float32), final=True)

    @property
    def peaks(self) -> List[int]:
        """All confirmed peaks so far (complete after ``finalize``)."""
        return list(self.out)

    def _bootstrap(self) -> None:
        # RR prior from the first candidates' median spacing, then walk the
        # rest of them through the gap recovery retroactively.
        self.rr = float(np.median(np.diff(self.pending)))
        self.out.append(self.pending[0])
        for c in self.pending[1:]:
            self.rr = recover_gaps(self.tail, self.tail_start, self.out, c,
                                   self.rr, self.thr, self.refractory)
        self.pending = []

    def _trim(self) -> None:
        # retain: stitch context behind the frontier, the gap-walk span back
        # to the last confirmed (or first pending) peak — all capped by
        # tail_max so a flatlined stream cannot grow the tail unboundedly.
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


def detect_rpeaks(ar: Arith, sig_np: np.ndarray, fs: int = ECG_FS,
                  window_s: float = RPEAK_WINDOW_S, device=None) -> List[int]:
    """Offline BayeSlope detection on ``device`` (default: the card): split
    the recording on the streaming hop grid, score each window with stages
    1-2, fold stages 3-4 through ``RPeakFold``."""
    dev = resolve_device(device)
    sig = np.asarray(sig_np, np.float32)
    n = len(sig)
    if n < 4:
        return []
    W = int(round(window_s * fs))
    fold = RPeakFold(fs=fs, device=dev)
    peaks: List[int] = []
    for s0 in range(0, n, W):
        w = sig[s0: s0 + W]
        if len(w) >= 3:     # enhance() needs ≥ 1 slope product
            scores = rpeak_window_scores(
                ar, torch.as_tensor(w, device=dev)).cpu().numpy()
        else:
            scores = np.zeros(0, np.float32)
        peaks.extend(int(p) for p in fold.push(ar, scores))
    peaks.extend(int(p) for p in fold.finalize(ar))
    return peaks


def run_rpeak_detection(fmt_names, n_subjects: int = 8,
                        segments_per_subject: int = 3,
                        segment_s: float = 20.0, seed: int = 1,
                        device=None) -> Dict[str, float]:
    """The format study of the paper's Fig. 5: {fmt: mean F1} over the
    ``ecg_dataset`` segments, on ``device`` (default: the card)."""
    dev = resolve_device(device)
    data = ecg_dataset(n_subjects, segments_per_subject, segment_s, seed)
    out = {}
    for name in fmt_names:
        ar = Arith.make(name)
        f1s = [rpeak_f1(detect_rpeaks(ar, sig, device=dev), true_r,
                        ECG_FS)[0] for sig, true_r in data]
        out[name] = float(np.mean(f1s))
    return out
