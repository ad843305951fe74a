"""Per-patient stateful R-peak tracking for the streaming runtime.

The counterpart of ``repro.stream.tracker``, driving this package's
``RPeakFold`` (its 2-means runs on the tracker's ``device``).

``RPeakTracker`` carries BayeSlope's stages 3-4 across window boundaries by
driving the same ``apps.bayeslope.RPeakFold`` state machine the offline
``detect_rpeaks`` folds over — adaptive 2-means threshold from a bounded
score reservoir (k-means in the window's routed format, centroids
warm-started window to window), greedy-refractory candidate stitching
through a deferred commit frontier, and the Bayesian RR-prior gap walk over
the retained score tail.  Streaming peaks therefore equal offline peaks for
any chunking of the same record.

Each update also produces the quality-feedback signal the
``PrecisionRouter`` escalation policy consumes: how close the window's
candidate maxima came to the decision threshold (``boundary_gap``), and
whether an accepted beat's refractory period spans the commit frontier
(``mid_refractory`` — de-escalating there would change the arithmetic in the
middle of a beat decision).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.apps.bayeslope import RPEAK_WINDOW_S, RPeakFold
from repro_torch.core.arith import Arith
from repro_torch.data.biosignals import ECG_FS


@dataclasses.dataclass(frozen=True)
class TrackerUpdate:
    """Outcome of feeding one window's scores to a tracker."""

    patient: str
    widx: int
    fmt: str
    new_peaks: np.ndarray     # absolute samples confirmed by this window
    thr: float                # adaptive threshold after this window
    boundary_gap: float       # min |candidate max − thr|; inf if no maxima
    mid_refractory: bool      # accepted beat's refractory spans the frontier


class RPeakTracker:
    """One patient's cross-window R-peak state (see module docstring).

    ``update`` must see windows in ``widx`` order exactly once — which is
    precisely the dispatcher's emission guarantee — and each window's score
    vector must be one hop long, so absolute sample positions fall out of
    the fold's running sample count.
    """

    def __init__(self, patient: str = "", fs: int = ECG_FS,
                 window_samples: Optional[int] = None,
                 window_s: float = RPEAK_WINDOW_S, device=None):
        self.patient = patient
        self.window_samples = (int(window_samples) if window_samples
                               else int(round(window_s * fs)))
        self.fold = RPeakFold(fs=fs, device=device)
        self.next_widx = 0
        self.peaks: List[int] = []      # every confirmed peak so far
        self.windows_by_fmt: Dict[str, int] = {}
        self._ars: Dict[str, Arith] = {}
        self.finalized = False

    def _ar(self, fmt: str) -> Arith:
        ar = self._ars.get(fmt)
        if ar is None:
            ar = self._ars[fmt] = Arith.make(fmt)
        return ar

    def update(self, widx: int, outputs: Dict[str, np.ndarray],
               fmt: str) -> TrackerUpdate:
        """Feed window ``widx``'s pipeline outputs (needs ``scores``)."""
        if widx != self.next_widx:
            raise ValueError(
                f"tracker for {self.patient!r} expected window "
                f"{self.next_widx}, got {widx} — windows must arrive "
                f"in order exactly once")
        scores = np.asarray(outputs["scores"])
        if scores.shape[-1] != self.window_samples:
            raise ValueError(
                f"window of {scores.shape[-1]} scores, tracker expects "
                f"{self.window_samples}")
        self.next_widx += 1
        self.windows_by_fmt[fmt] = self.windows_by_fmt.get(fmt, 0) + 1
        new = self.fold.push(self._ar(fmt), scores)
        self.peaks.extend(int(p) for p in new)
        return TrackerUpdate(
            self.patient, widx, fmt, new, self.fold.thr,
            self._boundary_gap(scores), self._mid_refractory())

    def finalize(self, fmt: str) -> np.ndarray:
        """End of stream: flush the fold's deferred lookahead margin."""
        if self.finalized:
            return np.zeros(0, np.int64)
        self.finalized = True
        new = self.fold.finalize(self._ar(fmt))
        self.peaks.extend(int(p) for p in new)
        return new

    def _boundary_gap(self, scores: np.ndarray) -> float:
        """Distance of this window's closest local maximum to the threshold —
        the escalation policy's quality signal (small gap = the format's
        resolution is deciding beats)."""
        thr = self.fold.thr
        if not np.isfinite(thr) or len(scores) < 3:
            return float("inf")
        s = np.nan_to_num(np.asarray(scores, np.float64),
                          nan=0.0, posinf=0.0, neginf=0.0)
        mx = (s[1:-1] >= s[:-2]) & (s[1:-1] >= s[2:])
        if not mx.any():
            return float("inf")
        return float(np.min(np.abs(s[1:-1][mx] - thr)))

    def _mid_refractory(self) -> bool:
        return any(q + self.fold.refractory > self.fold.committed
                   for q in self.fold.taken)
