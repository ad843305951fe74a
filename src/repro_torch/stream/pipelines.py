"""Format-parametrized window pipelines: one batched callable per
(task, format, device), shared with the offline evaluation paths.

* cough — ``apps.cough.make_cough_scorer`` (FFT→PSD→MFCC→spectral + IMU
  features → random forest), batched over windows from many patients.
* rpeak — BayeSlope stages 1–2 (``apps.bayeslope.rpeak_window_scores``) on
  a (B, n) batch, plus an in-format candidate-peak count per window.

Each pipeline also states its per-window arithmetic op counts so the engine
can put nJ/window next to throughput (see ``stream.accounting``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional

import torch

from repro_torch.apps.bayeslope import RPEAK_WINDOW_S, rpeak_window_scores
from repro_torch.apps.cough import make_cough_scorer
from repro_torch.apps.forest import Forest
from repro_torch.core.arith import Arith, fusion_cache_key
from repro_torch.data.biosignals import AUDIO_SR, ECG_FS, IMU_SR, WINDOW_S
from repro_torch.energy.model import OpCounts

from .accounting import cough_window_op_counts, rpeak_window_op_counts
from .ring import ModalitySpec, WindowSpec
from .tracker import RPeakTracker

COUGH_SPEC = WindowSpec(
    task="cough",
    modalities=(ModalitySpec("audio", 2, AUDIO_SR),
                ModalitySpec("imu", 9, IMU_SR)),
    window_s=WINDOW_S, hop_s=WINDOW_S)

RPEAK_SPEC = WindowSpec(
    task="rpeak",
    modalities=(ModalitySpec("ecg", 1, ECG_FS),),
    window_s=RPEAK_WINDOW_S, hop_s=RPEAK_WINDOW_S)

BatchFn = Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]


@dataclasses.dataclass(frozen=True)
class Pipeline:
    """One streaming task: its window grid, batched-fn factory, op counts.

    ``make_fn(fmt, device)`` returns a callable mapping a dict of batched
    modality tensors (each ``(B, channels, n)`` float32 on ``device``) to a
    dict of batched outputs; rows are independent, so padding rows never
    affect real rows.

    ``make_tracker(patient, device)`` (optional) builds a per-patient
    stateful tracker; the engine feeds it each window's outputs in ``widx``
    order.
    """

    name: str
    spec: WindowSpec
    make_fn: Callable[[str, torch.device], BatchFn]
    ops_per_window: OpCounts
    make_tracker: Optional[Callable[[str, torch.device], object]] = None


def cough_pipeline(forest: Forest) -> Pipeline:
    @functools.lru_cache(maxsize=None)
    def make_fn_cached(fmt: str, device: torch.device, backend_key: tuple):
        scorer = make_cough_scorer(fmt, forest, device=device)

        def fn(arrays: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
            # audio arrives at the full 300 ms window (4800 samples); the
            # scorer crops/pads to the 4096-point FFT
            return {"p_cough": scorer(arrays["audio"], arrays["imu"])}

        return fn

    def make_fn(fmt: str, device: torch.device) -> BatchFn:
        return make_fn_cached(fmt, device, fusion_cache_key())

    # bill energy for the forest actually deployed, not the default size
    ops = cough_window_op_counts(n_trees=forest.feat.shape[0],
                                 depth=forest.depth)
    return Pipeline("cough", COUGH_SPEC, make_fn, ops)


@functools.lru_cache(maxsize=None)
def _rpeak_batch_fn(fmt: str, peak_threshold: float, refr: int,
                    backend_key: tuple) -> BatchFn:
    ar = Arith.make(fmt)

    def fn(arrays: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        norm = rpeak_window_scores(ar, arrays["ecg"][:, 0, :])   # (B, n)
        # candidate count: above threshold AND the maximum within the
        # ±refractory neighbourhood (≥ towards the past, > towards the
        # future — the offline detector's tie-break).  A cheap per-window
        # HR proxy, not the Bayesian stage.
        is_peak = norm > peak_threshold
        B = norm.shape[0]
        ones = torch.ones((B, 1), dtype=torch.bool, device=norm.device)
        for d in range(1, refr + 1):
            edge = ones.expand(B, d)
            ge_past = torch.cat([edge, norm[:, d:] >= norm[:, :-d]], dim=1)
            gt_future = torch.cat([norm[:, :-d] > norm[:, d:], edge], dim=1)
            is_peak &= ge_past & gt_future
        return {"scores": norm,
                "peak_count": is_peak.sum(dim=1).to(torch.int32)}

    return fn


def rpeak_pipeline(window_s: float = RPEAK_WINDOW_S,
                   peak_threshold: float = 0.5,
                   refractory_s: float = 0.1,
                   track_peaks: bool = True) -> Pipeline:
    """``track_peaks`` attaches a per-patient ``RPeakTracker`` carrying
    BayeSlope stages 3-4 across windows — each ``WindowResult`` then gains a
    ``peaks`` output (absolute samples confirmed by that window)."""
    n = int(round(window_s * ECG_FS))
    refr = max(int(round(refractory_s * ECG_FS)), 1)
    spec = RPEAK_SPEC if window_s == RPEAK_WINDOW_S else WindowSpec(
        task="rpeak", modalities=(ModalitySpec("ecg", 1, ECG_FS),),
        window_s=window_s, hop_s=window_s)

    def make_fn(fmt: str, device: torch.device) -> BatchFn:
        return _rpeak_batch_fn(fmt, peak_threshold, refr, fusion_cache_key())

    def make_tracker(patient: str, device: torch.device) -> RPeakTracker:
        return RPeakTracker(patient, fs=ECG_FS, window_samples=n,
                            device=device)

    return Pipeline("rpeak", spec, make_fn, rpeak_window_op_counts(n),
                    make_tracker if track_peaks else None)
