"""Cough detection (paper §IV-A): IMU + audio features → random forest.

The feature pipeline runs in the chosen arithmetic (FFT, PSD, MFCC, ZCR,
kurtosis, RMS all rounded per op); the forest is trained offline in float64
on this package's own fp32 features.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core.arith import Arith
from repro_torch.core.device import resolve_device
from repro_torch.data.biosignals import AUDIO_SR, cough_dataset

from . import dsp
from .forest import Forest, forest_predict, train_forest
from .metrics import auc, fpr_at_tpr

FFT_N = 4096


def extract_features(ar: Arith, audio: torch.Tensor,
                     imu: torch.Tensor) -> torch.Tensor:
    """audio: (B, 2, N) PCM-scale; imu: (B, 9, M). → (B, F) features."""
    B = audio.shape[0]
    # crop/zero-pad to the 4096-point FFT before the ingest rounding
    # (rnd is elementwise and rnd(0) == 0, so the bits match
    # round-then-crop without rounding dropped samples)
    a = audio[..., :FFT_N]
    if a.shape[-1] < FFT_N:
        a = F.pad(a, (0, FFT_N - a.shape[-1]))
    a = ar.rnd(a)
    psd = dsp.power_spectrum(ar, a)                   # (B, 2, FFT_N/2+1)
    spec = dsp.spectral_features(ar, psd, AUDIO_SR)   # (B, 2, 6)
    mf = dsp.mfcc(ar, psd, AUDIO_SR)                  # (B, 2, 13)
    im = ar.rnd(imu)
    zcr = dsp.zero_crossing_rate(ar, im)              # (B, 9)
    kur = dsp.kurtosis(ar, im)                        # (B, 9)
    rm = dsp.rms(ar, im)                              # (B, 9)
    feats = torch.cat(
        [spec.reshape(B, -1), mf.reshape(B, -1), zcr, kur, rm], dim=-1)
    return ar.rnd(feats)


def train_reference_forest(n_windows: int, data_seed: int, *,
                           n_trees: int = 20, depth: int = 6,
                           forest_seed: int = 0, device=None) -> Forest:
    """The offline training side: fp32 features of this package's pipeline
    on a dedicated dataset → CART forest in float64."""
    dev = resolve_device(device)
    audio, imu, labels = cough_dataset(n_windows, data_seed)
    X = extract_features(
        Arith.make("fp32"),
        torch.as_tensor(audio, dtype=torch.float32, device=dev),
        torch.as_tensor(imu, dtype=torch.float32, device=dev))
    return train_forest(X.cpu().numpy().astype(np.float64), labels,
                        n_trees=n_trees, depth=depth, seed=forest_seed)


def make_cough_scorer(fmt_name: str, forest: Forest, device=None):
    """One window-batch scorer on ``device`` (default: the card):
    (audio(B,2,N), imu(B,9,M)) → P(cough) of shape (B,).  Rows are
    independent, so any batch size gives the same per-row results."""
    ar = Arith.make(fmt_name)
    dev = resolve_device(device)

    def scorer(audio, imu) -> torch.Tensor:
        audio = torch.as_tensor(audio, dtype=torch.float32, device=dev)
        imu = torch.as_tensor(imu, dtype=torch.float32, device=dev)
        return forest_predict(ar, forest, extract_features(ar, audio, imu))

    return scorer


def run_cough_detection(fmt_names, n_windows: int = 200, seed: int = 0,
                        n_train: int = 400, device=None
                        ) -> Dict[str, Dict[str, float]]:
    """The format study of the paper's Fig. 4: {fmt: {auc, fpr_at_tpr95}}.

    The forest is trained once, offline, on fp32 features of a disjoint
    training set, then the whole wearable pipeline is evaluated per format
    on held-out windows, on ``device`` (default: the card)."""
    dev = resolve_device(device)
    forest = train_reference_forest(n_train, seed + 1000, forest_seed=seed,
                                    device=dev)
    audio, imu, labels = cough_dataset(n_windows, seed)
    results = {}
    for name in fmt_names:
        scores = make_cough_scorer(name, forest, device=dev)(audio, imu)
        scores = scores.cpu().numpy().astype(np.float64)
        results[name] = {"auc": auc(scores, labels),
                         "fpr_at_tpr95": fpr_at_tpr(scores, labels, 0.95)}
    return results
