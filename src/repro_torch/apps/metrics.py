"""Evaluation metrics: ROC/AUC (cough), tolerance-windowed F1 (R peaks)."""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np


def roc_curve(scores: np.ndarray, labels: np.ndarray):
    order = np.argsort(-scores, kind="stable")
    y = labels[order]
    tps = np.cumsum(y)
    fps = np.cumsum(1 - y)
    P, N = max(y.sum(), 1), max((1 - y).sum(), 1)
    tpr = np.concatenate([[0.0], tps / P])
    fpr = np.concatenate([[0.0], fps / N])
    return fpr, tpr


def auc(scores: np.ndarray, labels: np.ndarray) -> float:
    scores = np.nan_to_num(np.asarray(scores, np.float64),
                           nan=0.0, posinf=1e30, neginf=-1e30)
    fpr, tpr = roc_curve(scores, labels)
    return float(np.trapezoid(tpr, fpr))


def fpr_at_tpr(scores: np.ndarray, labels: np.ndarray,
               target_tpr: float = 0.95) -> float:
    scores = np.nan_to_num(np.asarray(scores, np.float64),
                           nan=0.0, posinf=1e30, neginf=-1e30)
    fpr, tpr = roc_curve(scores, labels)
    idx = np.searchsorted(tpr, target_tpr)
    idx = min(idx, len(fpr) - 1)
    return float(fpr[idx])


def rpeak_f1(pred_idx: Sequence[int], true_idx: Sequence[int],
             fs: float, tol_s: float = 0.150) -> Tuple[float, float, float]:
    """Greedy one-to-one matching within ±tol (the standard 150 ms)."""
    tol = tol_s * fs
    pred = sorted(int(p) for p in pred_idx)
    true = sorted(int(t) for t in true_idx)
    used = [False] * len(true)
    tp = 0
    for p in pred:
        best, bestd = -1, tol + 1
        for j, t in enumerate(true):
            if used[j]:
                continue
            d = abs(p - t)
            if d < bestd:
                best, bestd = j, d
        if best >= 0 and bestd <= tol:
            used[best] = True
            tp += 1
    fp = len(pred) - tp
    fn = len(true) - tp
    prec = tp / max(tp + fp, 1)
    rec = tp / max(tp + fn, 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-12)
    return f1, prec, rec
