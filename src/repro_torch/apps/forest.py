"""Random forest: offline CART training (numpy, float64) + format-
parametrized inference in torch (the wearable side of the paper's pipeline).

Trees are fixed-depth arrays, so inference is gathers and comparisons;
posit comparisons are exact integer compares on hardware, so only the
features and thresholds are format-rounded.  Training is a copy of
``repro.apps.forest``'s, so the same data and seed give the same trees.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.arith import Arith


@dataclasses.dataclass
class Forest:
    feat: np.ndarray    # (T, nodes) int32 feature index (-1 = leaf)
    thresh: np.ndarray  # (T, nodes) float64
    value: np.ndarray   # (T, nodes) float64 leaf probability
    depth: int


def forest_from_arrays(feat, thresh, value, depth: int) -> Forest:
    """A ``Forest`` from plain arrays — e.g. the fields of a forest trained
    elsewhere, so two implementations score the same trees."""
    return Forest(np.asarray(feat, np.int32), np.asarray(thresh, np.float64),
                  np.asarray(value, np.float64), int(depth))


def _gini(y):
    p = y.mean() if len(y) else 0.0
    return p * (1 - p)


def _train_tree(X, y, rng, depth, min_leaf=4, n_feat_sub=None):
    nodes = 2 ** (depth + 1) - 1
    feat = np.full(nodes, -1, np.int32)
    thresh = np.zeros(nodes)
    value = np.zeros(nodes)

    def build(node, idx, d):
        value[node] = y[idx].mean() if len(idx) else 0.0
        if d == depth or len(idx) < 2 * min_leaf or len(set(y[idx])) == 1:
            return
        feats = rng.choice(X.shape[1], n_feat_sub or X.shape[1], replace=False)
        best = (None, None, np.inf)
        for f in feats:
            vals = X[idx, f]
            qs = np.quantile(vals, np.linspace(0.1, 0.9, 9))
            for t in qs:
                left = idx[vals <= t]
                right = idx[vals > t]
                if len(left) < min_leaf or len(right) < min_leaf:
                    continue
                score = len(left) * _gini(y[left]) + len(right) * _gini(y[right])
                if score < best[2]:
                    best = (f, t, score)
        if best[0] is None:
            return
        f, t, _ = best
        feat[node] = f
        thresh[node] = t
        vals = X[idx, f]
        build(2 * node + 1, idx[vals <= t], d + 1)
        build(2 * node + 2, idx[vals > t], d + 1)

    build(0, np.arange(len(y)), 0)
    return feat, thresh, value


def train_forest(X: np.ndarray, y: np.ndarray, n_trees: int = 20,
                 depth: int = 6, seed: int = 0) -> Forest:
    rng = np.random.default_rng(seed)
    feats, threshs, values = [], [], []
    n = len(y)
    n_feat_sub = max(2, int(np.sqrt(X.shape[1])))
    for _ in range(n_trees):
        boot = rng.integers(0, n, n)
        f, th, v = _train_tree(X[boot], y[boot], rng, depth,
                               n_feat_sub=n_feat_sub)
        feats.append(f)
        threshs.append(th)
        values.append(v)
    return Forest(np.stack(feats), np.stack(threshs), np.stack(values), depth)


def forest_predict(ar: Arith, forest: Forest, X: torch.Tensor) -> torch.Tensor:
    """X: (B, F) features already in the target format. Returns P(cough)."""
    dev, dt = X.device, X.dtype
    feat = torch.as_tensor(forest.feat, dtype=torch.int64, device=dev)
    thresh = ar.rnd(torch.as_tensor(forest.thresh).to(device=dev, dtype=dt))
    value = ar.rnd(torch.as_tensor(forest.value).to(device=dev, dtype=dt))
    T = feat.shape[0]
    B = X.shape[0]
    trees = torch.arange(T, device=dev)[None]

    node = torch.zeros((B, T), dtype=torch.int64, device=dev)
    for _ in range(forest.depth):
        f = feat[trees, node]                           # (B, T)
        th = thresh[trees, node]
        x = torch.gather(X, 1, torch.clamp(f, min=0))
        go_left = x <= th                               # posit cmp == int cmp
        nxt = torch.where(go_left, 2 * node + 1, 2 * node + 2)
        node = torch.where(f < 0, node, nxt)
    probs = value[trees, node]                          # (B, T)
    # vote aggregation as a rounded matmul row (×1 products are exact):
    # posits take one wide accumulation rounded once (exact under quire
    # mode), IEEE formats the per-MAC rounded chain
    votes = ar.matmul(probs, torch.ones((T, 1), dtype=dt, device=dev))[..., 0]
    return ar.div(votes, float(T))
