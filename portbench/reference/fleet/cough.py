"""The cough window core in plain posit arithmetic: rounded crop, the
radix-2 real FFT stage by stage, the PSD, spectral features, the mel and
DCT rounded matmuls, the IMU features, and the forest's votes.

A frozen copy of the port's per-op oracle path (``apps/dsp.py``'s
``_rfft_unfused`` and its helpers, ``apps/cough.py::extract_features``,
``apps/forest.py``), posit formats only, every op through this package's
``Arith``.  The Stockham layout switch at ``MIN_RUN`` is the port's own
rule (``kernels/posit_fft.py``); the fused stage-range kernel the program
runs is bit-identical to this loop by the port's design, and the
comparison that decides ``correct`` holds it to that.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .arith import Arith

FFT_N = 4096
MIN_RUN = 64
AUDIO_SR = 16_000


def _rounded_table(values: np.ndarray, fmt_name: str, dtype: torch.dtype,
                   device: str) -> torch.Tensor:
    """``values`` rounded through the format on the CPU, then placed on
    ``device`` once (the port builds its tables the same way)."""
    t = Arith.make(fmt_name).rnd(torch.as_tensor(values).to(dtype))
    return t.to(device)


@functools.lru_cache(maxsize=None)
def _stage_twiddles(n: int, fmt_name: str, dtype: torch.dtype, device: str
                    ) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    out = []
    for s in range(1, n.bit_length()):
        m = 1 << s
        ang = -2.0 * np.pi * np.arange(m // 2) / m
        out.append((_rounded_table(np.cos(ang), fmt_name, dtype, device),
                    _rounded_table(np.sin(ang), fmt_name, dtype, device)))
    return out


def _stage_split(z_re, z_im, R: int, transposed: bool):
    if transposed:
        return (z_re[..., : R // 2], z_im[..., : R // 2],
                z_re[..., R // 2:], z_im[..., R // 2:])
    return (z_re[..., : R // 2, :], z_im[..., : R // 2, :],
            z_re[..., R // 2:, :], z_im[..., R // 2:, :])


def _stage_join(u, v, transposed: bool):
    return torch.cat([u, v], dim=-2 if transposed else -1)


def _stage_tw(w: torch.Tensor, transposed: bool) -> torch.Tensor:
    return w[:, None] if transposed else w


def _to_natural(z_re, z_im, transposed: bool):
    if transposed:
        return z_re.transpose(-1, -2), z_im.transpose(-1, -2)
    return z_re, z_im


def _twiddle_mul(ar: Arith, o_re, o_im, wr, wi):
    return (ar.sub(ar.mul(wr, o_re), ar.mul(wi, o_im)),
            ar.add(ar.mul(wr, o_im), ar.mul(wi, o_re)))


def _butterfly(ar: Arith, e_re, e_im, o_re, o_im, wr, wi):
    t_re, t_im = _twiddle_mul(ar, o_re, o_im, wr, wi)
    return (ar.add(e_re, t_re), ar.add(e_im, t_im),
            ar.sub(e_re, t_re), ar.sub(e_im, t_im))


def rfft(ar: Arith, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Bins 0 .. n/2 of the FFT of a real last axis, every op rounded:
    stage 1 a real add/sub, stage 2 on the real plane, the middle stages
    as butterflies, the last stage u and the Nyquist bin only."""
    n = x.shape[-1]
    stages = _stage_twiddles(n, ar.name, x.dtype, str(x.device))
    levels = len(stages)
    zr = ar.rnd(x)[..., None, :]
    tr = True
    e_re, o_re = zr[..., : n // 2], zr[..., n // 2:]
    zr = _stage_join(ar.add(e_re, o_re), ar.sub(e_re, o_re), tr)
    R = n >> 1
    wr = _stage_tw(stages[1][0], tr)
    wi = _stage_tw(stages[1][1], tr)
    e_re, o_re = zr[..., : R // 2], zr[..., R // 2:]
    t_re = ar.mul(wr, o_re)
    t_im = ar.mul(wi, o_re)
    zr = _stage_join(ar.add(e_re, t_re), ar.sub(e_re, t_re), tr)
    zi = _stage_join(t_im, -t_im, tr)
    for s in range(2, levels - 1):
        R = n >> s
        if tr and R // 2 < MIN_RUN:
            zr, zi = _to_natural(zr, zi, tr)
            tr = False
        wr, wi = stages[s]
        e_re, e_im, o_re, o_im = _stage_split(zr, zi, R, tr)
        u_re, u_im, v_re, v_im = _butterfly(ar, e_re, e_im, o_re, o_im,
                                            _stage_tw(wr, tr),
                                            _stage_tw(wi, tr))
        zr = _stage_join(u_re, v_re, tr)
        zi = _stage_join(u_im, v_im, tr)
    zr, zi = _to_natural(zr, zi, tr)
    wr, wi = stages[-1]
    e_re, o_re = zr[..., 0, :], zr[..., 1, :]
    e_im, o_im = zi[..., 0, :], zi[..., 1, :]
    t_re, t_im = _twiddle_mul(ar, o_re, o_im, wr, wi)
    u_re = ar.add(e_re, t_re)
    u_im = ar.add(e_im, t_im)
    ny_re = ar.sub(e_re[..., :1], t_re[..., :1])
    ny_im = ar.sub(e_im[..., :1], t_im[..., :1])
    return (torch.cat([u_re, ny_re], dim=-1),
            torch.cat([u_im, ny_im], dim=-1))


def power_spectrum(ar: Arith, x: torch.Tensor) -> torch.Tensor:
    re, im = rfft(ar, x)
    return ar.add(ar.mul(re, re), ar.mul(im, im))


def spectral_features(ar: Arith, psd: torch.Tensor, sr: float
                      ) -> torch.Tensor:
    """Centroid, rolloff (85 %) and 4 log-spaced band-energy ratios."""
    n = psd.shape[-1]
    freqs = torch.as_tensor(np.linspace(0, sr / 2, n)).to(
        device=psd.device, dtype=psd.dtype)
    cum = ar.cumsum(psd, axis=-1)
    total = torch.clamp(cum[..., -1], min=1e-20)
    centroid = ar.div(ar.matmul(psd, freqs[:, None])[..., 0], total)
    thr = ar.mul(ar.rnd(torch.tensor(0.85, dtype=psd.dtype,
                                     device=psd.device)), cum[..., -1:])
    roll_idx = torch.argmax((cum >= thr).to(torch.uint8), dim=-1)
    rolloff = freqs[roll_idx]
    bands = []
    edges = np.geomspace(1, n - 1, 5).astype(int)
    for i in range(4):
        e = ar.sum(psd[..., edges[i]:edges[i + 1]], axis=-1)
        bands.append(ar.div(e, total))
    return torch.stack([centroid, rolloff, *bands], dim=-1)


@functools.lru_cache(maxsize=None)
def _dct_basis(n: int, k: int, fmt_name: str, dtype: torch.dtype,
               device: str) -> torch.Tensor:
    basis = np.cos(np.pi / n * (np.arange(n) + 0.5)[None, :]
                   * np.arange(k)[:, None])
    return _rounded_table(basis, fmt_name, dtype, device)


@functools.lru_cache(maxsize=None)
def _mel_filterbank(n: int, sr: float, n_mel: int, fmt_name: str,
                    dtype: torch.dtype, device: str) -> torch.Tensor:
    fmax = sr / 2
    mel = lambda f: 2595 * np.log10(1 + f / 700)  # noqa: E731
    imel = lambda m: 700 * (10 ** (m / 2595) - 1)  # noqa: E731
    pts = imel(np.linspace(mel(20), mel(fmax), n_mel + 2))
    bins = np.clip((pts / fmax * (n - 1)).astype(int), 0, n - 1)
    fb = np.zeros((n_mel, n))
    for i in range(n_mel):
        a, b, c = bins[i], bins[i + 1], bins[i + 2]
        if b > a:
            fb[i, a:b] = np.linspace(0, 1, b - a, endpoint=False)
        if c > b:
            fb[i, b:c] = np.linspace(1, 0, c - b, endpoint=False)
    return _rounded_table(fb, fmt_name, dtype, device)


def mfcc(ar: Arith, psd: torch.Tensor, sr: float, n_mel: int = 20,
         n_coef: int = 13) -> torch.Tensor:
    fbq = _mel_filterbank(psd.shape[-1], sr, n_mel, ar.name, psd.dtype,
                          str(psd.device))
    energies = ar.matmul(psd, fbq.T)
    log_e = ar.log(torch.clamp(energies, min=1e-20))
    basis = _dct_basis(log_e.shape[-1], n_coef, ar.name, log_e.dtype,
                       str(log_e.device))
    return ar.matmul(log_e, basis.T)


def zero_crossing_rate(ar: Arith, x: torch.Tensor) -> torch.Tensor:
    flips = torch.abs(torch.diff(torch.sign(x), dim=-1)) > 1
    return ar.mean(flips.to(x.dtype), axis=-1)


def kurtosis(ar: Arith, x: torch.Tensor) -> torch.Tensor:
    mu = ar.mean(x, axis=-1)
    d = ar.sub(x, mu[..., None])
    d2 = ar.mul(d, d)
    m2 = ar.mean(d2, axis=-1)
    m4 = ar.mean(ar.mul(d2, d2), axis=-1)
    return ar.div(m4, torch.clamp(ar.mul(m2, m2), min=1e-20))


def rms(ar: Arith, x: torch.Tensor) -> torch.Tensor:
    return ar.sqrt(ar.mean(ar.mul(x, x), axis=-1))


def extract_features(ar: Arith, audio: torch.Tensor,
                     imu: torch.Tensor) -> torch.Tensor:
    """audio (B, 2, N) PCM-scale, imu (B, 9, M) → (B, 65) features."""
    B = audio.shape[0]
    a = audio[..., :FFT_N]
    if a.shape[-1] < FFT_N:
        a = F.pad(a, (0, FFT_N - a.shape[-1]))
    a = ar.rnd(a)
    psd = power_spectrum(ar, a)
    spec = spectral_features(ar, psd, AUDIO_SR)
    mf = mfcc(ar, psd, AUDIO_SR)
    im = ar.rnd(imu)
    feats = torch.cat([spec.reshape(B, -1), mf.reshape(B, -1),
                       zero_crossing_rate(ar, im), kurtosis(ar, im),
                       rms(ar, im)], dim=-1)
    return ar.rnd(feats)


@dataclasses.dataclass
class Trees:
    """Fixed-depth trees as arrays: feature index (-1 = leaf), threshold,
    leaf probability; node i's children are 2i+1 and 2i+2."""

    feat: np.ndarray
    thresh: np.ndarray
    value: np.ndarray
    depth: int


def forest_votes(ar: Arith, trees: Trees, X: torch.Tensor) -> torch.Tensor:
    """P(cough) (B,): each tree walked on the rounded features against
    rounded thresholds, the leaf values summed by a rounded matmul row and
    divided by the tree count."""
    dev, dt = X.device, X.dtype
    feat = torch.as_tensor(trees.feat, dtype=torch.int64, device=dev)
    thresh = ar.rnd(torch.as_tensor(trees.thresh).to(device=dev, dtype=dt))
    value = ar.rnd(torch.as_tensor(trees.value).to(device=dev, dtype=dt))
    T = feat.shape[0]
    B = X.shape[0]
    idx = torch.arange(T, device=dev)[None]
    node = torch.zeros((B, T), dtype=torch.int64, device=dev)
    for _ in range(trees.depth):
        f = feat[idx, node]
        th = thresh[idx, node]
        x = torch.gather(X, 1, torch.clamp(f, min=0))
        nxt = torch.where(x <= th, 2 * node + 1, 2 * node + 2)
        node = torch.where(f < 0, node, nxt)
    probs = value[idx, node]
    votes = ar.matmul(probs, torch.ones((T, 1), dtype=dt, device=dev))[..., 0]
    return ar.div(votes, float(T))


def cough_scores(fmt: str, trees: Trees, audio: torch.Tensor,
                 imu: torch.Tensor) -> torch.Tensor:
    ar = Arith.make(fmt)
    return forest_votes(ar, trees, extract_features(ar, audio, imu))


# ---------------------------------------------------------------------------
# Offline CART training in float64 (a copy of the port's, which copies the
# JAX package's): the benchmark trains the forest that both sides score.
# ---------------------------------------------------------------------------

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
        feats = rng.choice(X.shape[1], n_feat_sub or X.shape[1],
                           replace=False)
        best = (None, None, np.inf)
        for f in feats:
            vals = X[idx, f]
            for t in np.quantile(vals, np.linspace(0.1, 0.9, 9)):
                left = idx[vals <= t]
                right = idx[vals > t]
                if len(left) < min_leaf or len(right) < min_leaf:
                    continue
                score = (len(left) * _gini(y[left])
                         + len(right) * _gini(y[right]))
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


def train_trees(X: np.ndarray, y: np.ndarray, n_trees: int, depth: int,
                seed: int) -> Trees:
    rng = np.random.default_rng(seed)
    n = len(y)
    n_feat_sub = max(2, int(np.sqrt(X.shape[1])))
    parts = []
    for _ in range(n_trees):
        boot = rng.integers(0, n, n)
        parts.append(_train_tree(X[boot], y[boot], rng, depth,
                                 n_feat_sub=n_feat_sub))
    f, t, v = (np.stack(p) for p in zip(*parts))
    return Trees(f, t, v, depth)
