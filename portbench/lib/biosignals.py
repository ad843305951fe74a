"""Synthetic biosignals from a seed: the fleet's traffic.

A frozen copy of the port's generators (``src/repro_torch/data/
biosignals.py``), kept with the benchmark so that the yardstick's inputs do
not move with the program.  Shaped after the paper's datasets (which are
not redistributable):

* Cough-detection windows: 300 ms of 2-mic audio (16 kHz, 24-bit PCM
  scale) + 9-axis IMU (100 Hz, 16-bit); four event classes in equal parts:
  cough, laugh, deep breath, throat clear.
* BayeSlope ECG: an incremental cycle-ergometer test, HR ramping 60→180
  bpm while EMG noise and baseline wander grow with intensity.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

AUDIO_SR = 16_000
IMU_SR = 100
WINDOW_S = 0.3
# Audio kept at raw integer scale (the embedded pipeline's premise). 2^20
# calibrates |FFT|^2 right at posit16's upper range (2^56) while swamping
# FP16 — the paper's Fig. 4 regime.
PCM_SCALE = 2.0 ** 17
IMU_SCALE = 2.0 ** 15          # 16-bit encoding

ECG_FS = 250


# ---------------------------------------------------------------------------
# Cough detection
# ---------------------------------------------------------------------------

def _burst(n, rng, f_lo, f_hi, decay, sr=AUDIO_SR):
    """Band-limited noise burst with exponential decay envelope."""
    t = np.arange(n) / sr
    noise = rng.normal(size=n)
    # crude bandpass via FFT masking
    spec = np.fft.rfft(noise)
    freqs = np.fft.rfftfreq(n, 1 / sr)
    spec[(freqs < f_lo) | (freqs > f_hi)] = 0
    sig = np.fft.irfft(spec, n)
    env = np.exp(-t * decay)
    sig = sig * env
    return sig / (np.abs(sig).max() + 1e-12)


def cough_window(rng) -> Tuple[np.ndarray, np.ndarray, int]:
    """Returns (audio[2, N], imu[9, M], label). label=1 for cough."""
    n = int(AUDIO_SR * WINDOW_S)
    m = int(IMU_SR * WINDOW_S)
    kind = rng.integers(0, 4)  # 0 cough, 1 laugh, 2 breath, 3 throat-clear
    t_imu = np.arange(m) / IMU_SR

    if kind == 0:     # cough: explosive burst + sharp IMU jerk
        a = _burst(n, rng, rng.uniform(220, 350), rng.uniform(2400, 4200),
                   rng.uniform(8, 20)) * rng.uniform(0.2, 1.0)
        imu_env = np.exp(-((t_imu - rng.uniform(0.03, 0.08)) ** 2) / 0.001)
        imu = rng.normal(0, 0.06, (9, m)) + imu_env * rng.uniform(0.4, 2.6)
    elif kind == 1:   # laugh: periodic voiced bursts
        a = np.zeros(n)
        for k in range(3):
            seg = _burst(n, rng, 100, rng.uniform(1000, 2200), 8)
            a += np.roll(seg, k * n // 3) * 0.5
        a *= rng.uniform(0.3, 1.0)
        imu = rng.normal(0, 0.08, (9, m)) + 0.3 * np.sin(
            2 * np.pi * 4 * t_imu) * rng.uniform(0.5, 1.5)
    elif kind == 2:   # deep breath: low-frequency airflow noise
        a = _burst(n, rng, 50, rng.uniform(500, 900), 2) * rng.uniform(0.1, 0.4)
        imu = rng.normal(0, 0.04, (9, m)) + 0.1 * np.sin(
            2 * np.pi * 1.5 * t_imu)
    else:             # throat clear: heavy overlap with cough in band,
        # decay and IMU jerk — only joint spectro-temporal stats separate them
        a = _burst(n, rng, rng.uniform(210, 340), rng.uniform(2300, 4000),
                   rng.uniform(6, 16)) * rng.uniform(0.22, 0.95)
        imu_env = np.exp(-((t_imu - rng.uniform(0.04, 0.09)) ** 2) / 0.0015)
        imu = rng.normal(0, 0.06, (9, m)) + imu_env * rng.uniform(0.35, 2.2)

    audio = np.stack([a, np.roll(a, rng.integers(0, 8))])  # 2 mics, delay
    audio = audio + rng.normal(0, 0.05, audio.shape)
    # raw PCM-integer scale — the embedded pipeline operates on these values
    audio = np.round(audio * 0.5 * PCM_SCALE)
    imu = np.round(imu / 8.0 * IMU_SCALE)  # ±8g mapped onto int16
    return audio.astype(np.float64), imu.astype(np.float64), int(kind == 0)


def cough_dataset(n_windows: int = 200, seed: int = 0,
                  label_noise: float = 0.03):
    """label_noise models the annotation noise of real field recordings
    (sets the achievable AUC ceiling near the paper's 0.92)."""
    rng = np.random.default_rng(seed)
    audios, imus, labels = [], [], []
    for _ in range(n_windows):
        a, i, y = cough_window(rng)
        if rng.uniform() < label_noise:
            y = 1 - y
        audios.append(a)
        imus.append(i)
        labels.append(y)
    return np.stack(audios), np.stack(imus), np.asarray(labels)


# ---------------------------------------------------------------------------
# BayeSlope ECG
# ---------------------------------------------------------------------------

def ecg_segment(duration_s: float, intensity: float, rng,
                fs: int = ECG_FS) -> Tuple[np.ndarray, np.ndarray]:
    """Synthetic exercise ECG. Returns (signal, r_peak_sample_indices).

    intensity ∈ [0,1]: scales HR (60→180 bpm), EMG noise, baseline wander —
    the regime where BayeSlope's Bayesian prior earns its keep.
    """
    n = int(duration_s * fs)
    hr = 60 + 120 * intensity
    rr_mean = 60.0 / hr
    t = 0.12  # start offset
    peaks = []
    while t < duration_s - 0.05:
        peaks.append(t)
        t += rr_mean * (1 + 0.05 * rng.normal())
    sig = np.zeros(n)
    ts = np.arange(n) / fs
    amp = 1.2 * (1.0 + 0.6 * intensity)  # exercise raises R amplitude
    for p in peaks:
        # QRS complex: R spike with Q/S dips; T wave
        sig += amp * np.exp(-((ts - p) ** 2) / (2 * 0.008 ** 2))
        sig -= 0.25 * np.exp(-((ts - p + 0.025) ** 2) / (2 * 0.01 ** 2))
        sig -= 0.30 * np.exp(-((ts - p - 0.03) ** 2) / (2 * 0.012 ** 2))
        sig += 0.3 * np.exp(-((ts - p - 0.18) ** 2) / (2 * 0.04 ** 2))
    # baseline wander grows with motion
    sig += (0.1 + 0.4 * intensity) * np.sin(2 * np.pi * 0.33 * ts + rng.uniform(0, 6))
    # EMG noise
    sig += rng.normal(0, 0.02 + 0.15 * intensity, n)
    # electrode scaling: mV → ADC-ish units with wide dynamic range
    # (calibrated so 16-bit IEEE saturates only under intense exercise,
    # 8-bit e4m3 always saturates — the paper's Fig. 5 regime)
    sig = sig * 200.0
    r_idx = np.asarray([int(round(p * fs)) for p in peaks])
    return sig, r_idx


# ---------------------------------------------------------------------------
# Continuous per-patient streams (the runtime's ingest side): the same
# generators as above, but emitted as one long recording per patient plus a
# ragged chunker that models BLE/radio packetization.
# ---------------------------------------------------------------------------

def ecg_stream_signal(duration_s: float, seed: int, n_phases: int = 4,
                      fs: int = ECG_FS) -> Tuple[np.ndarray, np.ndarray]:
    """One patient's continuous exercise ECG: intensity ramps across
    ``n_phases`` contiguous segments (rest → intense). Returns
    (signal(n,), r_peak_sample_indices) with EXACTLY
    ``round(duration_s·fs)`` samples — callers size ``duration_s`` to cover
    whole windows, so per-phase flooring must not eat the last one."""
    rng = np.random.default_rng(seed)
    n_total = int(round(duration_s * fs))
    base, rem = divmod(n_total, n_phases)
    sigs, peaks, offset = [], [], 0
    for p in range(n_phases):
        n_p = base + (1 if p < rem else 0)
        intensity = p / max(n_phases - 1, 1)
        # generate one sample long, then trim to the exact phase length
        sig, r = ecg_segment((n_p + 1) / fs, intensity, rng, fs)
        sig, r = sig[:n_p], r[r < n_p]
        sigs.append(sig)
        peaks.append(r + offset)
        offset += n_p
    return np.concatenate(sigs), np.concatenate(peaks)


def ragged_chunks(arr: np.ndarray, rng, min_samples: int, max_samples: int):
    """Split ``arr`` along its LAST axis into contiguous chunks of random
    length in [min_samples, max_samples] — the radio-packet arrival model.
    Yields views in stream order; concatenating them reproduces ``arr``."""
    n = arr.shape[-1]
    pos = 0
    while pos < n:
        k = int(rng.integers(min_samples, max_samples + 1))
        k = min(k, n - pos)
        yield arr[..., pos: pos + k]
        pos += k
