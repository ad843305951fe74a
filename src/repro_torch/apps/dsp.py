"""Format-parametrized DSP: iterative radix-2 FFT, PSD, spectral statistics,
MFCC — every arithmetic op rounded to the chosen format through ``Arith``.

The counterpart of ``repro.apps.dsp``, with the same rounded ops in the same
order (so posit FFT outputs are bit-identical to the reference's) and the
same exact identities behind ``rfft_format``:

* rounding is idempotent, and both lattices are symmetric under negation;
* for a real input the stage-1 twiddle is (1, ±0) and the imaginary plane
  is zero, so stage 1 is a real add/sub butterfly and stage 2 collapses to
  ``t = (wr·o_re, wi·o_re)`` with ``u_im/v_im = ±t_im`` (posit formats
  only: they never overflow to ±Inf, so the collapses hold for any finite
  input);
* a real input's power spectrum reads only bins 0..n/2, so the final
  stage computes u and the Nyquist bin only.

Tables (per-stage twiddles, mel filterbank, DCT basis) are built in numpy,
pre-rounded through the target format once, and cached per device.
"""
from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch

from repro_torch.core.arith import Arith, get_fused_kernels, get_round_backend
from repro_torch.kernels.posit_fft import (MIN_RUN, posit_fft_stages,
                                           posit_fft_stages_torch)


def _rounded_table(values: np.ndarray, fmt_name: str, dtype: torch.dtype,
                   device: str) -> torch.Tensor:
    """``values`` rounded through the format (on the CPU), then placed on
    ``device`` once."""
    t = Arith.make(fmt_name).rnd(torch.as_tensor(values).to(dtype))
    return t.to(device)


class FFTPlan:
    """Cached, pre-rounded twiddles for one (n, format, dtype, device) FFT:
    ``stages[s]`` holds the stage-(s+1) twiddles ``(wr, wi)``, and
    ``table`` all of them as one ``(2, n - 1)`` tensor (stage ``s`` at
    offset ``2^s - 1``), which the stage-range kernel reads.  No
    bit-reversal table: the stage loops use the self-sorting Stockham
    layout and never permute."""

    def __init__(self, n: int, fmt_name: str, dtype: torch.dtype,
                 device: str):
        assert n & (n - 1) == 0, "power-of-two FFT"
        self.n = n
        self.levels = n.bit_length() - 1
        self.stages: List[Tuple[torch.Tensor, torch.Tensor]] = []
        for s in range(1, self.levels + 1):
            m = 1 << s
            ang = -2.0 * np.pi * np.arange(m // 2) / m
            self.stages.append(
                (_rounded_table(np.cos(ang), fmt_name, dtype, device),
                 _rounded_table(np.sin(ang), fmt_name, dtype, device)))
        self.table = torch.stack([
            torch.cat([w[c] for w in self.stages]) if self.stages
            else torch.zeros(0, dtype=dtype, device=device) for c in (0, 1)])


@functools.lru_cache(maxsize=None)
def get_fft_plan(n: int, fmt_name: str, dtype: torch.dtype,
                 device: str) -> FFTPlan:
    return FFTPlan(n, fmt_name, dtype, device)


def _plan_for(ar: Arith, x: torch.Tensor) -> FFTPlan:
    return get_fft_plan(x.shape[-1], ar.name, x.dtype, str(x.device))


def _twiddle_mul(ar: Arith, o_re, o_im, wr, wi):
    """``t = w ⊗ o``: 4 mul + 2 add, each rounded.  Quire mode: each
    component is one fused two-term accumulation with a single rounding
    (``Arith.fdot2``; ``−wi`` is exact, posit lattices being symmetric)."""
    if ar.quire:
        return (ar.fdot2(wr, o_re, -wi, o_im),
                ar.fdot2(wr, o_im, wi, o_re))
    return (ar.sub(ar.mul(wr, o_re), ar.mul(wi, o_im)),
            ar.add(ar.mul(wr, o_im), ar.mul(wi, o_re)))


def _butterfly(ar: Arith, e_re, e_im, o_re, o_im, wr, wi):
    """t = w ⊗ o (rounded per ``_twiddle_mul``); u = e + t; v = e − t."""
    t_re, t_im = _twiddle_mul(ar, o_re, o_im, wr, wi)
    return (ar.add(e_re, t_re), ar.add(e_im, t_im),
            ar.sub(e_re, t_re), ar.sub(e_im, t_im))


# Stockham stage layout: state is (..., L, R) "transposed" early and
# (..., R, L) "natural" late, with L the sub-DFT length completed so far and
# R = n / L.  Both split butterfly partners into contiguous blocks; the one
# transposed→natural switch happens when the split runs would drop below
# MIN_RUN elements (the stage-range kernel's own rule).


def _stage_split(z_re, z_im, R: int, transposed: bool):
    if transposed:  # (..., L, R): partners along the last axis
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


# ---------------------------------------------------------------------------
# Fused stage loop: state stacked as z (2, ..., L, R), axis 0 the (re, im)
# planes, so a stage is three rounded calls (products, twiddle joins, u ++ v;
# ``posit_fft_stages_torch``) instead of ten — or, under the kernel backend,
# a whole range of stages is one ``posit_fft_stages`` launch.  The same elementary rounded ops in the
# same order as ``_butterfly``, hence bit-identical to the unfused loop.
# Under quire mode the twiddle join is two fused two-term accumulations per
# output, as in the unfused quire butterfly; the kernel, which rounds every
# product, is bypassed.
# ---------------------------------------------------------------------------

def _quire_stage(ar: Arith, z: torch.Tensor, wr: torch.Tensor,
                 wi: torch.Tensor, R: int, tr: bool) -> torch.Tensor:
    nb = z.dim() - 3                       # batch dims between stack and L/R
    if tr:
        e, o = z[..., : R // 2], z[..., R // 2:]
    else:
        e, o = z[..., : R // 2, :], z[..., R // 2:, :]
    shp = (*([1] * nb), -1, 1) if tr else (*([1] * nb), 1, -1)
    t = torch.stack(_twiddle_mul(ar, o[0], o[1], wr.reshape(shp),
                                 wi.reshape(shp)))
    return ar.rnd(torch.cat([e + t, e - t], dim=-2 if tr else -1))


def _fused_stages(ar: Arith, z: torch.Tensor, plan: FFTPlan, s0: int,
                  s1: int) -> Tuple[torch.Tensor, bool]:
    """Stages ``s0 .. s1-1`` of the fused loop on ``z`` held transposed:
    returns the state after them and whether it is still transposed.
    Quire off, the range is one ``posit_fft_stages`` call under the kernel
    backend and its plain stage loop under the others."""
    if not ar.quire:
        if get_round_backend(z) == "kernel":
            return posit_fft_stages(z, plan.table, s0, s1, ar.fmt)
        return posit_fft_stages_torch(z, plan.table, s0, s1, ar.fmt,
                                      ar.rnd)
    tr = True
    for s in range(s0, s1):
        R = plan.n >> s
        if tr and R // 2 < MIN_RUN:
            z = z.transpose(-1, -2)
            tr = False
        z = _quire_stage(ar, z, *plan.stages[s], R, tr)
    return z, tr


def _fused_final_rstage(ar: Arith, z: torch.Tensor, plan: FFTPlan
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pruned final stage of the real-input split (natural layout): only u
    (bins 0..n/2−1) and v[0] (Nyquist) are computed."""
    rnd = ar.rnd
    wr, wi = plan.stages[-1]
    e_re, o_re = z[0, ..., 0, :], z[0, ..., 1, :]
    e_im, o_im = z[1, ..., 0, :], z[1, ..., 1, :]
    if ar.quire:
        t = torch.stack(_twiddle_mul(ar, o_re, o_im, wr, wi))
    else:
        P = rnd(torch.stack([wr * o_re, wi * o_im, wr * o_im, wi * o_re]))
        t = rnd(torch.stack([P[0] - P[1], P[2] + P[3]]))
    u = rnd(torch.stack([e_re + t[0], e_im + t[1]]))
    ny = rnd(torch.stack([e_re[..., :1] - t[0][..., :1],
                          e_im[..., :1] - t[1][..., :1]]))
    return (torch.cat([u[0], ny[0]], dim=-1),
            torch.cat([u[1], ny[1]], dim=-1))


def fft_format(ar: Arith, re: torch.Tensor, im: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Iterative radix-2 FFT over the last axis, every op rounded."""
    n = re.shape[-1]
    plan = _plan_for(ar, re)
    if not (get_fused_kernels() and ar.is_posit):
        return _fft_unfused(ar, re, im, plan)
    z = ar.rnd(torch.stack([re, im]))[..., None, :]  # (2, ..., L=1, n)
    z, tr = _fused_stages(ar, z, plan, 0, plan.levels)
    if tr:
        z = z.transpose(-1, -2)                      # (2, ..., 1, n)
    z = z.reshape(2, *z.shape[1:-2], n)
    return z[0], z[1]


def _fft_unfused(ar: Arith, re: torch.Tensor, im: torch.Tensor,
                 plan: FFTPlan) -> Tuple[torch.Tensor, torch.Tensor]:
    """The per-op stage loop: the oracle the fused loop is tested against."""
    n = re.shape[-1]
    zr = ar.rnd(re)[..., None, :]          # transposed start: (..., L=1, n)
    zi = ar.rnd(im)[..., None, :]
    tr = True
    for t, (wr, wi) in enumerate(plan.stages):
        R = n >> t
        if tr and R // 2 < MIN_RUN:
            zr, zi = _to_natural(zr, zi, tr)
            tr = False
        e_re, e_im, o_re, o_im = _stage_split(zr, zi, R, tr)
        u_re, u_im, v_re, v_im = _butterfly(ar, e_re, e_im, o_re, o_im,
                                            _stage_tw(wr, tr),
                                            _stage_tw(wi, tr))
        zr = _stage_join(u_re, v_re, tr)
        zi = _stage_join(u_im, v_im, tr)
    zr, zi = _to_natural(zr, zi, tr)       # (..., 1, n) either way
    return (zr.reshape(*zr.shape[:-2], n), zi.reshape(*zi.shape[:-2], n))


def rfft_format(ar: Arith, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """FFT of a real last axis, bins 0 .. n/2 only (re, im): bit-identical
    to ``fft_format(ar, x, 0)[..., :n//2+1]``."""
    n = x.shape[-1]
    plan = _plan_for(ar, x)
    if plan.levels < 3:  # tiny sizes: no stages left to prune
        re, im = fft_format(ar, x, torch.zeros_like(x))
        return re[..., : n // 2 + 1], im[..., : n // 2 + 1]
    if get_fused_kernels() and ar.is_posit:
        return _rfft_fused(ar, x, plan)
    return _rfft_unfused(ar, x, plan)


def _rfft_fused(ar: Arith, x: torch.Tensor, plan: FFTPlan
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked realization of the posit rfft split (the middle stages one
    kernel launch under the kernel backend) — bit-identical to
    ``_rfft_unfused``."""
    n = x.shape[-1]
    rnd = ar.rnd
    zr = rnd(x)[..., None, :]              # transposed start: (..., 1, n)
    # stage 1: pure real add/sub butterfly, join fused into the rounding
    e, o = zr[..., : n // 2], zr[..., n // 2:]
    zr = rnd(torch.cat([e + o, e - o], dim=-2))
    # stage 2: t = (wr·o, wi·o); u_im = t_im, v_im = −t_im (exact)
    R = n >> 1
    wr, wi = plan.stages[1][0][:, None], plan.stages[1][1][:, None]
    e, o = zr[..., : R // 2], zr[..., R // 2:]
    t = rnd(torch.stack([wr * o, wi * o]))
    z = torch.stack([rnd(torch.cat([e + t[0], e - t[0]], dim=-2)),
                     torch.cat([t[1], -t[1]], dim=-2)])
    z, tr = _fused_stages(ar, z, plan, 2, plan.levels - 1)
    if tr:
        z = z.transpose(-1, -2)
    return _fused_final_rstage(ar, z, plan)


def _rfft_unfused(ar: Arith, x: torch.Tensor, plan: FFTPlan
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    n = x.shape[-1]
    zr = ar.rnd(x)[..., None, :]           # transposed start: (..., 1, n)
    tr = True
    if ar.is_posit:
        # stage 1: w = (1, +0) → t = o; the imaginary plane stays zero
        e_re, o_re = zr[..., : n // 2], zr[..., n // 2:]
        zr = _stage_join(ar.add(e_re, o_re), ar.sub(e_re, o_re), tr)
        # stage 2: t = (wr·o_re, wi·o_re), u_im = t_im, v_im = −t_im
        R = n >> 1
        wr = _stage_tw(plan.stages[1][0], tr)
        wi = _stage_tw(plan.stages[1][1], tr)
        e_re, o_re = zr[..., : R // 2], zr[..., R // 2:]
        t_re = ar.mul(wr, o_re)
        t_im = ar.mul(wi, o_re)
        zr = _stage_join(ar.add(e_re, t_re), ar.sub(e_re, t_re), tr)
        zi = _stage_join(t_im, -t_im, tr)
        start = 2
    else:
        # IEEE formats can overflow mid-FFT: honest butterflies on an
        # explicit zero imaginary plane reproduce the naive path's NaNs
        zi = torch.zeros_like(zr)
        start = 0
    for s in range(start, plan.levels - 1):
        R = n >> s
        if tr and R // 2 < MIN_RUN:
            zr, zi = _to_natural(zr, zi, tr)
            tr = False
        wr, wi = plan.stages[s]
        e_re, e_im, o_re, o_im = _stage_split(zr, zi, R, tr)
        u_re, u_im, v_re, v_im = _butterfly(ar, e_re, e_im, o_re, o_im,
                                            _stage_tw(wr, tr),
                                            _stage_tw(wi, tr))
        zr = _stage_join(u_re, v_re, tr)
        zi = _stage_join(u_im, v_im, tr)
    # final stage (R = 2, natural layout): u and the Nyquist bin only
    zr, zi = _to_natural(zr, zi, tr)
    wr, wi = plan.stages[-1]
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
    """|FFT|² of a real signal (first N/2+1 bins, via the rfft split)."""
    re, im = rfft_format(ar, x)
    return ar.add(ar.mul(re, re), ar.mul(im, im))


def spectral_features(ar: Arith, psd: torch.Tensor, sr: float
                      ) -> torch.Tensor:
    """Centroid, rolloff (85%), and 4 log-spaced band-energy ratios.  One
    rounded prefix-sum pass serves both the rolloff threshold and the
    total energy (its last prefix)."""
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


def _dct2(ar: Arith, x: torch.Tensor, k: int) -> torch.Tensor:
    basis = _dct_basis(x.shape[-1], k, ar.name, x.dtype, str(x.device))
    return ar.matmul(x, basis.T)


def mfcc(ar: Arith, psd: torch.Tensor, sr: float, n_mel: int = 20,
         n_coef: int = 13) -> torch.Tensor:
    """Mel-frequency cepstral coefficients from a (rounded) PSD: filterbank
    and DCT-II rows through ``Arith.matmul``."""
    fbq = _mel_filterbank(psd.shape[-1], sr, n_mel, ar.name, psd.dtype,
                          str(psd.device))
    energies = ar.matmul(psd, fbq.T)
    log_e = ar.log(torch.clamp(energies, min=1e-20))
    return _dct2(ar, log_e, n_coef)


# time-domain features (IMU)

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
