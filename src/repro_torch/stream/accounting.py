"""Per-window energy/latency accounting wired to the paper's ASIC model
(the counterpart of ``repro.stream.accounting``, without the ingest layer's
transport column).

Arithmetic op counts per window are derived from the pipeline definitions
(the FFT dominates cough; the slope-product integration dominates R-peak) and
converted to nJ/window via ``energy.model.estimate_app_energy_nj`` — the same
cycles-per-op overhead calibrated on the paper's measured FFT-4096 run.
Posit-routed windows are costed on the Coprosit power corner — width-aware,
so a posit8 window is cheaper than a posit16 one — and IEEE-routed windows
on the FPU_ss corner (paper Tables IV/V).  Windows that ran above their
patient's static format because the escalation policy raised the rung are
additionally attributed per patient and per group (``escalation_summary`` /
the ``escalation_nj`` column), so the energy price of quality feedback is
auditable next to the throughput it buys.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.data.biosignals import IMU_SR, WINDOW_S
from repro_torch.energy.model import (OpCounts, estimate_app_energy_nj,
                                     fft_op_counts)


def energy_config_for_format(fmt: str) -> str:
    """Map an arithmetic format to the paper's power corner."""
    return "coprosit" if fmt.startswith("posit") else "fpu_ss"


def window_energy_nj(ops: OpCounts, fmt: str) -> float:
    """Model nJ for one window computed in ``fmt`` — corner selection plus
    posit-width-aware datapath power (``energy.model.power_total_uw``), so
    an escalated posit8→posit16 window costs measurably more.  Billed with
    the quire off, the only mode this package computes."""
    return estimate_app_energy_nj(ops, energy_config_for_format(fmt),
                                  fmt=fmt)


def cough_window_op_counts(fft_n: int = 4096, n_mel: int = 20,
                           n_coef: int = 13, audio_ch: int = 2,
                           imu_ch: int = 9, n_trees: int = 20,
                           depth: int = 6) -> OpCounts:
    """Arithmetic ops for one 300 ms cough window (both mics + IMU + forest).

    Counts follow the rounded-op structure of ``apps.dsp`` /
    ``apps.forest``; comparisons are integer ops on posit hardware and are
    not counted (they ride the ALU, paper §V).
    """
    ops = OpCounts()
    bins = fft_n // 2 + 1
    fft = fft_op_counts(fft_n)
    ops.add += audio_ch * fft.add
    ops.mul += audio_ch * fft.mul
    ops.quire_mac += audio_ch * fft.quire_mac       # twiddle cmuls fuse
    ops.quire_round += audio_ch * fft.quire_round
    # |X|² PSD: 2 mul + 1 add per bin (elementwise, not an accumulation —
    # no quire attribution)
    ops.mul += audio_ch * 2 * bins
    ops.add += audio_ch * bins
    # spectral stats: rolloff prefix sums (whose last prefix IS the total)
    # + centroid MAC + 4 band sums ≈ 3 add passes + 1 mul pass.  All four
    # are quire accumulations; the cumsum's every prefix pays its own
    # QROUND (no net rounding saving there — an honest column).
    ops.add += audio_ch * 3 * bins
    ops.mul += audio_ch * bins
    ops.div += audio_ch * 6
    ops.quire_mac += audio_ch * 4 * bins
    ops.quire_round += audio_ch * (bins + 1 + 4)
    # MFCC: mel filterbank MACs + log + DCT MACs — every MAC in the quire,
    # one QROUND per output row
    mac = n_mel * bins + n_coef * n_mel
    ops.mul += audio_ch * mac
    ops.add += audio_ch * mac
    ops.conv += audio_ch * n_mel          # table-based log
    ops.quire_mac += audio_ch * 2 * mac
    ops.quire_round += audio_ch * (n_mel + n_coef)
    # IMU time-domain features (zcr/kurtosis/rms) ≈ 7 ops/sample; the 4
    # accumulation adds per sample feed 5 means per channel
    n_imu = int(round(IMU_SR * WINDOW_S))
    ops.add += imu_ch * n_imu * 4
    ops.mul += imu_ch * n_imu * 3
    ops.div += imu_ch * 6
    ops.sqrt += imu_ch
    ops.quire_mac += imu_ch * n_imu * 4
    ops.quire_round += imu_ch * 5
    # forest vote aggregation: one MAC per tree (tree walks are gathers +
    # int compares), mean division
    ops.add += n_trees
    ops.mul += n_trees
    ops.div += 1
    ops.quire_mac += 2 * n_trees
    ops.quire_round += 1
    # ingest conversions: every sample the window core CONSUMES enters the
    # storage format once — audio is cropped to the FFT size before the
    # ingest rounding, so the cropped tail never touches the datapath
    ops.conv += audio_ch * fft_n + imu_ch * n_imu
    return ops


def rpeak_window_op_counts(n: int, k_integration: int = 25) -> OpCounts:
    """Arithmetic ops for one n-sample ECG window (BayeSlope stages 1–2).

    Quire columns: only the GLF normalization's mean over the window is an
    ``Arith`` accumulation (n adds, one QROUND); the k-tap moving
    integration is an elementwise shifted-add chain, which the quire does
    not fuse.
    """
    ops = OpCounts()
    ops.add += (k_integration + 3) * n    # moving integration + GLF adds
    ops.mul += n                          # slope products
    ops.div += 3 * n + 2                  # pre-scale, normalize, logistic
    ops.conv += 2 * n                     # exp table + sample ingest
    ops.quire_mac += n
    ops.quire_round += 1
    return ops


@dataclasses.dataclass
class GroupStats:
    """Running totals for one (task, format) dispatch group."""

    windows: int = 0
    batches: int = 0
    padded_windows: int = 0        # bucket-padding overhead, for visibility
    latency_s: float = 0.0         # summed wall-clock of dispatches
    energy_nj: float = 0.0
    escalated_windows: int = 0     # windows here because escalation raised fmt
    escalation_nj: float = 0.0     # their nJ above the patients' base formats


class EnergyLedger:
    def __init__(self):
        self.stats: Dict[Tuple[str, str], GroupStats] = {}
        # per-patient escalation attribution: extra nJ spent above the
        # patient's static format, and how many windows it covered
        self.escalation: Dict[str, Dict[str, float]] = {}

    def record(self, task: str, fmt: str, n_windows: int, n_padded: int,
               latency_s: float, ops_per_window: OpCounts,
               n_escalated: int = 0,
               escalation_extra_nj: float = 0.0) -> None:
        g = self.stats.setdefault((task, fmt), GroupStats())
        g.windows += n_windows
        g.batches += 1
        g.padded_windows += n_padded
        g.latency_s += latency_s
        g.energy_nj += window_energy_nj(ops_per_window, fmt) * n_windows
        g.escalated_windows += n_escalated
        g.escalation_nj += escalation_extra_nj

    def record_escalation(self, patient: str, extra_nj: float) -> None:
        """One escalated window for ``patient``: the nJ above its base
        format, attributed so per-patient escalation cost is auditable."""
        d = self.escalation.setdefault(patient,
                                       {"windows": 0, "extra_nj": 0.0})
        d["windows"] += 1
        d["extra_nj"] += extra_nj

    def escalation_summary(self) -> Dict[str, Dict[str, float]]:
        """Per-patient escalation attribution ({patient: windows/extra_nj})."""
        return {p: dict(d) for p, d in sorted(self.escalation.items())}

    def summary(self) -> Dict[str, Dict[str, float]]:
        """{"task/fmt": {...}} plus a "fleet" rollup row."""
        out: Dict[str, Dict[str, float]] = {}
        tot_w, tot_e, tot_t = 0, 0.0, 0.0
        tot_b, tot_p = 0, 0
        tot_esc_w, tot_esc_e = 0, 0.0
        for (task, fmt), g in sorted(self.stats.items()):
            out[f"{task}/{fmt}"] = {
                "windows": g.windows,
                "batches": g.batches,
                "padded_windows": g.padded_windows,
                "windows_per_s": g.windows / g.latency_s if g.latency_s else 0.0,
                "nj_per_window": g.energy_nj / g.windows if g.windows else 0.0,
                "total_nj": g.energy_nj,
                "escalated_windows": g.escalated_windows,
                "escalation_nj": g.escalation_nj,
            }
            tot_w += g.windows
            tot_e += g.energy_nj
            tot_t += g.latency_s
            tot_b += g.batches
            tot_p += g.padded_windows
            tot_esc_w += g.escalated_windows
            tot_esc_e += g.escalation_nj
        # schema-complete fleet row: same keys as every per-group row
        out["fleet"] = {
            "windows": tot_w,
            "batches": tot_b,
            "padded_windows": tot_p,
            "windows_per_s": tot_w / tot_t if tot_t else 0.0,
            "nj_per_window": tot_e / tot_w if tot_w else 0.0,
            "total_nj": tot_e,
            "escalated_windows": tot_esc_w,
            "escalation_nj": tot_esc_e,
        }
        return out
