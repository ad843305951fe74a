"""Per-window energy/latency accounting wired to the paper's ASIC model
(the counterpart of ``repro.stream.accounting``).

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
auditable next to the throughput it buys.  The ingest layer's transport
column (``TransportStats``) sits beside them, per patient.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.core.arith import get_quire
from repro_torch.data.biosignals import IMU_SR, WINDOW_S
from repro_torch.energy.model import (OpCounts, estimate_app_energy_nj,
                                     fft_op_counts)


def energy_config_for_format(fmt: str) -> str:
    """Map an arithmetic format to the paper's power corner."""
    return "coprosit" if fmt.startswith("posit") else "fpu_ss"


def window_energy_nj(ops: OpCounts, fmt: str, quire: bool = None) -> float:
    """Modelled energy of ONE window of ``ops`` executed in ``fmt``.

    Width-aware on the posit corner (``estimate_app_energy_nj(fmt=...)``):
    an escalated posit8→posit16 window costs measurably more.

    ``quire=None`` reads the live quire switch (``core.arith.get_quire``),
    so the ledger bills whatever mode computed the window.  Only the posit
    corner has a quire; IEEE windows price identically in both modes."""
    if quire is None:
        quire = get_quire()
    config = energy_config_for_format(fmt)
    return estimate_app_energy_nj(ops, config, fmt=fmt,
                                  quire=bool(quire) and config == "coprosit")


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


@dataclasses.dataclass
class TransportStats:
    """Per-patient transport/session counters (the ingest layer's column).

    Maintained by ``repro_torch.ingest.SessionManager`` /
    ``StreamEngine.evict_patient``; zero-cost for in-process callers that
    never touch the transport path.
    """

    frames: int = 0               # DATA frames received (incl. dups/held)
    bytes: int = 0                # payload bytes of those frames
    dup_frames: int = 0           # dropped as duplicates
    replayed_frames: int = 0      # re-sent by the client after a reconnect
                                  # (client-reported; deduped into
                                  # exactly-once by the seq logic)
    reordered_frames: int = 0     # arrived early, held in the reorder buffer
    gap_events: int = 0           # in-order → gapped transitions
    connects: int = 0             # HELLOs (reconnects = connects - 1)
    late_frames: int = 0          # arrived after eviction, dropped
    abandoned_frames: int = 0     # held for a gap that never filled, lost
    evictions: int = 0            # stall-timeout evictions (0 or 1)
    modality_stalls: int = 0      # per-modality dropouts noted while the
                                  # session stayed live on other modalities
    windows_flushed: int = 0      # complete windows dispatched at close
    windows_dropped: int = 0      # pending windows lost (eviction flush
                                  # failed on an unroutable stream)
    staged_freed: int = 0         # partial staged slices freed at close


class EnergyLedger:
    def __init__(self):
        self.stats: Dict[Tuple[str, str], GroupStats] = {}
        # per-patient escalation attribution: extra nJ spent above the
        # patient's static format, and how many windows it covered
        self.escalation: Dict[str, Dict[str, float]] = {}
        # per-patient transport/session counters (ingest layer)
        self.transport: Dict[str, TransportStats] = {}

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

    def record_transport(self, patient: str, **deltas: int) -> None:
        """Accumulate transport counters for one patient; ``deltas`` keys
        must be ``TransportStats`` fields (typo-safe: unknown keys raise)."""
        t = self.transport.setdefault(patient, TransportStats())
        for k, v in deltas.items():
            setattr(t, k, getattr(t, k) + v)  # AttributeError on a typo

    def rows(self) -> Dict[str, Dict[str, float]]:
        """Raw per-(task, format) totals keyed ``"task/fmt"`` — the
        mergeable form a multi-process worker would ship to its
        supervisor, which sums fields across workers and re-derives the
        fleet rollup."""
        return {f"{task}/{fmt}": dataclasses.asdict(g)
                for (task, fmt), g in sorted(self.stats.items())}

    def transport_summary(self) -> Dict[str, Dict[str, int]]:
        """{patient: counters} plus a "fleet" rollup row (sums)."""
        out = {p: dataclasses.asdict(t)
               for p, t in sorted(self.transport.items())}
        fleet = dataclasses.asdict(TransportStats())
        for row in out.values():
            for k, v in row.items():
                fleet[k] += v
        out["fleet"] = fleet
        return out

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
