"""PrecisionRouter: which arithmetic format serves which patient stream.

The paper's per-application result (posit16 for cough, posit10 for R-peak) is
a *routing table*, not a global constant: a fleet mixes tasks, and individual
patients can be pinned to a different format (e.g. a clinician requests fp32
for a high-risk patient, or an A/B arm runs posit8).  Same-format windows are
grouped into one dispatch so the engine compiles one function per
(task, format) pair and batches across patients.

On top of the static table sits an optional XBioSiP-style quality-feedback
escalation (Prabakaran et al.): when a patient's candidate scores land
within ``margin`` of the adaptive decision threshold — the regime where the
format's resolution, not the signal, is deciding beats — the patient climbs
one rung of the precision ladder (posit8 → posit10 → posit16 by default) for
at least the next ``hold_windows`` windows.  De-escalation requires the hold
to expire AND ``hysteresis`` consecutive clean windows, and is refused while
a just-accepted beat's refractory period still spans the tracker's commit
frontier (changing the arithmetic mid-beat-decision would make the stitched
boundary depend on the policy, not the signal).  The ledger attributes the
extra nJ of every escalated window to the escalation column.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core.policy import (QuantPolicy, STREAM_TASK_FORMATS,
                               wearable_policy)

from .ring import Window


@dataclasses.dataclass(frozen=True)
class Route:
    """Resolved precision assignment for one patient stream."""

    fmt: str
    policy: QuantPolicy


@dataclasses.dataclass(frozen=True)
class EscalationPolicy:
    """Quality-feedback precision escalation (see module docstring).

    ``margin``: a window escalates when its closest candidate local maximum
    lies within this distance of the 2-means threshold (GLF scores live in
    [0, 1], so this is an absolute margin on that scale).
    ``hold_windows``: minimum windows spent on a rung after escalating.
    ``hysteresis``: consecutive clean (not-near-boundary) windows required
    before stepping one rung back down.
    """

    ladder: Tuple[str, ...] = ("posit8", "posit10", "posit16")
    margin: float = 0.08
    hold_windows: int = 4
    hysteresis: int = 2


@dataclasses.dataclass
class EscalationState:
    """Escalation ladder position for one (patient, task) stream."""

    base: int                  # static rung (the paper-table/pinned format)
    rung: int                  # current rung, base ≤ rung < len(ladder)
    hold: int = 0              # windows left before de-escalation allowed
    clean: int = 0             # consecutive clean windows seen
    escalations: int = 0       # rung-up events (for fleet stats)


class PrecisionRouter:
    def __init__(self,
                 task_formats: Optional[Dict[str, str]] = None,
                 patient_formats: Optional[Dict[str, str]] = None,
                 escalation: Optional[EscalationPolicy] = None):
        """``task_formats``: per-task default (falls back to the paper table);
        ``patient_formats``: per-patient override, highest priority;
        ``escalation``: optional quality-feedback policy — applies to
        patients whose static format is on the policy's ladder."""
        self.task_formats = dict(STREAM_TASK_FORMATS)
        if task_formats:
            self.task_formats.update(task_formats)
        self.patient_formats = dict(patient_formats or {})
        self.escalation = escalation
        self._esc: Dict[Tuple[str, str], EscalationState] = {}

    def pin(self, patient: str, fmt: str) -> None:
        """Pin one patient to a format (takes effect at the next dispatch)."""
        self.patient_formats[patient] = fmt

    def base_route(self, patient: str, task: str) -> Route:
        """The static assignment (pin or task table), ignoring escalation."""
        fmt = self.patient_formats.get(patient) or self.task_formats.get(task)
        if fmt is None:
            raise KeyError(f"no format routed for task {task!r} "
                           f"(patient {patient!r})")
        return Route(fmt, wearable_policy(fmt))

    def route(self, patient: str, task: str) -> Route:
        base = self.base_route(patient, task)
        st = self._esc.get((patient, task))
        if st is None or self.escalation is None:
            return base
        ladder = self.escalation.ladder
        if base.fmt not in ladder:      # re-pinned off-ladder: pin wins
            return base
        rung = max(st.rung, ladder.index(base.fmt))
        if ladder[rung] == base.fmt:
            return base
        fmt = ladder[rung]
        return Route(fmt, wearable_policy(fmt))

    def observe(self, patient: str, task: str, boundary_gap: float,
                mid_refractory: bool = False) -> str:
        """Quality feedback for one processed window; returns the format the
        stream routes to from now on.

        ``boundary_gap`` comes from the tracker (min |candidate − thr|);
        ``mid_refractory`` blocks de-escalation while a boundary beat's
        refractory period is still open.  No-op without a policy, or for
        patients whose static format is off the ladder.
        """
        pol = self.escalation
        if pol is None:
            return self.route(patient, task).fmt
        base_fmt = self.base_route(patient, task).fmt
        if base_fmt not in pol.ladder:
            # re-pinned off the ladder mid-stream: drop any stale state so a
            # later on-ladder pin starts from its own base, and route the pin
            self._esc.pop((patient, task), None)
            return self.route(patient, task).fmt
        b = pol.ladder.index(base_fmt)
        st = self._esc.get((patient, task))
        if st is None:
            st = self._esc[(patient, task)] = EscalationState(base=b, rung=b)
        elif st.base != b:          # re-pinned mid-stream: rebase the ladder
            st.base = b
            st.rung = max(st.rung, b)
        near = boundary_gap <= pol.margin
        if near:
            st.clean = 0
            if st.rung < len(pol.ladder) - 1:
                st.rung += 1
                st.escalations += 1
            st.hold = pol.hold_windows
        else:
            st.clean += 1
            if st.rung > st.base:
                st.hold = max(st.hold - 1, 0)
                if (st.hold == 0 and st.clean >= pol.hysteresis
                        and not mid_refractory):
                    st.rung -= 1
                    st.hold = pol.hold_windows if st.rung > st.base else 0
        return self.route(patient, task).fmt

    def escalation_state(self, patient: str, task: str
                         ) -> Optional[EscalationState]:
        return self._esc.get((patient, task))

    def group(self, windows: Iterable[Window]
              ) -> Dict[Tuple[str, str], List[Window]]:
        """Group ready windows into dispatch batches keyed (task, fmt).

        Order within a group preserves arrival order, so per-patient window
        order survives batching.
        """
        groups: Dict[Tuple[str, str], List[Window]] = {}
        for w in windows:
            key = (w.task, self.route(w.patient, w.task).fmt)
            groups.setdefault(key, []).append(w)
        return groups
