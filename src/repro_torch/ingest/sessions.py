"""Session management: the exactly-once gate between transport and engine.

The ``StreamEngine``/``WindowDispatcher`` contract is strict — chunks
in-order within one (patient, modality) stream, each sample exactly once —
while a real transport delivers duplicates (retransmissions), reorderings
(multi-path, ARQ refills), and silence (dead radios).  ``SessionManager``
sits between them:

* per-(patient, modality) sequence tracking: the next expected ``seq``,
  a bounded reorder buffer holding early frames until the gap fills,
  duplicate drop, and gap/dup/reorder accounting into the engine's
  ``EnergyLedger`` transport column;
* session lifecycle: ``HELLO`` opens (or, after a disconnect, resumes —
  the sequence state survives the connection) and ``BYE`` closes cleanly,
  finalizing the patient's tracker through the engine;
* a **stall-timeout eviction policy**: a patient with no frame activity
  for ``stall_timeout_s`` is evicted — its complete pending windows are
  flushed through the pipeline, its tracker finalized
  (``StreamEngine.evict_patient``), its staged window slices freed, and the
  eviction counted in the ledger.  Frames arriving after eviction are
  dropped and counted, never replayed into a dead stream.

The clock is injectable so eviction is testable without real waiting.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.stream.engine import StreamEngine

from .protocol import (ACK, BYE, EVICTED, HELLO, Frame, ProtocolError,
                       ack as ack_frame, encode_frame,
                       evicted as evicted_frame)


@dataclasses.dataclass
class ModalityState:
    """Sequencing state for one (patient, modality) stream."""

    next_seq: int = 0
    # seq → (payload, hold stamp); the stamp (tracer clock, 0.0 when
    # tracing is off) times the reorder-held span at release
    held: Dict[int, Tuple[np.ndarray, float]] = dataclasses.field(
        default_factory=dict)
    in_gap: bool = False           # a hole is currently open
    last_seen: float = 0.0         # last DATA arrival for THIS modality
    stalled: bool = False          # currently past its modality timeout
    acked_seq: int = -1            # frontier last sent in an ACK (-1 forces
                                   # a resume ACK after the next HELLO)


@dataclasses.dataclass
class PatientSession:
    patient: str
    task: str
    last_seen: float
    modalities: Dict[str, ModalityState] = dataclasses.field(
        default_factory=dict)
    connects: int = 0
    done: bool = False             # closed cleanly by BYE
    evicted: bool = False          # closed by the stall reaper
    ack_hello: bool = False        # a HELLO awaits its barrier ACK

    @property
    def closed(self) -> bool:
        return self.done or self.evicted

    def held_frames(self) -> int:
        return sum(len(m.held) for m in self.modalities.values())


class SessionManager:
    """Order-restoring, exactly-once frame sink for many patient sessions.

    ``on_frame`` accepts frames in any arrival order the transport produces
    and feeds the engine a per-(patient, modality) in-order, duplicate-free
    chunk stream.  ``reap`` applies the stall-timeout eviction policy.
    """

    def __init__(self, engine: StreamEngine, stall_timeout_s: float = 30.0,
                 reorder_cap: int = 256,
                 clock: Callable[[], float] = time.monotonic,
                 modality_timeouts: Optional[Dict[str, float]] = None):
        """``modality_timeouts`` maps a modality name to its own stall
        threshold (seconds); modalities not named fall back to
        ``stall_timeout_s``.  A stalled modality is *noted* (counted in the
        ledger's ``modality_stalls`` column, flagged until it recovers) but
        never evicts the patient while other modalities keep the session
        alive — an IMU dropout must not kill a live ECG stream."""
        self.engine = engine
        self.stall_timeout_s = float(stall_timeout_s)
        self.reorder_cap = int(reorder_cap)
        self.clock = clock
        self.modality_timeouts = dict(modality_timeouts or {})
        self.sessions: Dict[str, PatientSession] = {}
        # patient → callable(bytes): where to write server-originated
        # frames (the EVICTED notice); transports register the live
        # connection's writer, in-process callers have none
        self._senders: Dict[str, Callable[[bytes], None]] = {}
        self._evicted_c = engine.metrics.counter(
            "ingest_evicted_notices_total",
            "EVICTED close notices, by reason and delivery")
        self._acked_c = engine.metrics.counter(
            "acked_frames_total",
            "frames covered by cumulative ACKs sent to clients, by patient")

    # -- server→client notices ------------------------------------------------
    def register_sender(self, patient: str,
                        send: Callable[[bytes], None]) -> None:
        """Register where ``patient``'s server-originated frames go (the
        latest connection carrying the patient wins — exactly the resume
        semantics of the session itself)."""
        self._senders[patient] = send

    def _notify_evicted(self, s: PatientSession, reason: str) -> None:
        """Best-effort EVICTED frame to the patient's live connection; the
        notice (and whether it could be delivered) is always counted."""
        send = self._senders.get(s.patient)
        delivered = False
        if send is not None:
            try:
                send(encode_frame(evicted_frame(s.patient, s.task, reason)))
                delivered = True
            except Exception:
                pass    # client already gone: the count still records it
        self._evicted_c.inc(reason=reason,
                            delivered="true" if delivered else "false")

    def flush_acks(self) -> int:
        """Send a cumulative ACK for every (patient, modality) stream whose
        scored frontier advanced since the last flush, plus — after a HELLO
        — one resume ACK per known modality followed by the barrier ACK
        (``modality == ""``), so a reconnecting client learns exactly where
        to rewind its replay buffer (a fresh session gets only the barrier:
        replay everything).  Credit is what's left of the stream's reorder
        budget.  Best-effort like the EVICTED notice; the transport calls
        this after each processed chunk.  Returns frames written.
        """
        sent = 0
        for s in self.sessions.values():
            dirty = [(mod, m) for mod, m in s.modalities.items()
                     if m.next_seq > m.acked_seq]
            if not dirty and not s.ack_hello:
                continue
            send = self._senders.get(s.patient)
            if send is None:
                continue     # no live connection: resend after the next
                             # HELLO (which resets acked_seq)
            for mod, m in dirty:
                credit = max(self.reorder_cap - len(m.held), 1)
                try:
                    send(encode_frame(ack_frame(
                        s.patient, s.task, mod, m.next_seq, credit)))
                except Exception:
                    break    # client gone mid-flush: a reconnect re-acks
                self._acked_c.inc(m.next_seq - max(m.acked_seq, 0),
                                  patient=s.patient)
                m.acked_seq = m.next_seq
                sent += 1
            if s.ack_hello:
                s.ack_hello = False
                try:
                    send(encode_frame(ack_frame(
                        s.patient, s.task, "", 0, self.reorder_cap)))
                    sent += 1
                except Exception:
                    pass
        return sent

    # -- lifecycle ------------------------------------------------------------
    def _session(self, frame: Frame, now: float) -> PatientSession:
        s = self.sessions.get(frame.patient)
        if s is None:
            s = self.sessions[frame.patient] = PatientSession(
                frame.patient, frame.task, last_seen=now)
        elif s.task != frame.task:
            raise ProtocolError(
                f"patient {frame.patient!r} re-announced with task "
                f"{frame.task!r}, session holds {s.task!r}")
        return s

    def on_frame(self, frame: Frame, now: Optional[float] = None) -> None:
        """Process one decoded frame (HELLO / DATA / BYE)."""
        if frame.ftype in (EVICTED, ACK):
            raise ProtocolError(
                f"frame type {frame.ftype} is server-originated; client "
                f"for {frame.patient!r} must not send it")
        now = self.clock() if now is None else now
        s = self._session(frame, now)
        led = self.engine.ledger
        if s.evicted:
            # the stream is dead: its tracker is finalized and its staged
            # state freed — late frames are counted, never replayed
            led.record_transport(frame.patient, late_frames=1)
            return
        s.last_seen = now
        if frame.ftype == HELLO:
            s.connects += 1
            # arm the resume-ACK set: every known frontier is re-announced
            # on the next flush, then the barrier tells the client the set
            # is complete (a fresh session announces only the barrier)
            s.ack_hello = True
            for m in s.modalities.values():
                m.acked_seq = -1
            led.record_transport(frame.patient, connects=1)
            return
        if frame.ftype == BYE:
            if not s.done:
                s.done = True
                # frames still held for a gap that never filled are lost
                # data — count them; a clean close must not hide the hole
                abandoned = s.held_frames()
                for m in s.modalities.values():
                    m.held.clear()
                # the hardened close: dispatch the stream's remaining
                # windows, THEN finalize the tracker, then free the
                # dispatcher so a churning fleet stays flat — and never
                # raise (a wedged done-but-unreleased session would leak
                # and inflate the backpressure signal forever)
                stats = self.engine.evict_patient(s.patient, s.task)
                deltas = {"abandoned_frames": abandoned,
                          "windows_dropped": stats["windows_dropped"]}
                deltas = {k: v for k, v in deltas.items() if v}
                if deltas:
                    led.record_transport(s.patient, **deltas)
                self._notify_evicted(s, "bye")
            return
        if s.done:
            raise ProtocolError(
                f"DATA for {frame.patient!r} after BYE")
        self._on_data(s, frame, now)

    # -- sequencing -----------------------------------------------------------
    def _on_data(self, s: PatientSession, frame: Frame, now: float) -> None:
        led = self.engine.ledger
        led.record_transport(s.patient, frames=1, bytes=frame.nbytes())
        m = s.modalities.setdefault(frame.modality,
                                    ModalityState(last_seen=now))
        m.last_seen = now
        m.stalled = False          # any arrival ends the stall; a later
                                   # dropout counts as a fresh stall event
        tr = self.engine.tracer
        seq = frame.seq
        if seq < m.next_seq or seq in m.held:
            led.record_transport(s.patient, dup_frames=1)
            return
        if seq > m.next_seq:
            if not m.in_gap:
                m.in_gap = True
                led.record_transport(s.patient, gap_events=1)
            if len(m.held) >= self.reorder_cap:
                raise ProtocolError(
                    f"reorder buffer for ({s.patient!r}, "
                    f"{frame.modality!r}) exceeded {self.reorder_cap} "
                    f"frames waiting for seq {m.next_seq}")
            m.held[seq] = (frame.payload,
                           tr.now() if tr is not None else 0.0)
            led.record_transport(s.patient, reordered_frames=1)
            return
        # in-order: deliver, then flush any now-contiguous held frames
        self.engine.ingest(s.patient, s.task, frame.modality, frame.payload)
        if tr is not None:
            tr.instant("session", "deliver", track=s.patient,
                       args={"modality": frame.modality, "seq": seq})
        m.next_seq += 1
        while m.next_seq in m.held:
            payload, t_held = m.held.pop(m.next_seq)
            self.engine.ingest(s.patient, s.task, frame.modality, payload)
            if tr is not None and t_held:
                tr.complete("reorder", "held", t_held, tr.now(),
                            track=s.patient,
                            args={"modality": frame.modality,
                                  "seq": m.next_seq})
            m.next_seq += 1
        if m.in_gap and not m.held:
            m.in_gap = False

    # -- stall eviction -------------------------------------------------------
    def reap(self, now: Optional[float] = None) -> List[str]:
        """Evict every session stalled past ``stall_timeout_s``.

        Eviction flushes the patient's complete pending windows through the
        pipeline (so the delivered prefix is fully scored), finalizes the
        tracker, frees the dispatcher's staged slices and rings, and counts
        the event in the ledger's transport column.  Returns the evicted
        patient ids.
        """
        now = self.clock() if now is None else now
        evicted: List[str] = []
        for s in self.sessions.values():
            if s.closed:
                continue
            # per-modality stall detection first: a dropped-out modality on
            # an otherwise-live session is counted and flagged, not evicted
            for mod, m in s.modalities.items():
                timeout = self.modality_timeouts.get(mod,
                                                     self.stall_timeout_s)
                if not m.stalled and now - m.last_seen >= timeout:
                    m.stalled = True
                    self.engine.ledger.record_transport(
                        s.patient, modality_stalls=1)
            if now - s.last_seen < self.stall_timeout_s:
                continue
            s.evicted = True
            stats = self.engine.evict_patient(s.patient, s.task)
            self.engine.ledger.record_transport(
                s.patient, evictions=1,
                windows_flushed=stats["windows_flushed"],
                windows_dropped=stats["windows_dropped"],
                staged_freed=stats["staged_slices"],
                abandoned_frames=s.held_frames())
            # drop the reorder buffers with the rest of the staged state
            for m in s.modalities.values():
                m.held.clear()
            self._notify_evicted(s, "stall")
            evicted.append(s.patient)
        return evicted

    # -- introspection --------------------------------------------------------
    def backlog(self) -> int:
        """Frames held for reordering plus engine windows awaiting dispatch
        (total retained-state view, for telemetry)."""
        held = sum(s.held_frames() for s in self.sessions.values())
        return held + self.engine.pending_windows()

    def dispatch_backlog(self) -> int:
        """Windows awaiting dispatch ONLY — the backpressure signal.  Held
        reorder frames are excluded on purpose: they drain when the missing
        sequence number arrives on the very connections backpressure would
        suspend, so counting them could deadlock the whole fleet (they are
        independently bounded by ``reorder_cap`` per modality)."""
        return self.engine.pending_windows()

    def open_sessions(self) -> List[Tuple[str, str]]:
        return [(s.patient, s.task) for s in self.sessions.values()
                if not s.closed]

    def all_closed(self) -> bool:
        return bool(self.sessions) and all(
            s.closed for s in self.sessions.values())
