"""FleetSimulator: replay synthetic wearable fleets over the wire protocol.

Builds the same mixed fleet the streaming benchmark drives in-process —
half cough patients (2-mic audio + 9-axis IMU), half exercise-ECG, a
quarter of each arm pinned to a comparison format — but emits it as
protocol frames: per-(patient, modality) sequence numbers, HELLO on every
(re)connect, BYE on clean end of stream.  Three runners share one plan:

* ``run_inproc(engine)``   — the pre-transport reference: raw chunks
  straight into ``StreamEngine.ingest`` (what parity tests compare against);
* ``run_loopback(sessions)`` — frames through the byte codec
  (encode → ragged byte splits → decode) into the ``SessionManager``,
  deterministic and socket-free;
* ``run_tcp(host, port)``  — one asyncio client per patient against a live
  ``IngestServer``, with configurable real-time factor and jitter.

Transport faults are injected deterministically from the seed and preserve
the delivered sample set, modelling an ARQ link: ``dup_rate`` re-sends an
already-sent frame (dropped by the session layer), ``defer_rate`` holds a
frame back ``defer_depth`` sends (a drop + late retransmission: opens a gap,
lands in the reorder buffer), ``disconnect_every`` closes and re-opens the
connection mid-stream (mid-window: chunk boundaries don't align with the
window grid).  Patients named in ``stall_after`` send only that many DATA
frames and then go silent without BYE — the stall-eviction policy's prey.
"""
from __future__ import annotations

import asyncio
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.data.biosignals import (AUDIO_SR, ECG_FS, IMU_SR,
                                   cough_stream_signals, ecg_stream_signal,
                                   ragged_chunks)
from repro_torch.stream.engine import StreamEngine
from repro_torch.stream.pipelines import RPEAK_WINDOW_S

from .client import ClientStats, ReplayingClient
from .protocol import (DATA, HELLO, Frame, FrameDecoder, bye, data,
                       encode_frame, hello)
from .sessions import SessionManager

_MODALITY_RATES = {"audio": AUDIO_SR, "imu": IMU_SR, "ecg": ECG_FS}


@dataclasses.dataclass(frozen=True)
class ChaosPlan:
    """Deterministic fault schedule for one chaos run.

    ``kill_worker``/``kill_after_s`` name a worker-pool member to SIGKILL
    mid-stream (``ingest.workers``' pool); the
    connection-level faults are applied inside ``run_tcp`` through the
    ``ReplayingClient`` chaos hooks; ``stall_pump_s`` freezes the supervisor consumer (the
    result-queue overflow → spill path's prey)."""

    kill_worker: Optional[int] = None       # worker index to SIGKILL
    kill_after_s: float = 0.2               # serving time before the kill
    partition_patients: Tuple[str, ...] = ()  # hard-abort these patients'
    partition_after_frames: int = 4           # connections after N frames
    corrupt_patients: Tuple[str, ...] = ()    # flip one bit in these
    corrupt_at_frame: int = 3                 # patients' Nth DATA frame
    stall_pump_s: float = 0.0               # supervisor consumer stall


@dataclasses.dataclass
class PatientPlan:
    """One patient's full replay: signals, chunking, pin, fault schedule."""

    patient: str
    task: str
    fmt: Optional[str]                      # per-patient pin (None = table)
    signals: Dict[str, np.ndarray]          # modality → (channels, n)
    chunks: Dict[str, List[np.ndarray]]     # modality → in-order chunks
    stall_after: Optional[int] = None       # DATA frames before going silent

    def n_data_frames(self) -> int:
        return sum(len(c) for c in self.chunks.values())


class FleetSimulator:
    def __init__(self, n_patients: int = 64, windows: int = 2, seed: int = 0,
                 mixed: bool = True, n_cough: Optional[int] = None,
                 dup_rate: float = 0.0,
                 defer_rate: float = 0.0, defer_depth: int = 3,
                 disconnect_every: Optional[int] = None,
                 stall_after: Optional[Dict[str, int]] = None,
                 audio_chunk: Tuple[int, int] = (400, 9600),
                 imu_chunk: Tuple[int, int] = (4, 60),
                 ecg_chunk: Tuple[int, int] = (50, 1000)):
        """``n_cough`` defaults to half the fleet (the benchmark's split);
        pass 0 for an ECG-only fleet (no forest/FFT compile in tests)."""
        if n_patients < 1:
            raise ValueError("need ≥ 1 patient")
        self.n_patients = int(n_patients)
        self.windows = int(windows)
        self.seed = int(seed)
        self.dup_rate = float(dup_rate)
        self.defer_rate = float(defer_rate)
        self.defer_depth = int(defer_depth)
        self.disconnect_every = disconnect_every
        self.stall_after = dict(stall_after or {})
        self.pins: Dict[str, str] = {}
        self.truths: Dict[str, np.ndarray] = {}  # ecg patient → true R peaks
        self.plans: List[PatientPlan] = []
        rng = np.random.default_rng(self.seed)
        n_cough = self.n_patients // 2 if n_cough is None else int(n_cough)
        for p in range(self.n_patients):
            if p < n_cough:
                pid = f"cough-{p:03d}"
                a, i, _ = cough_stream_signals(self.windows, seed=p)
                signals = {"audio": a, "imu": i}
                chunks = {
                    "audio": list(ragged_chunks(a, rng, *audio_chunk)),
                    "imu": list(ragged_chunks(i, rng, *imu_chunk))}
                task, fmt = "cough", ("fp16" if mixed and p % 4 == 3
                                      else None)
            else:
                pid = f"ecg-{p - n_cough:03d}"
                s, r = ecg_stream_signal(self.windows * RPEAK_WINDOW_S,
                                         seed=1000 + p)
                self.truths[pid] = r
                signals = {"ecg": s[None, :]}
                chunks = {"ecg": list(ragged_chunks(s[None, :], rng,
                                                    *ecg_chunk))}
                task, fmt = "rpeak", ("posit8" if mixed and p % 4 == 3
                                      else None)
            if fmt is not None:
                self.pins[pid] = fmt
            self.plans.append(PatientPlan(pid, task, fmt, signals, chunks,
                                          self.stall_after.get(pid)))

    # -- frame generation -----------------------------------------------------
    def _data_frames(self, plan: PatientPlan) -> List[Frame]:
        """The patient's DATA frames in send order: modalities interleaved by
        stream progress (the lagging modality sends next), per-modality seq
        numbers — then truncated at the stall point if the patient stalls."""
        mods = sorted(plan.chunks)
        sent = {m: 0 for m in mods}
        total = {m: max(len(plan.chunks[m]), 1) for m in mods}
        seq = {m: 0 for m in mods}
        out: List[Frame] = []
        while any(sent[m] < len(plan.chunks[m]) for m in mods):
            m = min((m for m in mods if sent[m] < len(plan.chunks[m])),
                    key=lambda m: sent[m] / total[m])
            out.append(data(plan.patient, plan.task, m, seq[m],
                            plan.chunks[m][sent[m]]))
            seq[m] += 1
            sent[m] += 1
        if plan.stall_after is not None:
            out = out[: plan.stall_after]
        return out

    def _inject_faults(self, frames: List[Frame],
                       rng: np.random.Generator) -> List[Frame]:
        """Deterministic ARQ-style fault injection (see module docstring):
        the delivered (deduplicated, reordered-back) set is unchanged."""
        out: List[Frame] = []
        deferred: List[Tuple[int, Frame]] = []  # (release at len(out) ≥ k, f)
        for f in frames:
            if self.defer_rate and rng.uniform() < self.defer_rate:
                deferred.append((len(out) + self.defer_depth, f))
            else:
                out.append(f)
            if self.dup_rate and out and rng.uniform() < self.dup_rate:
                out.append(out[int(rng.integers(len(out)))])
            ready = [d for d in deferred if d[0] <= len(out)]
            for d in ready:
                deferred.remove(d)
                out.append(d[1])
        out.extend(f for _, f in deferred)
        return out

    def segments(self, plan: PatientPlan,
                 rng: np.random.Generator) -> List[List[Frame]]:
        """The patient's replay as connection segments: each begins with
        HELLO; the last ends with BYE unless the patient stalls.  More than
        one segment ⇔ mid-stream disconnect/reconnect."""
        frames = self._inject_faults(self._data_frames(plan), rng)
        cut = (self.disconnect_every
               if self.disconnect_every and self.disconnect_every > 0
               else len(frames) or 1)
        segs = [[hello(plan.patient, plan.task)] + frames[i: i + cut]
                for i in range(0, max(len(frames), 1), cut)]
        if plan.stall_after is None:
            segs[-1].append(bye(plan.patient, plan.task))
        return segs

    # -- runners --------------------------------------------------------------
    def run_inproc(self, engine: StreamEngine,
                   arrival_seed: int = 1) -> None:
        """The reference run: raw chunks straight into the engine in a
        ragged cross-patient round-robin (stall schedules ignored — this is
        the full-stream ground truth parity compares against)."""
        rng = np.random.default_rng(arrival_seed)
        self.pin_all(engine)
        queues = [(plan, m, list(plan.chunks[m]))
                  for plan in self.plans for m in sorted(plan.chunks)]
        live = [q for q in queues if q[2]]
        while live:
            k = int(rng.integers(len(live)))
            plan, mod, chunks = live[k]
            engine.ingest(plan.patient, plan.task, mod, chunks.pop(0))
            if not chunks:
                live.pop(k)
        engine.drain()
        engine.finalize_all()

    def run_loopback(self, sessions: SessionManager, arrival_seed: int = 1,
                     max_burst: int = 4) -> None:
        """Socketless transport: every frame through the byte codec, segments
        interleaved across patients in ragged bursts."""
        rng = np.random.default_rng(arrival_seed)
        self.pin_all(sessions.engine)
        streams = []
        for plan in self.plans:
            frames = [f for seg in self.segments(plan, rng) for f in seg]
            streams.append((FrameDecoder(), frames))
        live = [s for s in streams if s[1]]
        while live:
            k = int(rng.integers(len(live)))
            dec, frames = live[k]
            for _ in range(int(rng.integers(1, max_burst + 1))):
                if not frames:
                    break
                for f in dec.feed(encode_frame(frames.pop(0))):
                    sessions.on_frame(f)
            if not frames:
                live.pop(k)

    async def run_tcp(self, host: str, port: int, arrival_seed: int = 1,
                      realtime_factor: float = 0.0,
                      jitter_s: float = 0.0,
                      plans: Optional[Sequence[PatientPlan]] = None, *,
                      lookup=None, flow_control: bool = True,
                      auth_secret: Optional[str] = None,
                      chaos: Optional[ChaosPlan] = None,
                      stats_out: Optional[Dict[str, ClientStats]] = None,
                      ledger=None,
                      clients_out: Optional[Dict[str,
                                                 ReplayingClient]] = None,
                      ) -> None:
        """One ``ReplayingClient`` per patient against a live
        ``IngestServer``.

        ``realtime_factor`` r > 0 sleeps chunk_duration/r between frames
        (r=1 is wall-clock-faithful replay); 0 sends as fast as the socket
        allows.  ``jitter_s`` adds uniform random inter-frame delay.  A plan
        with several segments gracefully closes the connection between them
        — a mid-window disconnect — and reconnects for the next.  ``plans``
        restricts the drive to a subset of the fleet — how the multi-process
        worker pool points each patient at the worker that owns it.

        ``lookup`` (patient → ``(host, port)`` or ``None``) overrides the
        fixed endpoint — the worker pool passes its live failover map so a
        respawned worker's new port is found automatically.  ``chaos``
        applies the connection-level fault schedule (partitions and frame
        corruptions; worker kills live in ``ingest.workers``).
        ``stats_out``/``clients_out`` collect per-patient delivery stats
        and the live clients (the pool parks finished clients there for
        failover re-delivery); ``ledger`` records each client's
        ``replayed_frames`` into the transport column.
        """
        rng = np.random.default_rng(arrival_seed)
        plans = self.plans if plans is None else list(plans)
        chaos = chaos or ChaosPlan()

        async def one_patient(plan: PatientPlan, seed: int) -> None:
            prng = np.random.default_rng(seed)
            find = ((lambda: (host, port)) if lookup is None
                    else (lambda p=plan.patient: lookup(p)))
            cli = ReplayingClient(plan.patient, plan.task, find,
                                  flow_control=flow_control,
                                  auth_secret=auth_secret)
            if clients_out is not None:
                clients_out[plan.patient] = cli
            part_at = (chaos.partition_after_frames
                       if plan.patient in chaos.partition_patients else None)
            corrupt_at = (chaos.corrupt_at_frame
                          if plan.patient in chaos.corrupt_patients else None)
            n_data = 0
            try:
                # a permanently-failed worker aborts this patient's drive
                # (the lookup raises); contain it so the sibling patients'
                # coroutines finish and the stats still get recorded — the
                # pool surfaces the loss through ``failed_workers``
                for si, seg in enumerate(self.segments(plan, prng)):
                    if si:
                        await cli.disconnect()   # planned mid-stream cut
                    for f in seg:
                        if f.ftype == HELLO:
                            continue     # the client owns the handshake
                        if f.ftype == DATA:
                            n_data += 1
                            if corrupt_at is not None and n_data == corrupt_at:
                                cli.corrupt_next = True
                        await cli.send(f)
                        if part_at is not None and n_data == part_at:
                            part_at = None
                            cli.partition()
                        delay = 0.0
                        if realtime_factor > 0 and f.payload is not None:
                            delay += (f.payload.shape[-1]
                                      / _MODALITY_RATES[f.modality]
                                      / realtime_factor)
                        if jitter_s > 0:
                            delay += float(prng.uniform(0, jitter_s))
                        if delay:
                            await asyncio.sleep(delay)
            except ConnectionError:
                pass
            finally:
                await cli.close()
            if stats_out is not None:
                stats_out[plan.patient] = cli.stats
            if ledger is not None and cli.stats.replayed_frames:
                ledger.record_transport(
                    plan.patient,
                    replayed_frames=cli.stats.replayed_frames)

        await asyncio.gather(*(
            one_patient(plan, int(rng.integers(1 << 31)))
            for plan in plans))

    # -- conveniences ---------------------------------------------------------
    def pin_all(self, engine: StreamEngine) -> None:
        for pid, fmt in self.pins.items():
            engine.router.pin(pid, fmt)

    def expected_windows(self) -> int:
        """Full-stream window count (stall schedules not deducted)."""
        return self.n_patients * self.windows
