"""Replaying ingest client: the at-least-once half of exactly-once delivery.

``ReplayingClient`` is the fault-tolerant counterpart of a raw socket
writer.  It owns the connection lifecycle for one patient stream:

* **Replay buffer** — every DATA frame is retained (encoded bytes, keyed
  by (modality, seq)) until the server's cumulative ACK covers it *and*
  the buffer exceeds ``replay_budget_bytes``.  Unacked frames are never
  dropped; acked frames are kept as long as the budget allows, because a
  worker that crashes before draining loses everything it scored — the
  respawned worker announces a zero frontier and the client re-delivers
  the whole stream from this buffer.

* **Reconnect-resume** — on any connection loss (peer death, injected
  partition, planned segment cut) the client reconnects through
  ``lookup`` (re-consulted every attempt, so a failover that *moves* the
  patient to a different port is followed automatically) with bounded
  exponential backoff, re-HELLOs (carrying the ``auth_token`` when a
  shared secret is set), waits for the server's resume-frontier set +
  barrier ACK, and replays every retained frame at or past the frontier.
  The session layer's sequence tracking dedupes the overlap: delivery is
  at-least-once on the wire, exactly-once into the engine.

* **Credit pacing** — with ``flow_control`` on, a DATA frame whose seq
  would exceed the server's advertised credit window past the frontier
  waits for ACK progress (bounded by ``ack_timeout_s``, so a server with
  ACKs disabled degrades to pacing-free sends rather than deadlock).

* **Chaos hooks** — ``partition()`` hard-aborts the transport (the next
  send reconnects and replays); ``corrupt_next`` flips one bit in the
  next frame's *transmitted* copy (the retained copy stays clean), so
  the server's CRC check drops the connection and the replay path is
  exercised end to end.

The client transmits frames in exactly the order its caller hands them —
injected duplicates and reorderings reach the server intact (they model
the radio link; this client models the gateway) — only the *replay* path
re-sends in sequence order.
"""
from __future__ import annotations

import asyncio
import dataclasses
from typing import Callable, Dict, Optional, Tuple

from .protocol import (ACK, BYE, DATA, EVICTED, Frame, FrameDecoder,
                       auth_token, encode_frame, hello)

# where the patient's ingest endpoint currently lives; None = not (yet)
# published — the client backs off and asks again
Lookup = Callable[[], Optional[Tuple[str, int]]]


@dataclasses.dataclass
class ClientStats:
    """One client's delivery/recovery counters (merged fleet-wide by the
    simulator's runs into the ledger's ``replayed_frames`` transport
    column)."""

    connects: int = 0             # connections opened (first + re-)
    reconnects: int = 0           # connections beyond the first
    acks: int = 0                 # ACK frames received
    replayed_frames: int = 0      # retained frames re-sent after reconnect
    trimmed_frames: int = 0       # acked frames dropped to honor the budget
    partitions: int = 0           # injected partitions (chaos hook)
    corrupted_frames: int = 0     # injected corruptions (chaos hook)
    credit_waits: int = 0         # sends that waited on the credit window

    def as_dict(self) -> Dict[str, int]:
        return dataclasses.asdict(self)


class ReplayingClient:
    def __init__(self, patient: str, task: str, lookup: Lookup, *,
                 flow_control: bool = True,
                 auth_secret: Optional[str] = None,
                 replay_budget_bytes: int = 64 << 20,
                 connect_attempts: int = 80, backoff_s: float = 0.02,
                 max_backoff_s: float = 1.0, ack_timeout_s: float = 2.0):
        """``lookup`` returns the patient's current ``(host, port)`` or
        ``None`` while unpublished (mid-failover); it is re-consulted on
        every connect attempt.  ``flow_control=False`` sends without
        credit pacing or barrier waits — pair it with a server started
        ``ack=False`` for the ACK-less wire behaviour (the overhead A/B's
        baseline arm); the reader still drains anything the server sends.
        """
        self.patient = patient
        self.task = task
        self.lookup = lookup
        self.flow_control = bool(flow_control)
        self.auth_secret = auth_secret
        self.replay_budget_bytes = int(replay_budget_bytes)
        self.connect_attempts = int(connect_attempts)
        self.backoff_s = float(backoff_s)
        self.max_backoff_s = float(max_backoff_s)
        self.ack_timeout_s = float(ack_timeout_s)
        self.stats = ClientStats()
        self.corrupt_next = False      # chaos hook: corrupt the next send
        self.evicted: Optional[str] = None   # server close notice reason
        # replay buffer: modality → {seq: encoded frame bytes}
        self._retained: Dict[str, Dict[int, bytes]] = {}
        self._retained_bytes = 0
        self._bye: Optional[bytes] = None    # retained for replay_all
        # server state learned from ACKs (cleared on every reconnect: a
        # fresh worker's zero frontier must not be masked by stale state)
        self._frontier: Dict[str, int] = {}
        self._credit: Dict[str, int] = {}
        self._barrier = asyncio.Event()      # resume-frontier set complete
        self._progress = asyncio.Event()     # pulses on ACK/disconnect
        self._conn_lock = asyncio.Lock()
        self._writer: Optional[asyncio.StreamWriter] = None
        self._reader_task: Optional[asyncio.Task] = None

    # -- connection lifecycle -------------------------------------------------
    @property
    def connected(self) -> bool:
        return self._writer is not None and not self._writer.is_closing()

    async def _ensure_connected(self) -> asyncio.StreamWriter:
        async with self._conn_lock:
            if self.connected:
                return self._writer
            for attempt in range(self.connect_attempts):
                await self._teardown()
                # lookup is re-consulted every attempt: a failover that
                # moves the patient to a new port is followed; a raise
                # from lookup aborts immediately (worker declared failed)
                target = self.lookup()
                if target is not None:
                    try:
                        await self._open(*target)
                        return self._writer
                    except OSError:
                        pass     # died during connect/handshake/replay
                await asyncio.sleep(min(
                    self.backoff_s * (2 ** min(attempt, 8)),
                    self.max_backoff_s))
            await self._teardown()
            raise ConnectionError(
                f"{self.patient}: ingest endpoint unreachable after "
                f"{self.connect_attempts} attempts")

    async def _open(self, host: str, port: int) -> None:
        """One connect + handshake + replay attempt (caller retries)."""
        reader, writer = await asyncio.open_connection(host, port)
        self._writer = writer
        if self.stats.connects:
            self.stats.reconnects += 1
        self.stats.connects += 1
        self._frontier.clear()
        self._credit.clear()
        self._barrier.clear()
        self._reader_task = asyncio.ensure_future(self._read_loop(reader))
        auth = (auth_token(self.auth_secret, self.patient, self.task)
                if self.auth_secret is not None else None)
        writer.write(encode_frame(hello(self.patient, self.task, auth)))
        await writer.drain()
        if self.flow_control:
            # the resume-frontier set is complete at the barrier; a
            # server with ACKs off never sends one — degrade to a full
            # replay after the timeout instead of deadlocking
            try:
                await asyncio.wait_for(self._barrier.wait(),
                                       self.ack_timeout_s)
            except asyncio.TimeoutError:
                pass
        await self._replay(writer, count=self.stats.connects > 1)

    async def _teardown(self) -> None:
        if self._reader_task is not None:
            self._reader_task.cancel()
            try:
                await self._reader_task
            except (asyncio.CancelledError, Exception):
                pass
            self._reader_task = None
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass
            self._writer = None

    async def _read_loop(self, reader: asyncio.StreamReader) -> None:
        """Drain server→client frames: ACKs advance the frontier/credit
        and trim the buffer; EVICTED records the close reason.  EOF (or a
        reset) just ends the loop — the send path reconnects lazily."""
        dec = FrameDecoder()
        try:
            while True:
                chunk = await reader.read(1 << 16)
                if not chunk:
                    break
                progressed = False
                for f in dec.feed(chunk):
                    if f.ftype == ACK:
                        self.stats.acks += 1
                        if f.modality == "":
                            self._barrier.set()
                        else:
                            self._frontier[f.modality] = max(
                                self._frontier.get(f.modality, 0), f.seq)
                            self._credit[f.modality] = max(f.credit, 1)
                            self._trim()
                        progressed = True
                    elif f.ftype == EVICTED:
                        self.evicted = f.modality   # reason rides modality
                        progressed = True
                if progressed:
                    self._pulse()   # wake credit waiters
        except (ConnectionError, OSError, asyncio.CancelledError):
            pass
        except Exception:
            pass    # a garbled downstream frame must not kill the client
        finally:
            self._pulse()

    def _pulse(self) -> None:
        """Wake credit waiters (ack progress, disconnect, eviction)."""
        self._progress.set()
        self._progress = asyncio.Event()

    # -- replay buffer --------------------------------------------------------
    def _retain(self, frame: Frame, data: bytes) -> None:
        mods = self._retained.setdefault(frame.modality, {})
        if frame.seq not in mods:       # an injected dup is already held
            mods[frame.seq] = data
            self._retained_bytes += len(data)

    def _trim(self) -> None:
        """Drop *acked* frames, oldest first, until the buffer fits the
        budget.  Unacked frames are never dropped — they are the only
        copy; the budget bounds how much *failover* history survives."""
        if self._retained_bytes <= self.replay_budget_bytes:
            return
        for mod, mods in self._retained.items():
            frontier = self._frontier.get(mod, 0)
            for seq in sorted(mods):
                if seq >= frontier:
                    break
                if self._retained_bytes <= self.replay_budget_bytes:
                    return
                self._retained_bytes -= len(mods.pop(seq))
                self.stats.trimmed_frames += 1

    async def _replay(self, writer: asyncio.StreamWriter,
                      count: bool) -> None:
        """Re-send every retained frame at or past the server's announced
        frontier, in sequence order per modality.  On the first connect
        the buffer is empty; after a failover to a fresh worker the
        frontier set is empty and the whole stream replays."""
        n = 0
        for mod in sorted(self._retained):
            frontier = self._frontier.get(mod, 0)
            for seq in sorted(self._retained[mod]):
                if seq < frontier:
                    continue
                writer.write(self._retained[mod][seq])
                n += 1
                if n % 64 == 0:
                    await writer.drain()
        if n:
            await writer.drain()
        if count:
            self.stats.replayed_frames += n

    # -- sending --------------------------------------------------------------
    async def _await_credit(self, modality: str, seq: int) -> None:
        loop = asyncio.get_event_loop()
        deadline = loop.time() + self.ack_timeout_s
        waited = False
        while (self.connected and self.evicted is None
               and seq - self._frontier.get(modality, 0)
               >= self._credit.get(modality, 1 << 30)):
            remaining = deadline - loop.time()
            if remaining <= 0:
                break       # liveness over pacing: never deadlock a send
            waited = True
            try:
                await asyncio.wait_for(
                    asyncio.shield(self._progress.wait()), remaining)
            except asyncio.TimeoutError:
                break
        if waited:
            self.stats.credit_waits += 1

    async def send(self, frame: Frame) -> None:
        """Deliver one frame at-least-once.  DATA is retained for replay
        before the first transmission attempt, so a connection that dies
        mid-write loses nothing; HELLO frames are ignored (the client
        owns the handshake); BYE is retained so ``replay_all`` can close
        the stream again after a failover."""
        if frame.ftype == DATA:
            data = encode_frame(frame)
            self._retain(frame, data)
            if self.evicted == "stall":
                return      # session reaped server-side: nothing to feed
            wire = data
            if self.corrupt_next:
                self.corrupt_next = False
                self.stats.corrupted_frames += 1
                wire = bytearray(data)
                wire[len(wire) // 2] ^= 0x01    # CRC will catch it
                wire = bytes(wire)
            for attempt in range(3):
                writer = await self._ensure_connected()
                if attempt > 0:
                    return   # the reconnect's replay re-sent the retained
                             # (clean) copy of this frame already
                if self.flow_control:
                    await self._await_credit(frame.modality, frame.seq)
                try:
                    writer.write(wire)
                    await writer.drain()
                    return
                except (ConnectionError, OSError):
                    continue
        elif frame.ftype == BYE:
            self._bye = encode_frame(frame)
            await self._send_bye_retry()

    async def _send_bye_retry(self) -> None:
        if self._bye is None:
            return
        for _ in range(3):
            try:
                writer = await self._ensure_connected()
                writer.write(self._bye)
                await writer.drain()
                return
            except (ConnectionError, OSError):
                continue     # the session reaper closes it if we give up

    # -- chaos hooks ----------------------------------------------------------
    def partition(self) -> None:
        """Hard network partition: abort the transport mid-stream (no FIN,
        no flush).  The next send reconnects and replays."""
        self.stats.partitions += 1
        if self._writer is not None:
            transport = self._writer.transport
            if transport is not None:
                transport.abort()

    # -- shutdown / failover re-delivery --------------------------------------
    async def disconnect(self) -> None:
        """Graceful connection close (planned segment cut or end of
        stream): flush, half-close with FIN, and wait for the server to
        finish reading and close its side — so nothing in flight can be
        destroyed by a reset, and every pending ACK is drained."""
        async with self._conn_lock:
            if self._writer is not None:
                try:
                    await self._writer.drain()
                    if self._writer.can_write_eof():
                        self._writer.write_eof()
                except (ConnectionError, OSError):
                    pass
                if self._reader_task is not None:
                    try:
                        await asyncio.wait_for(
                            asyncio.shield(self._reader_task), 5.0)
                    except (asyncio.TimeoutError, Exception):
                        pass
            await self._teardown()

    async def close(self) -> None:
        await self.disconnect()

    async def replay_all(self) -> None:
        """Failover re-delivery for an already-finished stream: reconnect
        (HELLO → resume → replay from the announced frontier — zero on a
        fresh worker, so the whole stream goes out again), re-send the
        retained BYE so the session closes cleanly, then disconnect."""
        await self._ensure_connected()
        await self._send_bye_retry()
        await self.disconnect()
