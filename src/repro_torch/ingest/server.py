"""Asyncio TCP ingest server: many concurrent patient connections → one
``SessionManager``.

Each connection runs a reader coroutine: bytes → ``FrameDecoder`` →
``SessionManager.on_frame``.  Frames are self-describing, so a connection
carries any mix of patients/modalities and a patient may drop and resume on
a fresh connection (the session's sequencing state lives in the manager,
not the connection).  A malformed frame poisons only its own connection.

Backpressure is per-connection and explicit: after each socket read the
handler compares the manager's dispatch backlog (windows awaiting dispatch
— reorder-held frames are deliberately excluded: only these same readers
can fill their gaps, so counting them could stall the fleet against
itself) against ``high_watermark`` and suspends further reads, for at most
``max_suspend_s``, until it drains — TCP flow control then pushes back on
the client.  The engine's batch dispatch runs synchronously in the event
loop (windows are the unit of work; a dispatch is
microseconds-to-milliseconds), so "drains" means the supervisor/pump task
got a turn.

A periodic reaper task applies the ``SessionManager`` stall-timeout
eviction policy, so dead radios release their staged state without any
client cooperation.

The server is also where the telemetry plane attaches: ``scrape_port``
(``None`` = off, ``0`` = ephemeral) starts a localhost HTTP endpoint on
the same event loop serving ``/metrics`` (Prometheus text from the
engine's registry) and ``/telemetry`` (the supervisor's JSON view) —
see ``repro_torch.obs.scrape``.  Each connection registers itself as its
patients' downstream sender, so ``SessionManager`` can deliver EVICTED
close notices back to the client that streamed the session.
"""
from __future__ import annotations

import asyncio
from typing import Optional

from repro_torch.obs import ScrapeServer

from .protocol import HELLO, FrameDecoder, ProtocolError, check_auth
from .sessions import SessionManager


class IngestServer:
    def __init__(self, sessions: SessionManager, host: str = "127.0.0.1",
                 port: int = 0, high_watermark: int = 4096,
                 reap_interval_s: Optional[float] = None,
                 read_bytes: int = 1 << 16, max_suspend_s: float = 1.0,
                 supervisor=None, scrape_port: Optional[int] = None,
                 ack: bool = True, auth_secret: Optional[str] = None):
        """``port=0`` binds an ephemeral port (read it back from ``.port``
        after ``start``); ``reap_interval_s`` defaults to a quarter of the
        session manager's stall timeout.

        ``scrape_port`` enables the localhost telemetry endpoint (``0`` =
        ephemeral; read ``.scrape_port`` back after ``start``).
        ``supervisor`` (optional) provides the ``/telemetry`` JSON body;
        without one, ``/telemetry`` serves the ledger summaries directly.

        ``ack`` arms the server→client flow-control plane: after each
        processed chunk the session manager's cumulative ACKs (scored
        frontier + credit window per (patient, modality), resume set +
        barrier after every HELLO) are written back on the patient's live
        connection — what ``ReplayingClient`` uses to trim its replay
        buffer and rewind on reconnect.  Off = the ACK-less wire behaviour
        exactly (the ``--chaos-max`` overhead A/B's baseline arm).

        ``auth_secret`` requires every HELLO to carry the matching
        ``protocol.auth_token`` digest; connections failing verification
        (or sending for a patient they never authenticated) are dropped
        and counted in ``ingest_auth_failures_total``.
        """
        self.sessions = sessions
        self.host = host
        self.port = int(port)
        self.high_watermark = int(high_watermark)
        self.reap_interval_s = (
            float(reap_interval_s) if reap_interval_s is not None
            else sessions.stall_timeout_s / 4.0)
        self.read_bytes = int(read_bytes)
        self.max_suspend_s = float(max_suspend_s)
        self.connections_total = 0
        self.protocol_errors = 0
        self.session_errors = 0   # non-protocol failures (engine/session)
        self.auth_failures = 0
        self.ack = bool(ack)
        self.auth_secret = auth_secret
        self._auth_fail_c = sessions.engine.metrics.counter(
            "ingest_auth_failures_total",
            "connections rejected by HELLO auth verification")
        self.supervisor = supervisor
        self.scrape_port = scrape_port   # None = disabled
        self._scrape: Optional[ScrapeServer] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._reaper: Optional[asyncio.Task] = None

    def _telemetry_doc(self) -> dict:
        if self.supervisor is not None:
            doc = self.supervisor.telemetry()
        else:
            ledger = self.sessions.engine.ledger
            doc = {"groups": ledger.summary(),
                   "per_patient": ledger.transport_summary()}
        doc["server"] = {"connections_total": self.connections_total,
                         "protocol_errors": self.protocol_errors,
                         "session_errors": self.session_errors,
                         "auth_failures": self.auth_failures}
        return doc

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        if self.scrape_port is not None:
            metrics = getattr(self.supervisor, "metrics", None)
            if metrics is None:
                metrics = self.sessions.engine.metrics
            self._scrape = ScrapeServer(
                metrics, self._telemetry_doc, host="127.0.0.1",
                port=int(self.scrape_port))
            await self._scrape.start()
            self.scrape_port = self._scrape.port
        self._reaper = asyncio.ensure_future(self._reap_loop())

    async def stop(self) -> None:
        if self._reaper is not None:
            self._reaper.cancel()
            try:
                await self._reaper
            except asyncio.CancelledError:
                pass
            self._reaper = None
        if self._scrape is not None:
            await self._scrape.stop()
            self._scrape = None
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    async def __aenter__(self) -> "IngestServer":
        await self.start()
        return self

    async def __aexit__(self, *exc) -> None:
        await self.stop()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        self.connections_total += 1
        dec = FrameDecoder()
        registered = set()  # patients whose sender is this connection
        authed = set()      # patients this connection authenticated

        def send(data: bytes) -> None:
            if writer.is_closing():
                raise ConnectionError("connection closed")
            writer.write(data)

        def authorize(frame) -> bool:
            """Gate every frame when a shared secret is required: HELLO
            must verify, anything else must follow a verified HELLO for
            the same patient ON THIS connection."""
            if self.auth_secret is None:
                return True
            if frame.ftype == HELLO:
                if check_auth(self.auth_secret, frame):
                    authed.add(frame.patient)
                    return True
            elif frame.patient in authed:
                return True
            self.auth_failures += 1
            self._auth_fail_c.inc()
            return False

        try:
            while True:
                try:
                    chunk = await reader.read(self.read_bytes)
                except (ConnectionError, OSError):
                    # peer vanished (reset mid-read): same as EOF — the
                    # session state survives for the reconnect-resume
                    break
                if not chunk:
                    # EOF: the session stays open for a reconnect — but a
                    # stream that ended on a torn frame is still an error
                    if dec.poisoned:
                        self.protocol_errors += 1
                    break
                tr = self.sessions.engine.tracer
                t_dec = tr.now() if tr is not None else 0.0
                try:
                    frames = dec.feed(chunk)
                except ProtocolError:
                    self.protocol_errors += 1
                    break   # drop the connection; sessions survive
                if tr is not None and frames:
                    tr.complete("frame", "decode", t_dec, tr.now(),
                                track="ingest",
                                args={"frames": len(frames),
                                      "bytes": len(chunk)})
                rejected = False
                try:
                    for frame in frames:
                        if not authorize(frame):
                            rejected = True
                            break
                        if frame.patient not in registered:
                            registered.add(frame.patient)
                            self.sessions.register_sender(frame.patient,
                                                          send)
                        self.sessions.on_frame(frame)
                except ProtocolError:       # task change, reorder-cap, …
                    self.protocol_errors += 1
                    break
                except Exception:
                    # engine/session failure (unknown task, dispatch error
                    # surfacing through auto-pump): contain it to this
                    # connection instead of killing the reader task silently
                    self.session_errors += 1
                    break
                if rejected:
                    break   # unauthenticated connection: drop it
                if self.ack and frames:
                    # the flow-control plane: cumulative ACKs + credit for
                    # every frontier this chunk advanced, resume set +
                    # barrier for every HELLO it carried
                    self.sessions.flush_acks()
                waited = 0.0
                while (self.sessions.dispatch_backlog()
                       > self.high_watermark):
                    # suspend this reader until the dispatch backlog
                    # drains; TCP flow control propagates the stall to the
                    # client.  Bounded: a pathological backlog degrades to
                    # slower reads, never a permanent fleet-wide stall.
                    if waited >= self.max_suspend_s:
                        break
                    await asyncio.sleep(0.001)
                    waited += 0.001
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _reap_loop(self) -> None:
        loop = asyncio.get_event_loop()
        last = loop.time()
        while True:
            await asyncio.sleep(self.reap_interval_s)
            now = loop.time()
            overslept = now - last - self.reap_interval_s
            last = now
            if overslept > self.reap_interval_s:
                # the event loop was starved (a synchronous kernel build
                # inside a read handler can freeze it for seconds): live
                # clients' frames are sitting unread in socket buffers,
                # so their sessions LOOK stalled by exactly the freeze.
                # Defer eviction one cycle — the pending reads drain
                # during the next sleep — rather than evicting patients
                # for a stall the server itself caused.
                continue
            self.sessions.reap()
