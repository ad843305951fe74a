"""Asynchronous multi-patient ingest: the transport layer in front of the
port's streaming runtime (the counterpart of ``repro.ingest``).

``repro_torch.stream`` assumes a polite caller — in-order chunks, one
process, a drained result list.  ``repro_torch.ingest`` is the layer that
faces an actual fleet: a framed, versioned wire protocol (``protocol``,
byte-for-byte the reference's), an asyncio TCP server with per-connection
backpressure (``server``), session management that restores exactly-once
in-order delivery from a faulty transport and evicts stalled patients on a
timeout (``sessions``), a bounded-queue result supervisor publishing
per-patient telemetry (``supervisor``) with an on-disk overflow spill
(``spill``), a replaying client (``client``), a fleet replay simulator for
soak runs and parity tests (``simulator``), and a multi-process worker
pool with crash failover (``workers``).  Every dispatch runs on the
engine's device — the card unless the engine was built with
``device="cpu"``.
"""
from .client import ClientStats, ReplayingClient
from .protocol import (ACK, BYE, DATA, EVICTED, HELLO, Frame, FrameDecoder,
                       ProtocolError, ack, auth_token, bye, check_auth,
                       data, decode_body, encode_frame, encode_stream,
                       evicted, hello, loopback)
from .server import IngestServer
from .sessions import ModalityState, PatientSession, SessionManager
from .simulator import ChaosPlan, FleetSimulator, PatientPlan
from .spill import ResultSpill
from .supervisor import Supervisor
from .workers import (WorkerConfig, aggregate_rollup, partition_plans,
                      run_worker_fleet)

__all__ = [
    "ACK", "BYE", "DATA", "EVICTED", "HELLO", "ChaosPlan", "ClientStats",
    "FleetSimulator", "Frame", "FrameDecoder", "IngestServer",
    "ModalityState", "PatientPlan", "PatientSession", "ProtocolError",
    "ReplayingClient", "ResultSpill", "SessionManager", "Supervisor",
    "WorkerConfig", "ack", "aggregate_rollup", "auth_token", "bye",
    "check_auth", "data", "decode_body", "encode_frame", "encode_stream",
    "evicted", "hello", "loopback", "partition_plans", "run_worker_fleet",
]
