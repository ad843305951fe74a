"""Framed wire protocol for wearable sensor transport.

One stream of length-prefixed binary frames per connection; every frame is
self-describing (patient, task, modality, sequence number ride in the
header), so the server needs no per-connection parser state and a client may
resume on a fresh connection mid-stream.  Layout, all fields big-endian:

    u32  body_len                 (length prefix, excludes itself)
    body:
      2s   magic  = b"PH"
      u8   version = 1
      u8   frame type (HELLO=1, DATA=2, BYE=3, EVICTED=4, ACK=5)
      str  patient                (u8 length + utf-8 bytes)
      str  task
      str  modality               ("" for BYE; an optional auth token for
                                   HELLO; the close REASON for EVICTED —
                                   "stall" or "bye"; the acked modality for
                                   ACK, "" for the post-HELLO barrier)
      u32  seq                    (per-(patient, modality) sample-frame
                                   counter; the cumulative scored frontier
                                   for ACK; 0 for HELLO/BYE/EVICTED)
      u8   channels
      u8   dtype code             (0 = float32, 1 = float64)
      u32  n_samples              (the CREDIT window for ACK frames —
                                   non-DATA frames carry no payload, so the
                                   slot is free and the layout unchanged)
      ...  payload                (channels × n_samples row-major samples)
      u32  crc32 of everything above in the body

``HELLO`` opens (or re-opens, after a disconnect) a patient session; ``BYE``
declares a clean end of stream, letting the server finalize the patient's
tracker immediately instead of waiting for the stall reaper.  ``DATA``
carries one in-order chunk of one modality.  Two frames flow
server→client: ``EVICTED``, an explicit close notice carrying the reason
("stall" or "bye") in the modality field, so a client that was silently
reaped learns it must re-HELLO rather than keep streaming into a dead
session; and ``ACK``, the flow-control frame — ``seq`` is the cumulative
frontier (every frame below it has been delivered IN ORDER to the scoring
engine) for one (patient, modality) stream and the n_samples slot carries
the credit window (how many frames past the frontier the server will
buffer).  After each HELLO the server replies with one ACK per known
modality (the resume frontiers) followed by a barrier ACK with
``modality == ""`` — a fresh session sends only the barrier, telling the
client to replay from zero.  Clients keep a replay buffer of unacked
frames and resend them on reconnect; the session layer's sequence
tracking dedupes the overlap, so delivery is at-least-once on the wire
and exactly-once into the engine.

``HELLO`` optionally carries a shared-secret auth token in its (otherwise
empty) modality field — ``auth_token()`` computes the HMAC-SHA256 digest a
server started with ``auth_secret`` requires.  The decoder is incremental —
feed it arbitrary byte splits (the TCP reader does) and it yields every
complete frame — and validates magic, version, CRC, and a frame-size bound
before any payload is materialized.

The *loopback codec* (`encode_stream` + `FrameDecoder`) runs the identical
byte path without sockets: deterministic, event-loop-free, and what the
fast-lane transport tests and ``FleetSimulator.run_loopback`` use.
"""
from __future__ import annotations

import dataclasses
import hashlib
import hmac as _hmac
import struct
import zlib
from typing import Iterable, Iterator, List, Optional

import numpy as np

MAGIC = b"PH"
VERSION = 1

HELLO = 1
DATA = 2
BYE = 3
EVICTED = 4     # server → client: session closed (stall eviction or BYE
                # acknowledgment); the reason string rides the modality field
ACK = 5         # server → client: cumulative scored frontier + credit
                # window for one (patient, modality) stream
_TYPES = (HELLO, DATA, BYE, EVICTED, ACK)

# corrupt length prefixes must not allocate gigabytes: one frame is bounded
# by a few seconds of the densest modality (16 kHz × 2ch float64 ≈ 256 KiB/s)
MAX_FRAME_BYTES = 1 << 24

_DTYPES = {0: np.dtype(">f4"), 1: np.dtype(">f8")}
_DTYPE_CODES = {np.dtype(np.float32): 0, np.dtype(np.float64): 1}


class ProtocolError(ValueError):
    """Malformed frame: bad magic/version/type, CRC mismatch, oversize."""


@dataclasses.dataclass(frozen=True)
class Frame:
    """One decoded wire frame (see module docstring for the layout)."""

    ftype: int
    patient: str
    task: str
    modality: str = ""
    seq: int = 0
    payload: Optional[np.ndarray] = None  # (channels, n_samples) float
    credit: int = 0                       # ACK only: frames past the
                                          # frontier the server will buffer

    def nbytes(self) -> int:
        return self.payload.nbytes if self.payload is not None else 0


def hello(patient: str, task: str, auth: Optional[str] = None) -> Frame:
    """``auth`` (an ``auth_token`` digest) rides the otherwise-empty
    modality field — zero wire-format change for unauthenticated fleets."""
    return Frame(HELLO, patient, task, auth or "")


def bye(patient: str, task: str) -> Frame:
    return Frame(BYE, patient, task)


def evicted(patient: str, task: str, reason: str) -> Frame:
    """Server-originated close notice (the only downstream frame): tells
    the client WHY its session ended — ``"stall"`` (reaper timeout) or
    ``"bye"`` (clean-close acknowledgment)."""
    return Frame(EVICTED, patient, task, reason)


def ack(patient: str, task: str, modality: str, seq: int,
        credit: int = 0) -> Frame:
    """Server-originated cumulative ACK: every frame of ``modality`` with a
    sequence number below ``seq`` has been delivered in order to the
    engine; the client may trim them from its replay buffer and keep at
    most ``credit`` frames in flight past the frontier.  ``modality == ""``
    is the post-HELLO barrier (resume-frontier set complete)."""
    return Frame(ACK, patient, task, modality, seq, credit=int(credit))


def auth_token(secret: str, patient: str, task: str) -> str:
    """The HELLO auth digest for one (patient, task) stream under a shared
    secret: HMAC-SHA256 hex, bound to the stream identity so a captured
    token cannot open a different patient's session."""
    return _hmac.new(secret.encode("utf-8"),
                     f"{patient}|{task}".encode("utf-8"),
                     hashlib.sha256).hexdigest()


def check_auth(secret: str, frame: Frame) -> bool:
    """Constant-time verification of a HELLO frame's auth token."""
    want = auth_token(secret, frame.patient, frame.task)
    return _hmac.compare_digest(frame.modality, want)


def data(patient: str, task: str, modality: str, seq: int,
         samples: np.ndarray) -> Frame:
    return Frame(DATA, patient, task, modality, seq,
                 np.atleast_2d(np.asarray(samples)))


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    if len(b) > 255:
        raise ProtocolError(f"string field too long ({len(b)} bytes)")
    return struct.pack(">B", len(b)) + b


def encode_frame(frame: Frame) -> bytes:
    """Serialize one frame, length prefix included."""
    if frame.ftype not in _TYPES:
        raise ProtocolError(f"unknown frame type {frame.ftype}")
    if frame.ftype == DATA:
        payload = np.atleast_2d(np.asarray(frame.payload))
        code = _DTYPE_CODES.get(payload.dtype)
        if code is None:
            payload = payload.astype(np.float64)
            code = 1
        channels, n = payload.shape
        raw = payload.astype(_DTYPES[code].newbyteorder(">")).tobytes()
    else:
        # non-DATA frames have no payload; ACK reuses the free n_samples
        # slot for its credit window
        n = frame.credit if frame.ftype == ACK else 0
        code, channels, raw = 0, 0, b""
    body = b"".join([
        MAGIC, struct.pack(">BB", VERSION, frame.ftype),
        _pack_str(frame.patient), _pack_str(frame.task),
        _pack_str(frame.modality),
        struct.pack(">IBBI", frame.seq, channels, code, n),
        raw,
    ])
    body += struct.pack(">I", zlib.crc32(body) & 0xFFFFFFFF)
    if len(body) > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame of {len(body)} bytes exceeds "
                            f"MAX_FRAME_BYTES={MAX_FRAME_BYTES}")
    return struct.pack(">I", len(body)) + body


def encode_stream(frames: Iterable[Frame]) -> bytes:
    """The loopback codec's send half: frames → one contiguous byte stream."""
    return b"".join(encode_frame(f) for f in frames)


def _unpack_str(body: bytes, pos: int) -> tuple:
    k = body[pos]
    pos += 1
    return body[pos: pos + k].decode("utf-8"), pos + k


def decode_body(body: bytes) -> Frame:
    """Decode one frame body (length prefix already stripped)."""
    if len(body) < 4 + 2 + 2:
        raise ProtocolError(f"truncated frame body ({len(body)} bytes)")
    crc_got = struct.unpack(">I", body[-4:])[0]
    crc_want = zlib.crc32(body[:-4]) & 0xFFFFFFFF
    if crc_got != crc_want:
        raise ProtocolError(
            f"CRC mismatch (got {crc_got:#010x}, want {crc_want:#010x})")
    if body[:2] != MAGIC:
        raise ProtocolError(f"bad magic {body[:2]!r}")
    version, ftype = body[2], body[3]
    if version != VERSION:
        raise ProtocolError(f"unsupported protocol version {version}")
    if ftype not in _TYPES:
        raise ProtocolError(f"unknown frame type {ftype}")
    try:
        pos = 4
        patient, pos = _unpack_str(body, pos)
        task, pos = _unpack_str(body, pos)
        modality, pos = _unpack_str(body, pos)
        seq, channels, code, n = struct.unpack(">IBBI", body[pos: pos + 10])
        pos += 10
    except (IndexError, UnicodeDecodeError, struct.error) as e:
        # CRC-valid but lying length bytes (a buggy encoder, not line
        # noise) must still surface as a protocol error, not IndexError
        raise ProtocolError(f"malformed frame body: {e}") from None
    payload = None
    if ftype == DATA:
        dt = _DTYPES.get(code)
        if dt is None:
            raise ProtocolError(f"unknown dtype code {code}")
        want = channels * n * dt.itemsize
        raw = body[pos: pos + want]
        if len(raw) != want or pos + want != len(body) - 4:
            raise ProtocolError(
                f"payload size mismatch ({len(body) - 4 - pos} bytes for "
                f"{channels}×{n} {dt.name})")
        payload = np.frombuffer(raw, dt).reshape(channels, n)
        payload = payload.astype(dt.newbyteorder("="))
    credit = n if ftype == ACK else 0
    return Frame(ftype, patient, task, modality, seq, payload, credit)


class FrameDecoder:
    """Incremental frame parser: feed arbitrary byte splits, get frames.

    One instance per connection (or per loopback stream).  A malformed
    frame poisons the decoder, but frames decoded BEFORE the corruption
    point are still returned from that ``feed`` call — they arrived intact
    and must not become collateral of a later torn frame; the stashed
    ``ProtocolError`` raises on the NEXT call, and the transport layer then
    drops the connection.  Sequencing state lives in the
    ``SessionManager``, not here, so a reconnect recovers.
    """

    def __init__(self):
        self._buf = bytearray()
        self._err: Optional[ProtocolError] = None

    def feed(self, chunk: bytes) -> List[Frame]:
        if self._err is not None:
            raise self._err
        self._buf.extend(chunk)
        out: List[Frame] = []
        try:
            while len(self._buf) >= 4:
                body_len = struct.unpack(">I", bytes(self._buf[:4]))[0]
                if body_len > MAX_FRAME_BYTES:
                    raise ProtocolError(
                        f"frame length {body_len} exceeds "
                        f"MAX_FRAME_BYTES={MAX_FRAME_BYTES}")
                if len(self._buf) < 4 + body_len:
                    break
                body = bytes(self._buf[4: 4 + body_len])
                del self._buf[: 4 + body_len]
                out.append(decode_body(body))
        except ProtocolError as e:
            self._err = e   # deliver the intact prefix; poisoned hereafter
        return out

    @property
    def poisoned(self) -> bool:
        return self._err is not None

    @property
    def pending_bytes(self) -> int:
        return len(self._buf)


def loopback(frames: Iterable[Frame], chunk_bytes: int = 0,
             rng: Optional[np.random.Generator] = None) -> Iterator[Frame]:
    """Round-trip frames through the byte codec, optionally re-split into
    ``chunk_bytes``-sized (or rng-ragged) pieces — the socketless transport.
    """
    wire = encode_stream(frames)
    dec = FrameDecoder()
    if chunk_bytes <= 0 and rng is None:
        yield from dec.feed(wire)
        return
    if chunk_bytes <= 0:
        chunk_bytes = 4096  # rng-only mode: ragged splits up to this bound
    pos = 0
    while pos < len(wire):
        k = (int(rng.integers(1, chunk_bytes + 1)) if rng is not None
             else chunk_bytes)
        yield from dec.feed(wire[pos: pos + k])
        pos += k
