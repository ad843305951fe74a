"""Persistent result spill: the supervisor queue's overflow goes to disk.

The supervisor's bounded result queue used to drop its oldest entry on
overflow — honest, counted, but *lost*.  ``ResultSpill`` turns that drop
into an append-only on-disk segment file so a stalled consumer (or a
restart) costs retention, not data:

* **Format** — the ingest wire codec, reused verbatim: each spilled
  ``WindowResult`` is a group of CRC-framed DATA frames.  A *meta* frame
  (modality ``"m:<fmt>"``, seq = the window index) carries
  ``[t0_s, ready_wall, done_wall, n_outputs]`` as float64; one *output*
  frame per entry of ``WindowResult.outputs`` (modality
  ``"o:<key>:<dtype>:<shape-csv>"``) carries the values as float64 —
  exact for float32/float64 outputs and for integer outputs below 2⁵³,
  cast back to the recorded dtype/shape on recovery.  CRC framing means
  a crash mid-append tears only the *last* record: ``recover`` returns
  every intact record before the tear and drops an incomplete tail group.

* **Bounded** — ``budget_bytes`` caps the file; ``append`` refuses (and
  returns ``False``, falling back to the counted drop) once a record
  would exceed the budget, so a wedged consumer cannot fill the disk.

* **Recovery** — ``ResultSpill.recover(path)`` replays a previous
  incarnation's segment into ``WindowResult``s;
  ``Supervisor.recover_spill()`` re-admits them to the queue on restart.
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np

from repro_torch.stream.engine import WindowResult

from .protocol import FrameDecoder, data as data_frame, encode_frame


def _meta_modality(fmt: str) -> str:
    return f"m:{fmt}"


def _output_modality(key: str, arr: np.ndarray) -> str:
    shape = ",".join(str(d) for d in arr.shape)
    return f"o:{key}:{arr.dtype.str}:{shape}"


def _encode_result(r: WindowResult) -> bytes:
    """One spilled result = meta frame + one frame per output, all DATA
    frames through the ordinary wire codec (CRC framing for free)."""
    meta = np.asarray([[r.t0_s, r.ready_wall, r.done_wall,
                        float(len(r.outputs))]], dtype=np.float64)
    parts = [encode_frame(data_frame(
        r.patient, r.task, _meta_modality(r.fmt), r.widx, meta))]
    for key in sorted(r.outputs):
        arr = np.asarray(r.outputs[key])
        flat = np.atleast_2d(arr.astype(np.float64).reshape(1, -1)
                             if arr.size else
                             np.zeros((1, 0), dtype=np.float64))
        parts.append(encode_frame(data_frame(
            r.patient, r.task, _output_modality(key, arr), r.widx, flat)))
    return b"".join(parts)


class ResultSpill:
    def __init__(self, path: str, budget_bytes: int = 256 << 20):
        self.path = str(path)
        self.budget_bytes = int(budget_bytes)
        self.bytes_written = 0
        self.spilled = 0                 # results accepted to disk
        self.rejected = 0                # results refused (budget)
        self.spilled_by_patient: Dict[str, int] = {}
        self._fh = None

    # -- write side -----------------------------------------------------------
    def append(self, r: WindowResult) -> bool:
        """Spill one result; ``False`` (caller falls back to the counted
        drop) when the record would break the disk budget."""
        record = _encode_result(r)
        if self.bytes_written + len(record) > self.budget_bytes:
            self.rejected += 1
            return False
        if self._fh is None:
            d = os.path.dirname(self.path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(self.path, "ab")
        self._fh.write(record)
        self._fh.flush()
        self.bytes_written += len(record)
        self.spilled += 1
        self.spilled_by_patient[r.patient] = (
            self.spilled_by_patient.get(r.patient, 0) + 1)
        return True

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self) -> "ResultSpill":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- read side ------------------------------------------------------------
    @classmethod
    def recover(cls, path: str) -> List[WindowResult]:
        """Replay a segment file into results, in spill order.  A torn
        tail (crash mid-append) loses only the final, incomplete record;
        everything CRC-intact before it survives."""
        if not os.path.exists(path):
            return []
        dec = FrameDecoder()
        out: List[WindowResult] = []
        current: Optional[WindowResult] = None
        want = 0
        with open(path, "rb") as fh:
            while True:
                chunk = fh.read(1 << 20)
                if not chunk:
                    break
                try:
                    frames = dec.feed(chunk)
                except Exception:
                    break        # poisoned past the tear: keep the prefix
                for f in frames:
                    if f.modality.startswith("m:"):
                        if current is not None and len(current.outputs) == want:
                            out.append(current)
                        meta = np.asarray(f.payload).ravel()
                        want = int(meta[3])
                        current = WindowResult(
                            patient=f.patient, task=f.task, widx=f.seq,
                            fmt=f.modality[2:], t0_s=float(meta[0]),
                            outputs={}, ready_wall=float(meta[1]),
                            done_wall=float(meta[2]))
                    elif f.modality.startswith("o:") and current is not None:
                        _, key, dtype, shape = f.modality.split(":", 3)
                        dims = tuple(int(d) for d in shape.split(",")
                                     if d != "")
                        vals = np.asarray(f.payload).ravel()
                        current.outputs[key] = (
                            vals.astype(np.dtype(dtype)).reshape(dims))
        if current is not None and len(current.outputs) == want:
            out.append(current)      # the file ended on a complete record
        return out

    def counters(self) -> Dict[str, object]:
        return {"spilled": self.spilled,
                "spill_rejected": self.rejected,
                "spill_bytes": self.bytes_written,
                "spilled_by_patient": dict(sorted(
                    self.spilled_by_patient.items()))}
