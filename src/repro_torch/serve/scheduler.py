"""Continuous-batching scheduler: pure bookkeeping, no device code (the
port's copy of ``repro.serve.scheduler``; the metrics binding waits for
the observability slice).

Requests queue up, get admitted into fixed slot tables (one table per
precision lane, ``ServePolicy.lane``), emit tokens until EOS or their
token budget, then free their slot for the next waiting request — the
slot is reused mid-flight while the other rows keep decoding.  Finished
requests land in a bounded drop-oldest completion queue (same
``bounded_admit`` overflow policy as the stream engine's backlog).

The engine owns the device side (caches, jitted prefill/decode); this
module decides WHO occupies WHICH row WHEN.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.stream.engine import bounded_admit

from .policy import AGGRESSIVE_SERVE, ServePolicy


@dataclasses.dataclass
class Request:
    """One generation request as the scheduler sees it."""

    rid: int
    prompt: np.ndarray                 # (P,) int32 token ids
    max_new_tokens: int
    temperature: float = 0.0
    eos_id: Optional[int] = None
    policy: ServePolicy = AGGRESSIVE_SERVE


@dataclasses.dataclass
class Completion:
    """One finished request."""

    rid: int
    tokens: np.ndarray                 # (T,) generated ids (EOS included)
    prompt_len: int
    finish_reason: str                 # "eos" | "length"
    lane: str


@dataclasses.dataclass
class Slot:
    """One occupied row of a lane's batch."""

    request: Request
    tokens: List[int] = dataclasses.field(default_factory=list)

    @property
    def done(self) -> Optional[str]:
        r = self.request
        if r.eos_id is not None and self.tokens and \
                self.tokens[-1] == r.eos_id:
            return "eos"
        if len(self.tokens) >= r.max_new_tokens:
            return "length"
        return None


class Scheduler:
    """Admission + slot lifecycle for a multi-lane continuous batch."""

    def __init__(self, batch_size: int, max_completions: Optional[int] = 256):
        self.batch_size = batch_size
        self.waiting: Deque[Request] = collections.deque()
        self.slots: Dict[str, List[Optional[Slot]]] = {}
        self.completions: Deque[Completion] = collections.deque()
        self.max_completions = max_completions
        self.dropped = 0
        self._warn_at = 1
        self._next_rid = 0

    # -- admission --------------------------------------------------------
    def submit(self, request: Request) -> int:
        """Queue a request; assigns the rid if the caller left it < 0."""
        if request.rid < 0:
            request = dataclasses.replace(request, rid=self._next_rid)
        self._next_rid = max(self._next_rid, request.rid + 1)
        self.waiting.append(request)
        return request.rid

    def _lane_slots(self, lane: str) -> List[Optional[Slot]]:
        return self.slots.setdefault(lane, [None] * self.batch_size)

    def take_admissions(self) -> List[Tuple[Request, int]]:
        """Admit waiting requests into free slots (FIFO), returning
        ``(request, slot_idx)`` pairs the engine must now prefill."""
        admitted: List[Tuple[Request, int]] = []
        deferred: List[Request] = []
        while self.waiting:
            req = self.waiting.popleft()
            table = self._lane_slots(req.policy.lane)
            try:
                idx = table.index(None)
            except ValueError:
                deferred.append(req)   # lane full; keep FIFO order
                continue
            table[idx] = Slot(req)
            admitted.append((req, idx))
        self.waiting.extendleft(reversed(deferred))
        return admitted

    # -- steady state -----------------------------------------------------
    def active_rows(self, lane: str) -> List[int]:
        return [i for i, s in enumerate(self.slots.get(lane, [])) if s]

    def active_lanes(self) -> List[str]:
        return [lane for lane in self.slots if self.active_rows(lane)]

    def on_token(self, lane: str, slot_idx: int, token: int) -> bool:
        """Record one emitted token; on EOS / budget, retire the slot into
        the completion queue and free it.  Returns True if retired."""
        slot = self.slots[lane][slot_idx]
        slot.tokens.append(int(token))
        reason = slot.done
        if reason is None:
            return False
        comp = Completion(rid=slot.request.rid,
                          tokens=np.asarray(slot.tokens, np.int32),
                          prompt_len=len(slot.request.prompt),
                          finish_reason=reason, lane=lane)
        self.dropped, self._warn_at = bounded_admit(
            self.completions, comp, self.max_completions, self.dropped,
            self._warn_at, "serve completions")
        self.slots[lane][slot_idx] = None
        return True

    def pop_completions(self) -> List[Completion]:
        out = list(self.completions)
        self.completions.clear()
        return out

    @property
    def idle(self) -> bool:
        return not self.waiting and not any(
            s for table in self.slots.values() for s in table)
