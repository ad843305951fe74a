"""Per-patient ingest: ring buffers and the window dispatcher.

A wearable stream is a set of *modalities* sampled at different rates (cough:
2-mic audio @ 16 kHz + 9-axis IMU @ 100 Hz; ECG: one lead @ 250 Hz).  Chunks
arrive in order within one (patient, modality) stream but raggedly interleaved
across patients — the radio-packet model.  The dispatcher aligns modalities on
the wall-clock window grid and emits window ``k`` exactly once, when every
modality has full coverage of [k·hop_s, k·hop_s + window_s).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class ModalitySpec:
    name: str
    channels: int
    rate: float  # Hz


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """Fixed-size window grid over a multi-rate stream.

    Window ``k`` covers time [k·hop_s, k·hop_s + window_s); per modality that
    is samples [round(k·hop_s·rate), round(k·hop_s·rate)) + window samples.
    """

    task: str
    modalities: Tuple[ModalitySpec, ...]
    window_s: float
    hop_s: float

    def window_samples(self, m: ModalitySpec) -> int:
        return int(round(m.rate * self.window_s))

    def hop_samples(self, m: ModalitySpec) -> int:
        return int(round(m.rate * self.hop_s))

    def window_start(self, m: ModalitySpec, widx: int) -> int:
        return int(round(widx * self.hop_s * m.rate))


class RingBuffer:
    """Fixed-capacity ring over the last (time) axis with ABSOLUTE indexing:
    ``head`` counts every sample ever pushed, so window extraction addresses
    the stream, not the buffer.  Samples older than ``head - capacity`` are
    gone; reading them raises (the dispatcher never does — it pops eagerly)."""

    def __init__(self, channels: int, capacity: int, dtype=np.float64):
        self.capacity = int(capacity)
        self.data = np.zeros((channels, self.capacity), dtype)
        self.head = 0  # absolute count of samples pushed

    def push(self, chunk: np.ndarray) -> None:
        chunk = np.atleast_2d(chunk)
        if chunk.shape[0] != self.data.shape[0]:
            raise ValueError(
                f"chunk has {chunk.shape[0]} channels, ring expects "
                f"{self.data.shape[0]} — refusing to broadcast")
        k = chunk.shape[-1]
        if k > self.capacity:
            raise ValueError(
                f"chunk of {k} samples exceeds ring capacity {self.capacity}")
        pos = self.head % self.capacity
        first = min(k, self.capacity - pos)
        self.data[:, pos: pos + first] = chunk[:, :first]
        if k > first:
            self.data[:, : k - first] = chunk[:, first:]
        self.head += k

    def read(self, start: int, length: int) -> np.ndarray:
        """Copy ``length`` samples beginning at ABSOLUTE index ``start``."""
        if start < self.head - self.capacity:
            raise IndexError(
                f"samples at {start} already overwritten (head={self.head}, "
                f"capacity={self.capacity}) — dispatcher backlog too deep")
        if start + length > self.head:
            raise IndexError(f"samples [{start}, {start + length}) not yet "
                             f"ingested (head={self.head})")
        pos = start % self.capacity
        first = min(length, self.capacity - pos)
        out = np.empty((self.data.shape[0], length), self.data.dtype)
        out[:, :first] = self.data[:, pos: pos + first]
        if length > first:
            out[:, first:] = self.data[:, : length - first]
        return out


@dataclasses.dataclass
class Window:
    """One ready window: per-modality sample blocks plus provenance.

    ``ready_wall`` is the wall clock (``time.perf_counter``) at emission —
    the moment the last contributing chunk completed the window — so the
    supervisor can report end-to-end ready→result latency percentiles.
    """

    patient: str
    task: str
    widx: int
    t0_s: float
    arrays: Dict[str, np.ndarray]  # modality name → (channels, n) float
    ready_wall: float = 0.0


class WindowDispatcher:
    """One patient's stream → ordered, exactly-once window emission.

    Per-modality window slices are cut EAGERLY as soon as that modality
    covers them, so each ring only ever retains about one window + one hop of
    history — cross-modality arrival skew (audio packets trailing IMU packets
    by seconds) costs sliced-window staging memory, never ring overruns.  A
    window is emitted once every modality's slice for it exists; emission is
    strictly in ``widx`` order, each window exactly once.
    """

    def __init__(self, patient: str, spec: WindowSpec):
        self.patient = patient
        self.spec = spec
        self.next_widx = 0  # next window to EMIT — never skipped, never redone
        self.rings: Dict[str, RingBuffer] = {}
        self._next_cut: Dict[str, int] = {}   # next window to SLICE, per mod
        self._staged: Dict[int, Dict[str, np.ndarray]] = {}
        for m in spec.modalities:
            win = spec.window_samples(m)
            hop = spec.hop_samples(m)
            # capacity bound: after cutting, < win+hop uncut samples remain,
            # and push() feeds the ring in pieces ≤ capacity-(win+hop).
            self.rings[m.name] = RingBuffer(m.channels, 2 * win + hop)

    def _modality(self, name: str) -> ModalitySpec:
        for m in self.spec.modalities:
            if m.name == name:
                return m
        raise KeyError(f"unknown modality {name!r} for task {self.spec.task!r}")

    def push(self, modality: str, chunk: np.ndarray) -> List[Window]:
        """Ingest one in-order chunk; return every window that became ready.

        Arbitrarily long chunks are processed in ring-capacity-safe pieces.
        """
        m = self._modality(modality)
        ring = self.rings[modality]
        win = self.spec.window_samples(m)
        hop = self.spec.hop_samples(m)
        piece = max(ring.capacity - (win + hop), 1)
        chunk = np.atleast_2d(np.asarray(chunk))
        for pos in range(0, chunk.shape[-1], piece):
            ring.push(chunk[..., pos: pos + piece])
            self._cut(m)
        return self.pop_ready()

    def _cut(self, m: ModalitySpec) -> None:
        """Slice every window this modality now fully covers into staging."""
        ring = self.rings[m.name]
        win = self.spec.window_samples(m)
        w = self._next_cut.setdefault(m.name, 0)
        while self.spec.window_start(m, w) + win <= ring.head:
            sl = ring.read(self.spec.window_start(m, w), win)
            self._staged.setdefault(w, {})[m.name] = sl.astype(np.float32)
            w += 1
        self._next_cut[m.name] = w

    def ready_count(self) -> int:
        """How many windows from ``next_widx`` on have every modality staged."""
        n = 0
        need = len(self.spec.modalities)
        while len(self._staged.get(self.next_widx + n, ())) == need:
            n += 1
        return n

    def pop_ready(self, max_windows: Optional[int] = None) -> List[Window]:
        out: List[Window] = []
        n = self.ready_count()
        if max_windows is not None:
            n = min(n, max_windows)
        now = time.perf_counter()
        for _ in range(n):
            w = self.next_widx
            arrays = self._staged.pop(w)
            out.append(Window(self.patient, self.spec.task, w,
                              w * self.spec.hop_s, arrays, ready_wall=now))
            self.next_widx += 1
        return out

    def staged_cost(self) -> Tuple[int, int]:
        """(slice count, bytes) of partially staged windows — what a stall
        eviction frees.  Exactly-once emission is why these are retained:
        a window missing one modality can never be re-cut once its ring
        history is overwritten, so only eviction may discard them."""
        slices = sum(len(d) for d in self._staged.values())
        nbytes = sum(a.nbytes for d in self._staged.values()
                     for a in d.values())
        return slices, nbytes
