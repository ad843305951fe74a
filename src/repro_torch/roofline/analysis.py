"""Roofline terms from a traced step — the counterpart of
``repro.roofline.analysis``.

The reference reads XLA's ``cost_analysis``/``memory_analysis`` of a
compiled cell and parses its HLO text for collectives.  The port has no
compiler to ask, so ``analyze_step`` runs the step itself — on ``meta``
for a plan (shapes only: nothing is allocated), or on the card — under
``FlopCounterMode`` and a byte-counting ``TorchDispatchMode``:

* **FLOPs** are ``FlopCounterMode``'s (matmuls, convolutions, attention).
  Those of an op whose operands are f32 are also counted apart
  (``flops_f32``): the card runs them outside the tensor cores, and
  ``roofline_terms`` charges them at the f32 peak.
* **bytes** are each dispatched op's input and output bytes.  A view or
  aliasing op (an output that shares an input's storage and writes
  nothing) counts 0; an in-place op counts its read and its write once;
  an op that only writes an argument (``copy_``, ``fill_``, ``out=``)
  counts no read of it.
* **Each kernel counts as one op** with its inputs and outputs, and the
  ops inside it are not counted.  For the duration of the trace every
  wrapper of ``kernels.counts.wrappers()`` (wherever a module of the port
  holds it) and every plain version in ``STREAM_PLAIN``/``SERVE_PLAIN``
  (at the sites ``PlainCalls`` patches) is replaced by a recorder: on a
  CUDA tensor it calls the real wrapper, elsewhere the plain version (on
  ``meta`` that gives the output shapes), with the inner ops uncounted;
  either way it records the one op.  A wrapper with no plain version of
  its own (``posit_kmeans_1d``: off the card its caller runs the per-op
  path instead) is recorded as itself.  B3 (``posit_matmul_round``) and B7
  (``posit_matmul``) add 2·M·N·K FLOPs and B6 (``posit_kv_attention``)
  4·rows·S·D, as PERF.md's bound column reckons them (B3's and B6's as
  f32 FLOPs, B7's on the bf16 tensor cores); the KV append
  counts its new rows read and their bits written, not the whole cache.
  Outside the trace the wrappers refuse a non-CUDA, non-CPU tensor as
  before.
* **Peak**: the bytes of the storages that the step creates and that are
  still alive, at their most (weak references to each storage; the
  arguments are counted apart).

**Device branches.** The card and ``meta`` count the same for the same
step, except where the port branches on the device:
``models/moe.py::_expert_matmul`` multiplies bf16 operands into f32 on
the card (``bmm(..., out_dtype=)``) where other devices upcast them
first, so a MoE layer's forward outside autograd counts the upcasts'
bytes on ``meta`` and not on the card, and its expert products' FLOPs
as f32 ones on ``meta`` and bf16 ones on the card.  No other branch
changes the ops.
"""
from __future__ import annotations

import importlib
import math
import sys
from typing import Dict, Iterable, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.core.quant import PositTensor
from repro_torch.distributed.rules import tree_leaves

from . import hw

# rough ring-style wire cost multipliers (bytes on the slowest link per
# device, relative to the op's result size): the reference's
_WIRE_WEIGHT = {
    "all-reduce": 2.0,         # reduce-scatter + all-gather
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def collective_bytes(records: Iterable[Tuple[str, Tuple[int, ...],
                                             torch.dtype]]
                     ) -> Dict[str, float]:
    """Per-op-kind wire bytes (per device) of ``(kind, result shape,
    dtype)`` records, weighted as the reference's HLO parser weighs them;
    ``"total"`` sums the kinds."""
    out: Dict[str, float] = {}
    for kind, shape, dtype in records:
        nbytes = math.prod(shape) * dtype.itemsize * _WIRE_WEIGHT[kind]
        out[kind] = out.get(kind, 0.0) + nbytes
    out["total"] = float(sum(v for k, v in out.items() if k != "total"))
    return out


def roofline_terms(flops: float, bytes_: float, coll: float,
                   flops_f32: float = 0.0) -> Dict[str, float]:
    """Seconds per term, per device, on the H100 SXM5's constants
    (``hw``): HBM bandwidth, one NDR link, and for the compute term the
    f32 peak for the ``flops_f32`` of ``flops`` whose operands are f32 and
    the bf16 dense peak for the rest (the reference's one peak is the
    case ``flops_f32`` = 0)."""
    t_c = (flops - flops_f32) / hw.PEAK_BF16_FLOPS \
        + flops_f32 / hw.PEAK_F32_FLOPS
    t_m = bytes_ / hw.HBM_BW
    t_x = coll / hw.IB_NDR_LINK_BW
    dom = max((t_c, "compute"), (t_m, "memory"), (t_x, "collective"))[1]
    return {
        "compute_s": t_c,
        "memory_s": t_m,
        "collective_s": t_x,
        "dominant": dom,
        "bound_s": max(t_c, t_m, t_x),
        # fraction of roofline: useful-compute time over the bounding term
        "roofline_fraction": (t_c / max(t_c, t_m, t_x))
        if max(t_c, t_m, t_x) else 0.0,
    }


# ---------------------------------------------------------------------------
# The trace
# ---------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(*xs):
    """The tensors of an op's arguments or results (tensors, and lists or
    tuples of them, one level deep, as aten's schemas have them)."""
    out = []
    for x in xs:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(_tensors(*x))
        elif isinstance(x, dict):
            out.extend(_tensors(*x.values()))
    return out


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


_writes: Dict[object, bool] = {}    # op → whether it writes an argument

# ops that write an argument without reading it
_WRITE_ONLY = {"copy_", "fill_", "zero_", "normal_", "uniform_",
               "random_", "bernoulli_", "exponential_"}


class _Stats:
    """What a trace counted."""

    def __init__(self, args):
        from torch.multiprocessing.reductions import StorageWeakRef
        self._ref = StorageWeakRef
        self.depth = 0              # > 0 inside a kernel's call
        self.bytes = 0
        self.kernel_flops = 0
        self.flops_f32 = 0          # of the FLOPs, on f32 operands
        self.kernel_ops: Dict[str, int] = {}
        self.ops = 0
        held = _tensors(*[(x.bits, x.scale) if isinstance(x, PositTensor)
                          else x for x in tree_leaves(args)])
        self.args = {_key(t) for t in held}
        self.arg_bytes = sum(_nbytes(t) for t in _unique(held))
        self.live: Dict[int, tuple] = {}
        self.live_bytes = 0
        self.peak = 0
        self._since_sweep = 0

    def _sweep(self):
        dead = [k for k, (ref, _) in self.live.items() if ref.expired()]
        for k in dead:
            self.live_bytes -= self.live.pop(k)[1]
        self._since_sweep = 0

    def created(self, outs):
        """Count the new storages among ``outs`` as live."""
        for t in outs:
            st = t.untyped_storage()
            k = st._cdata
            if k in self.args:
                continue
            old = self.live.get(k)
            if old is not None:
                if not old[0].expired():
                    continue
                self.live_bytes -= old[1]
            n = st.nbytes()
            self.live[k] = (self._ref(st), n)
            self.live_bytes += n
            self._since_sweep += 1
        if self.live_bytes > self.peak or self._since_sweep > 256:
            self._sweep()
        self.peak = max(self.peak, self.live_bytes)

    def op(self, func, args, kwargs, out):
        schema = func._schema
        outs = _tensors(out)
        ins = _tensors(args, {k: v for k, v in kwargs.items()
                              if k != "out"})
        in_keys = {_key(t) for t in ins}
        writes = _writes.get(func)
        if writes is None:
            writes = _writes[func] = any(
                a.alias_info is not None and a.alias_info.is_write
                for a in schema.arguments)
        if not writes and outs and all(_key(t) in in_keys for t in outs):
            return                   # a view: no bytes, no new storage
        name = func.overloadpacket.__name__
        if name in _WRITE_ONLY:
            written = {_key(t) for t in outs}
            ins = [t for t in ins if _key(t) not in written]
        self.ops += 1
        self.bytes += sum(_nbytes(t) for t in ins) + \
            sum(_nbytes(t) for t in outs)
        if not writes:
            self.created(outs)

    def kernel(self, name, args, kwargs, out):
        ins = _tensors(args, kwargs)
        outs = _tensors(out)
        self.ops += 1
        self.kernel_ops[name] = self.kernel_ops.get(name, 0) + 1
        if name == "posit_kv_append":
            k_new, v_new, k_bits, v_bits, length = args[:5]
            self.bytes += (_nbytes(k_new) + _nbytes(v_new) + _nbytes(length)
                           + 2 * k_new.numel() * k_bits.element_size())
        else:
            self.bytes += sum(_nbytes(t) for t in ins) + \
                sum(_nbytes(t) for t in outs)
        flops = _kernel_flops(name, args)
        self.kernel_flops += flops
        if name in _F32_KERNELS:
            self.flops_f32 += flops
        self.created(outs)


def _unique(ts):
    seen, out = set(), []
    for t in ts:
        k = (_key(t), t.storage_offset(), tuple(t.shape))
        if k not in seen:
            seen.add(k)
            out.append(t)
    return out


# the kernels whose FLOPs are f32 ones (B7 multiplies on the bf16 tensor
# cores), as PERF.md's bound column charges them
_F32_KERNELS = ("posit_matmul_round", "posit_kv_attention")


def _kernel_flops(name: str, args) -> int:
    if name in ("posit_matmul_round", "posit_matmul"):
        a, b = args[0], args[1]
        M, K = math.prod(a.shape[:-1]), a.shape[-1]
        return 2 * M * K * b.shape[-1]
    if name == "posit_kv_attention":
        q, k_bits = args[0], args[1]
        B, KV, G, D = q.shape
        return 4 * B * KV * G * k_bits.shape[1] * D
    return 0


class _Bytes(TorchDispatchMode):
    def __init__(self, stats: _Stats):
        super().__init__()
        self.stats = stats

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self.stats.depth:
            self.stats.op(func, args, kwargs, out)
        return out


class _Flops(FlopCounterMode):
    """``FlopCounterMode`` that skips the ops inside a kernel's call."""

    def __init__(self, stats: _Stats):
        super().__init__(display=False)
        self.stats = stats

    def _count_flops(self, func_packet, out, args, kwargs):
        if self.stats.depth:
            return out
        before = self.get_total_flops()
        out = super()._count_flops(func_packet, out, args, kwargs)
        first = next((t for t in _tensors(args) if t.is_floating_point()),
                     None)
        if first is not None and first.dtype in (torch.float32,
                                                 torch.float64):
            self.stats.flops_f32 += self.get_total_flops() - before
        return out


class _Recorder:
    """Stands in for a kernel's wrapper or a plain version while a trace
    runs (see the module docstring).  ``launches`` reads and writes the
    real wrapper's counter, so the wrapper's own count still lands."""

    def __init__(self, stats, name, real, plain):
        self._stats, self.__name__ = stats, name
        self._real, self._plain = real, plain

    @property
    def launches(self):
        return self._real.launches

    @launches.setter
    def launches(self, n):
        self._real.launches = n

    def __call__(self, *args, **kwargs):
        stats = self._stats
        card = any(t.is_cuda for t in _tensors(args, kwargs))
        fn = self._real if card else self._plain
        if stats.depth:              # inside another kernel: not counted
            return fn(*args, **kwargs)
        stats.depth += 1
        try:
            out = fn(*args, **kwargs)
        finally:
            stats.depth -= 1
        stats.kernel(self.__name__, args, kwargs, out)
        return out


def patch_everywhere(saved: list, real, stand_in) -> None:
    """Put ``stand_in`` wherever a module of the port holds ``real``,
    noting each (module, name, real) in ``saved`` for the restore."""
    for mod in list(sys.modules.values()):
        if not getattr(mod, "__name__", "").startswith("repro_torch"):
            continue
        for attr, val in list(vars(mod).items()):
            if val is real:
                saved.append((mod, attr, val))
                setattr(mod, attr, stand_in)


class KernelRecorders:
    """While entered, every kernel wrapper and plain-version site is a
    ``_Recorder`` feeding ``stats`` (by default a count nobody reads: a
    kernel then runs on ``meta`` too); restored on exit."""

    def __init__(self, stats: _Stats = None):
        self.stats = _Stats(()) if stats is None else stats
        self._saved = []

    def __enter__(self):
        from repro_torch.kernels.counts import (SERVE_PLAIN, STREAM_PLAIN,
                                                wrappers)
        for m, n in STREAM_PLAIN + SERVE_PLAIN:
            mod = importlib.import_module(m)
            real = getattr(mod, n)
            name = "posit_round" if n == "round_to_posit" else \
                n[:-len("_torch")]
            rec = _Recorder(self.stats, name, real, real)
            self._saved.append((mod, n, real))
            setattr(mod, n, rec)
        for w in wrappers():
            plain = getattr(sys.modules[w.__module__], w.__name__ + "_torch",
                            w)
            patch_everywhere(self._saved, w,
                             _Recorder(self.stats, w.__name__, w, plain))
        return self

    def __exit__(self, *exc):
        for mod, attr, val in reversed(self._saved):
            setattr(mod, attr, val)
        self._saved = []


def analyze_step(fn, *args, **kwargs) -> Dict[str, float]:
    """Per-device FLOPs, bytes and memory of one call ``fn(*args,
    **kwargs)`` on the device its arguments are on (``meta`` allocates
    nothing); the reference's ``analyze_compiled`` keys, with no
    collectives (the port plans those: ``launch.dryrun``), plus the FLOPs
    on f32 operands (``flops_f32``, for ``roofline_terms``), the kernels'
    recorded ops (``kernel_ops``) and the dispatched op count."""
    stats = _Stats((args, kwargs))
    flops = _Flops(stats)
    with KernelRecorders(stats), flops, _Bytes(stats):
        out = fn(*args, **kwargs)
        del out
    stats._sweep()
    return {
        "flops": float(flops.get_total_flops() + stats.kernel_flops),
        "flops_f32": float(stats.flops_f32),
        "bytes": float(stats.bytes),
        "coll_bytes": 0.0,
        "coll_breakdown": {},
        "peak_bytes_per_device": float(stats.arg_bytes + stats.peak),
        "arg_bytes_per_device": float(stats.arg_bytes),
        "temp_bytes_per_device": float(stats.peak),
        "kernel_ops": dict(stats.kernel_ops),
        "ops": stats.ops,
    }
