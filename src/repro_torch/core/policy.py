"""QuantPolicy: which tensor class is stored in which arithmetic format —
the counterpart of ``repro.core.policy``, with the stream router's storage
policy and the per-task streaming formats."""
from __future__ import annotations

import dataclasses
from typing import Optional

from .formats import PositFormat, get_format


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Storage formats per tensor class. ``None`` → native (bf16/f32)."""

    weights: Optional[str] = None        # e.g. "posit16"
    kv_cache: Optional[str] = None       # e.g. "posit8"
    activations: Optional[str] = None    # fake-quant on block boundaries
    grad_allreduce: Optional[str] = None # cross-pod gradient compression
    scaled: bool = True                  # RMS-snap scaling (beyond-paper)

    def fmt(self, field: str) -> Optional[PositFormat]:
        name = getattr(self, field)
        if name is None:
            return None
        f = get_format(name)
        if not isinstance(f, PositFormat):
            raise ValueError(
                f"QuantPolicy.{field}={name!r}: only posit storage is wired "
                "into the integer-bit path (IEEE narrow formats flow through "
                "native dtypes instead)")
        return f

    @property
    def any_quantized(self) -> bool:
        return any(
            getattr(self, f) is not None
            for f in ("weights", "kv_cache", "activations", "grad_allreduce"))


def wearable_policy(fmt_name: Optional[str]) -> QuantPolicy:
    """Streaming-wearable storage policy for one arithmetic format: the
    deployed parameters (forest thresholds/leaves, filterbank tables) and
    the in-flight window features both live in the stream format; IEEE
    formats map to the unquantized policy."""
    if fmt_name is None or not fmt_name.startswith("posit"):
        return QuantPolicy()
    return QuantPolicy(weights=fmt_name, activations=fmt_name)


# Per-task streaming defaults from the paper's results: posit16 holds cough
# AUC at reference (§IV-A / Fig. 4); posit10 holds BayeSlope F1 ≈ 0.975 where
# fp16 has already dropped and fp8 fails (§IV-B / Fig. 5).
STREAM_TASK_FORMATS = {"cough": "posit16", "rpeak": "posit10"}

# Paper-faithful default: posit16 storage everywhere the paper stored data,
# f32 master/accumulators (the paper's FP32 reference remains the baseline).
PAPER_POLICY = QuantPolicy(weights="posit16", kv_cache="posit16")

# Beyond-paper aggressive policy justified by the paper's §IV-B finding that
# posit8 retains usable accuracy where fp8 fails.
AGGRESSIVE_POLICY = QuantPolicy(
    weights="posit16", kv_cache="posit8", grad_allreduce="posit16")

NO_QUANT = QuantPolicy()
