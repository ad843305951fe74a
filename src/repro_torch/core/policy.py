"""The part of ``repro.core.policy`` the stream router needs: the storage
policy of a routed format and the per-task streaming formats."""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class QuantPolicy:
    """Storage formats per tensor class. ``None`` → native (f32)."""

    weights: Optional[str] = None        # deployed parameters
    activations: Optional[str] = None    # in-flight window features


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
