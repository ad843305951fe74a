"""Per-request precision policy for the serving engine (the port's copy
of ``repro.serve.policy``).

``ServePolicy`` maps the three serving tensor classes — weights, KV cache,
activations — to storage formats, per REQUEST: the scheduler groups
requests with the same policy into one "lane" (shared quantized weights,
shared compiled functions, one stacked KV cache), so a single engine can
serve posit8/posit10/posit16 KV traffic side by side and the ledger can
price each lane separately.  The analogue of ``stream.PrecisionRouter``,
but for tokens instead of biosignal windows.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core.formats import PositFormat, get_format
from repro_torch.core.policy import QuantPolicy


@dataclasses.dataclass(frozen=True)
class ServePolicy:
    """Storage format per serving tensor class; ``None`` → native bf16/f32.

    Hashable and frozen on purpose: the engine keys its lanes on it.
    """

    weights: Optional[str] = "posit16"
    kv: Optional[str] = "posit8"
    activations: Optional[str] = None

    def __post_init__(self):
        for field in ("weights", "kv", "activations"):
            name = getattr(self, field)
            if name is not None:
                fmt = get_format(name)  # raises on unknown names
                if not isinstance(fmt, PositFormat):
                    raise ValueError(
                        f"ServePolicy.{field}={name!r}: only posit storage "
                        "is wired into the bit-pattern path (IEEE formats "
                        "ride native dtypes — use None)")

    def quant_policy(self) -> QuantPolicy:
        """The model-layer policy this lane builds its DecoderLM with."""
        return QuantPolicy(weights=self.weights, kv_cache=self.kv,
                           activations=self.activations, scaled=False)

    @property
    def lane(self) -> str:
        """Stable lane label, also the ledger group key."""
        return (f"w={self.weights or 'bf16'}/kv={self.kv or 'bf16'}"
                f"/act={self.activations or '-'}")

    @property
    def kv_bits(self) -> int:
        """KV storage width on the wire (bf16 path → 16)."""
        return get_format(self.kv).n if self.kv else 16

    @classmethod
    def from_quant_policy(cls, qp: QuantPolicy) -> "ServePolicy":
        return cls(weights=qp.weights, kv=qp.kv_cache,
                   activations=qp.activations)


# The paper's deployment corner (posit16 storage everywhere) and the §IV-B
# aggressive corner (posit8 KV where fp8 fails).
PAPER_SERVE = ServePolicy(weights="posit16", kv="posit16")
AGGRESSIVE_SERVE = ServePolicy(weights="posit16", kv="posit8")
