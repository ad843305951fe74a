"""Collectors bridging the existing ledgers into a ``MetricsRegistry``.

The ledgers (``EnergyLedger``, ``TokenLedger``) stay the single source of
truth for energy/throughput accounting; the bridges registered here run
at *collect time* (scrape/snapshot) and copy the ledger summaries into
gauges verbatim. Scraped values therefore reconcile exactly — same
floats, no second accounting path that could drift.

Engines bind themselves at construction; the closures read the ledger
attribute each collect, so ``engine.reset()`` (which replaces the
ledger) needs no re-binding.  They hold the engine through a weak
reference: the engine owns the registry, so a strong one would be a
cycle, and an engine dropped by its caller (a serve engine holds its
quantized weights on the card) would stay alive until the next garbage
collection.  A collector whose engine is gone does nothing.
"""
from __future__ import annotations

import weakref
from typing import Any

__all__ = ["bind_stream_engine", "bind_serving_engine"]

# EnergyLedger.summary() row keys → gauge names (prefix "stream_")
_STREAM_ROW_KEYS = (
    "windows",
    "batches",
    "padded_windows",
    "windows_per_s",
    "nj_per_window",
    "total_nj",
    "escalated_windows",
    "escalation_nj",
)

# TokenLedger.summary() row keys → gauge names (prefix "serve_")
_SERVE_ROW_KEYS = (
    "requests",
    "prefill_tokens",
    "decode_tokens",
    "decode_steps",
    "padded_rows",
    "us_per_token",
    "prefill_us_per_token",
    "nj_per_token",
    "total_nj",
    "kv_read_bytes",
)


def bind_stream_engine(registry: Any, engine: Any) -> None:
    """Mirror ``engine.ledger`` (energy + transport) into gauges.

    Labels: energy rows carry ``group`` (the ``"task/fmt"`` summary key,
    incl. the ``"fleet"`` rollup row); transport counters carry
    ``patient`` (incl. ``"fleet"``).
    """
    if not getattr(registry, "enabled", False):
        return
    gauges = {k: registry.gauge(f"stream_{k}", f"EnergyLedger.summary()[group][{k!r}]")
              for k in _STREAM_ROW_KEYS}
    transport = registry.gauge(
        "ingest_transport", "EnergyLedger.transport_summary() counters")
    esc = registry.gauge(
        "stream_escalation_extra_nj",
        "per-patient escalation attribution (EnergyLedger.escalation_summary)")
    esc_w = registry.gauge(
        "stream_escalation_windows",
        "per-patient escalated window count")
    ref = weakref.ref(engine)

    def collect() -> None:
        engine = ref()
        if engine is None:
            return
        ledger = engine.ledger
        for group, row in ledger.summary().items():
            for k in _STREAM_ROW_KEYS:
                gauges[k].set(row[k], group=group)
        for patient, counters in ledger.transport_summary().items():
            for field, value in counters.items():
                transport.set(value, patient=patient, counter=field)
        for patient, d in ledger.escalation_summary().items():
            esc.set(d["extra_nj"], patient=patient)
            esc_w.set(d["windows"], patient=patient)

    registry.register_collector(collect)


def bind_serving_engine(registry: Any, engine: Any) -> None:
    """Mirror the serving ``TokenLedger`` into per-lane gauges."""
    if not getattr(registry, "enabled", False):
        return
    gauges = {k: registry.gauge(f"serve_{k}", f"TokenLedger.summary()[lane][{k!r}]")
              for k in _SERVE_ROW_KEYS}
    ref = weakref.ref(engine)

    def collect() -> None:
        engine = ref()
        if engine is None:
            return
        for lane, row in engine.ledger.summary().items():
            for k in _SERVE_ROW_KEYS:
                gauges[k].set(row[k], lane=lane)

    registry.register_collector(collect)
