"""Fleet observability: trace spans, metrics registry, scrape plane.

See ``obs/trace.py`` for the span taxonomy, ``obs/metrics.py`` for the
registry semantics (raw-sample reservoirs, never averaged percentiles),
``obs/bridges.py`` for the exact-reconciliation ledger bridges, and
``obs/scrape.py`` for the localhost ``/metrics`` + ``/telemetry``
endpoint.
"""
from repro_torch.obs.bridges import bind_serving_engine, bind_stream_engine
from repro_torch.obs.metrics import (
    NULL_METRICS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    NullRegistry,
    merge_snapshots,
    parse_prometheus,
    percentiles,
    render_snapshot_prometheus,
)
from repro_torch.obs.scrape import ScrapeServer, http_get
from repro_torch.obs.trace import Tracer, validate_chrome_trace

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "NullRegistry",
    "NULL_METRICS",
    "merge_snapshots",
    "parse_prometheus",
    "percentiles",
    "render_snapshot_prometheus",
    "ScrapeServer",
    "http_get",
    "Tracer",
    "validate_chrome_trace",
    "bind_stream_engine",
    "bind_serving_engine",
]
