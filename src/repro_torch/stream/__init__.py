"""Continuous multi-patient streaming runtime on the card: ring-buffered
ingest, exactly-once window emission, per-patient precision routing,
cross-patient batched dispatch and per-window energy accounting."""
from .accounting import (EnergyLedger, cough_window_op_counts,  # noqa: F401
                         energy_config_for_format, rpeak_window_op_counts,
                         window_energy_nj)
from .engine import StreamEngine, WindowResult, bucket_size  # noqa: F401
from .pipelines import (COUGH_SPEC, RPEAK_SPEC, Pipeline,  # noqa: F401
                        cough_pipeline, rpeak_pipeline)
from .router import EscalationPolicy, PrecisionRouter, Route  # noqa: F401
from .tracker import RPeakTracker, TrackerUpdate  # noqa: F401
