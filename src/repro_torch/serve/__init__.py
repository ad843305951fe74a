"""Continuous-batching LM serving on posit KV caches (the port of
``repro.serve``)."""
from .accounting import TokenLedger  # noqa: F401
from .engine import ServeConfig, ServingEngine  # noqa: F401
from .policy import AGGRESSIVE_SERVE, PAPER_SERVE, ServePolicy  # noqa: F401
from .scheduler import Completion, Request, Scheduler  # noqa: F401
