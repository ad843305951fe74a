"""Distributed runtime pieces of the port.  This slice has the fault
tolerance layer's restart policy, supervised-restart loop and step
watchdog; the sharding, collectives and re-meshing wait for ROADMAP.md's
queue A item A4."""
from .fault_tolerance import (ElasticConfig, RestartPolicy,  # noqa: F401
                              StepWatchdog, run_with_restarts)
