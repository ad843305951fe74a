"""Fault tolerance: the restart policy, the supervised-restart loop and the
step watchdog — the counterpart of ``repro.distributed.fault_tolerance``
for one device.

``RestartPolicy`` is the control logic both the ingest worker pool
(``repro_torch.ingest.workers``) and ``run_with_restarts`` use: bounded
restarts with exponential backoff.  ``StepWatchdog`` flags steps that
overrun a deadline, synchronising the card before it reads the clock when
the step's output lies there.

The reference's ``remesh`` and ``largest_valid_mesh`` rebuild a device mesh
after node loss; they wait for the distributed slice of the port
(ROADMAP.md, queue A item A4).  ``ElasticConfig`` is kept only as far as
``run_with_restarts`` reads it: its restart budget.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Tuple

import torch


@dataclasses.dataclass
class ElasticConfig:
    max_restarts: int = 20


def _on_card(out) -> bool:
    if isinstance(out, torch.Tensor):
        return out.is_cuda
    if isinstance(out, dict):
        return any(_on_card(v) for v in out.values())
    if isinstance(out, (list, tuple)):
        return any(_on_card(v) for v in out)
    return False


class StepWatchdog:
    """Deadline-based straggler mitigation: wraps the blocking step call;
    on deadline the caller skips the step (data is step-indexed, so skipping
    is deterministic and logged) or triggers a restart."""

    def __init__(self, deadline_s: float):
        self.deadline_s = deadline_s
        self.slow_steps: List[int] = []

    def run(self, step_idx: int, fn: Callable, *args):
        t0 = time.monotonic()
        out = fn(*args)
        if _on_card(out):   # the step's kernels may still be running
            torch.cuda.synchronize()
        dt = time.monotonic() - t0
        if dt > self.deadline_s:
            self.slow_steps.append(step_idx)
        return out, dt


@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    """Bounded-restart + exponential-backoff policy.

    Shared control logic: the supervisor loop (``run_with_restarts``) and
    the ingest worker pool (``repro_torch.ingest.workers``) both respawn a
    failed unit of work at most ``max_restarts`` times, sleeping
    ``delay(attempt)`` before attempt *n* (1-based) — ``backoff_s`` scaled
    by ``backoff_factor`` per prior failure, capped at ``max_backoff_s``.
    """

    max_restarts: int = 3
    backoff_s: float = 0.05
    backoff_factor: float = 2.0
    max_backoff_s: float = 2.0

    def delay(self, attempt: int) -> float:
        """Seconds to back off before restart ``attempt`` (1-based)."""
        return min(self.backoff_s
                   * self.backoff_factor ** max(attempt - 1, 0),
                   self.max_backoff_s)

    def allows(self, restarts_so_far: int) -> bool:
        return restarts_so_far < self.max_restarts


def run_with_restarts(train_once: Callable[[int], int],
                      cfg: ElasticConfig = ElasticConfig(),
                      policy: Optional[RestartPolicy] = None,
                      exceptions: Tuple = (RuntimeError, OSError),
                      sleep: Callable[[float], None] = time.sleep) -> int:
    """Supervisor loop: (re)start the work until it finishes.

    ``policy`` generalizes the restart budget/backoff (default:
    ``cfg.max_restarts`` attempts, flat 10 ms backoff); ``exceptions`` is
    the retryable set (anything else propagates immediately); ``sleep`` is
    injectable so backoff is testable without real waiting."""
    if policy is None:
        policy = RestartPolicy(max_restarts=cfg.max_restarts,
                               backoff_s=0.01, backoff_factor=1.0,
                               max_backoff_s=0.01)
    attempts = 0
    last_step = 0
    while True:
        try:
            return train_once(last_step)
        except exceptions:  # device loss / io failure / worker death
            if not policy.allows(attempts):
                raise RuntimeError(
                    f"exceeded {policy.max_restarts} restarts")
            attempts += 1
            sleep(policy.delay(attempts))
