"""Fault tolerance and elasticity: the restart policy, the supervised
restart loop, the step watchdog and the elastic re-mesh — the counterpart
of ``repro.distributed.fault_tolerance``.

``RestartPolicy`` is the control logic both the ingest worker pool
(``repro_torch.ingest.workers``) and ``run_with_restarts`` use: bounded
restarts with exponential backoff.  ``StepWatchdog`` flags steps that
overrun a deadline, synchronising the card before it reads the clock when
the step's output lies there.  ``largest_valid_mesh`` and ``remesh``
rebuild a ``(data, model)`` mesh from the devices that survive a loss.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, Optional, Sequence, Tuple

import torch

from repro_torch.core.device import resolve_device

from .sharding import MeshInfo


@dataclasses.dataclass
class ElasticConfig:
    model_parallel: int = 16         # fixed TP degree (the model must fit)
    min_data_parallel: int = 1
    step_deadline_s: float = 600.0   # straggler: give up on the step
    max_restarts: int = 20


def largest_valid_mesh(n_devices: int, cfg: ElasticConfig
                       ) -> Tuple[int, int]:
    """(data, model) for the biggest usable mesh after losing devices.

    The TP degree is fixed (parameter shards must fit); the data axis
    shrinks to the largest multiple the surviving devices support.  The
    global batch stays fixed: per-device microbatching absorbs the
    difference."""
    tp = cfg.model_parallel
    dp = max(n_devices // tp, cfg.min_data_parallel)
    if n_devices < tp:
        raise RuntimeError(
            f"{n_devices} devices cannot hold a {tp}-way model-parallel "
            "shard set; restore on fewer model shards requires re-sharding "
            "the checkpoint (offline, through checkpoint.CheckpointManager)")
    return dp, tp


def remesh(devices: Optional[Sequence] = None,
           cfg: ElasticConfig = ElasticConfig()) -> MeshInfo:
    """The largest valid ``("data", "model")`` mesh over ``devices`` (any
    ``torch.device`` or device strings; default: every visible card — on a
    box without CUDA this raises, so name the CPU there)."""
    if devices is None:
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    dp, tp = largest_valid_mesh(len(devices), cfg)
    return MeshInfo(tuple(devices[:dp * tp]), ("data", "model"), (dp, tp),
                    dp_axes=("data",))


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
