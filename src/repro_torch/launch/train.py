"""End-to-end trainer — the counterpart of ``repro.launch.train``.

    python -m repro_torch.launch.train --arch gemma2-2b --steps 60 \\
        --device cpu

Runs on the card unless ``--device cpu`` (or ``device="cpu"``) is given.
A reduced config by default (``--full-config`` for the published
widths); posit QAT weight quantization (``--weights-format posit16``),
microbatching, checkpoint/restart (``--ckpt``: every 50 steps and at the
end, resumed from the latest), deterministic data resume (every batch a
function of the step) and the straggler watchdog.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import CONFIGS, reduced
from repro_torch.core.device import resolve_device
from repro_torch.core.policy import QuantPolicy
from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
from repro_torch.distributed.fault_tolerance import StepWatchdog
from repro_torch.launch.mesh import make_debug_mesh_info
from repro_torch.models import build_model
from repro_torch.train.step import init_train_state, make_train_step


def train(arch: str = "qwen3-8b", steps: int = 100, batch: int = 8,
          seq: int = 128, use_reduced: bool = True, policy=QuantPolicy(),
          ckpt_dir: str = None, microbatches: int = 1, log_every: int = 10,
          resume: bool = True, device=None):
    """Train ``arch`` for ``steps`` steps on ``device`` (None: the card);
    returns (the final state, the loss of each step run)."""
    dev = resolve_device(device)
    cfg = CONFIGS[arch]
    if use_reduced:
        cfg = reduced(cfg)
    minfo = make_debug_mesh_info(device=dev)
    model = build_model(cfg, policy, device=dev)
    pipe = TokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=seq, global_batch=batch))

    state = init_train_state(model.init(torch.Generator(dev).manual_seed(0)))
    step_fn = make_train_step(model, minfo, policy,
                              microbatches=microbatches)
    start = 0
    mgr = None
    if ckpt_dir:
        mgr = CheckpointManager(ckpt_dir, keep=3)
        if resume and mgr.latest_step() is not None:
            state, start = mgr.restore(state)
            print(f"[train] resumed from step {start}")

    watchdog = StepWatchdog(deadline_s=600.0)
    losses = []
    for step in range(start, steps):
        (state, metrics), dt = watchdog.run(step, step_fn, state,
                                            pipe.batch_at(step))
        losses.append(float(metrics["loss"]))
        if step % log_every == 0 or step == steps - 1:
            print(f"[train] step={step} loss={losses[-1]:.4f} "
                  f"({dt * 1e3:.0f} ms)", flush=True)
        if mgr and (step + 1) % 50 == 0:
            mgr.save(step + 1, state)
    if mgr:
        mgr.save(steps, state, block=True)
        mgr.wait()
    return state, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b", choices=sorted(CONFIGS))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full-config", action="store_true")
    ap.add_argument("--weights-format", default=None)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    policy = QuantPolicy(weights=args.weights_format)
    return train(args.arch, steps=args.steps, batch=args.batch,
                 seq=args.seq, use_reduced=not args.full_config,
                 policy=policy, ckpt_dir=args.ckpt,
                 microbatches=args.microbatches, device=args.device)


if __name__ == "__main__":
    main()
