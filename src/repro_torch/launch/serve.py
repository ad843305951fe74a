"""Serving entry point: init a reduced model of one architecture, open a
precision lane per ServePolicy, run continuous-batching generation, print
the token ledger — the port of ``repro.launch.serve``.

    PYTHONPATH=src python -m repro_torch.launch.serve [--device cpu]

``--device`` defaults to the card; without CUDA the run needs
``--device cpu``.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.configs import CONFIGS, reduced
from repro_torch.core.device import resolve_device
from repro_torch.models import build_model
from repro_torch.serve import ServeConfig, ServePolicy, ServingEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-2b", choices=sorted(CONFIGS))
    ap.add_argument("--weights-format", default="posit16",
                    help="posit weight storage ('none' → native)")
    ap.add_argument("--kv-format", default="posit8",
                    help="posit KV-cache storage ('none' → bf16)")
    ap.add_argument("--batch", type=int, default=4,
                    help="slots per precision lane")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--new-tokens", type=int, default=24)
    ap.add_argument("--max-prompt", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card)")
    args = ap.parse_args(argv)

    def fmt(name):
        return None if name in ("none", "") else name

    dev = resolve_device(args.device)
    if dev.type == "cuda":   # f32 accumulation, as the reference
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    cfg = reduced(CONFIGS[args.arch])
    policy = ServePolicy(weights=fmt(args.weights_format),
                         kv=fmt(args.kv_format))
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(0))
    eng = ServingEngine(model, params,
                        ServeConfig(batch_size=args.batch,
                                    max_prompt=args.max_prompt,
                                    max_new_tokens=args.new_tokens,
                                    temperature=args.temperature,
                                    seed=args.seed),
                        policy, device=dev)
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        eng.submit(rng.integers(0, cfg.vocab, size=rng.integers(4, 16))
                   .astype(np.int32))
    for c in sorted(eng.run(), key=lambda c: c.rid):
        print(f"[serve] rid={c.rid}: prompt_len={c.prompt_len} "
              f"finish={c.finish_reason} generated={c.tokens.tolist()}")
    for lane, row in eng.ledger.summary().items():
        print(f"[ledger] {lane}: requests={row['requests']:.0f} "
              f"us_per_token={row['us_per_token']:.0f} "
              f"nj_per_token={row['nj_per_token']:.1f}")


if __name__ == "__main__":
    main()
