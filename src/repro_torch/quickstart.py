"""Quickstart: posit arithmetic as a drop-in storage format, on the card.

    python -m repro_torch.quickstart [--device cpu]

The five steps of the reference's ``examples/quickstart.py``: the paper's
worked example (Fig. 2), rounding onto the posit16 lattice, posit16 against
fp16 range, posit16 codes through the decode-fused matmul kernel
(``kernels.ops.matmul``, one launch), and the posit8 KV-cache ratio.  It
runs on the card unless ``--device cpu`` is given, and raises without
CUDA.
"""
from __future__ import annotations

import argparse
from typing import Dict

import numpy as np
import torch

from repro_torch.core.arith import Arith
from repro_torch.core.device import resolve_device
from repro_torch.core.formats import POSIT16
from repro_torch.core.posit import decode, encode, round_to_posit
from repro_torch.kernels import ops


def run(device=None) -> Dict[str, object]:
    """Run the five steps on ``device`` (default: the card), print them as
    the reference does and return their numbers."""
    dev = resolve_device(device)
    out: Dict[str, object] = {}

    # 1. the paper's worked example (Fig. 2)
    pat = torch.tensor([0b1001101000111000], dtype=torch.int32, device=dev)
    out["fig2"] = float(decode(pat, POSIT16)[0])
    print("posit16 0b1001101000111000 =", out["fig2"])        # -46.25

    # 2. round a tensor onto the posit16 lattice
    x = torch.as_tensor(np.random.default_rng(0).normal(size=(4, 4)),
                        dtype=torch.float32, device=dev)
    out["round_err"] = float(torch.abs(x - round_to_posit(x, POSIT16)).max())
    print("max |x - posit16(x)| =", out["round_err"])

    # 3. dynamic range: posit16 survives where fp16 overflows
    big = torch.tensor([3e7, 6e4, 1e-6], dtype=torch.float32, device=dev)
    out["posit16"] = Arith.make("posit16").rnd(big).cpu().numpy()
    out["fp16"] = Arith.make("fp16").rnd(big).cpu().numpy()
    print("posit16:", out["posit16"])
    print("fp16:   ", out["fp16"])

    # 4. posit-quantized weights through the decode-fused matmul
    w = torch.as_tensor(np.random.default_rng(1).normal(size=(256, 256))
                        / 16, dtype=torch.float32, device=dev)
    a = torch.as_tensor(np.random.default_rng(2).normal(size=(128, 256)),
                        dtype=torch.float32, device=dev)
    qa, qw = encode(a, POSIT16), encode(w, POSIT16)
    prod = ops.matmul(qa, qw, POSIT16, bm=128, bn=128, bk=128)
    ref = a @ w
    out["matmul_rel_err"] = float(torch.linalg.norm(prod - ref)
                                  / torch.linalg.norm(ref))
    print("fused posit16 matmul rel err:", out["matmul_rel_err"])

    # 5. posit8 KV-cache memory ratio
    kv_bf16 = 2 * 32768 * 8 * 128 * 2
    kv_posit8 = 2 * 32768 * 8 * 128 * 1
    out["kv_ratio"] = kv_bf16 / kv_posit8
    print(f"decode-step KV bytes: bf16={kv_bf16/1e6:.0f}MB "
          f"posit8={kv_posit8/1e6:.0f}MB (x{kv_bf16/kv_posit8:.0f} less HBM "
          f"traffic)")
    return out


def main(argv=None) -> Dict[str, object]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    return run(parser.parse_args(argv).device)


if __name__ == "__main__":
    main()
