"""The paper's format study: posits against fp32, bf16, fp16 and the fp8s on
its two wearable workloads, on the card.

    python -m repro_torch.study [--device cpu] [--task cough|rpeak]

* cough (Fig. 4): AUC and FPR at 95 % TPR per format, at the sizes of the
  reference's ``examples/cough_demo.py`` (120 windows, a forest trained on
  280);
* rpeak (Fig. 5): mean R-peak F1 per format, at the sizes of
  ``examples/rpeak_demo.py`` (3 subjects × 5 segments of 12 s).

Runs on the card unless ``--device cpu`` is given, and raises without
CUDA.
"""
from __future__ import annotations

import argparse
from typing import Dict

from repro_torch.apps.bayeslope import run_rpeak_detection
from repro_torch.apps.cough import run_cough_detection
from repro_torch.core.device import resolve_device

COUGH_FORMATS = ("fp32", "posit24", "posit16", "posit16e3", "bfloat16",
                 "fp16")
RPEAK_FORMATS = ("fp32", "posit16", "posit12", "posit10", "posit8",
                 "bfloat16", "fp16", "fp8e5m2", "fp8e4m3")


def cough_study(device=None) -> Dict[str, Dict[str, float]]:
    res = run_cough_detection(COUGH_FORMATS, n_windows=120, n_train=280,
                              device=device)
    print(f"{'format':10s}  AUC    FPR@TPR0.95")
    for k, v in res.items():
        print(f"{k:10s}  {v['auc']:.3f}  {v['fpr_at_tpr95']:.3f}")
    print("\npaper's claim: 16-bit posits replace FP32 with minimal loss; "
          "FP16 collapses on the 24-bit-PCM FFT pipeline.")
    return res


def rpeak_study(device=None) -> Dict[str, float]:
    res = run_rpeak_detection(RPEAK_FORMATS, n_subjects=3,
                              segments_per_subject=5, segment_s=12.0,
                              device=device)
    print(f"{'format':10s}  F1")
    for k, v in res.items():
        print(f"{k:10s}  {v:.3f} {'#' * int(v * 40)}")
    print("\npaper's claim: posits stay >0.9 down to 8-10 bits; "
          "FP16 needs its full 16 and FP8E4M3 fails outright.")
    return res


def main(argv=None) -> Dict[str, object]:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="torch device (default: the card)")
    parser.add_argument("--task", choices=("cough", "rpeak"), default=None,
                        help="one study only (default: both)")
    args = parser.parse_args(argv)
    dev = resolve_device(args.device)
    out = {}
    if args.task in (None, "cough"):
        out["cough"] = cough_study(dev)
    if args.task in (None, "rpeak"):
        out["rpeak"] = rpeak_study(dev)
    return out


if __name__ == "__main__":
    main()
