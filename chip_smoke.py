#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit, then the build of the CUDA kernels
     (one nvcc per source, in parallel) and its time;
  2. each kernel against its plain torch version on the card: the round,
     the butterfly, the codec's decode and encode bitwise, the rounded
     matmul within one format ulp, the posit-KV attention within
     rtol = atol = 2e-5;
  3. the stream path: a 64-patient fleet (32 cough patients at posit16
     with every fourth pinned to fp16, 32 ECG patients at posit10 with
     every fourth pinned to posit8)
     streamed in ragged chunks through ``StreamEngine``, with every window
     scored exactly once, every stream kernel's launch count above zero,
     and the outputs checked against the same windows run by the port on
     the CPU; then the same fleet once more under ``torch.profiler`` for
     the device's busy share and its top kernels;
  4. each kernel's median time per call (CUDA events) and its device time
     per launch (profiler) beside its bound, its plain version's time and,
     where one exists, one library call's;
  5. the serve path: qwen3-8b at full width (36 layers, random weights from
     a seeded generator on the card) behind ``ServingEngine`` with two
     lanes (posit16 weights; posit8 and posit16 KV), 12 requests, every
     request completed once, the codec and KV-attention kernels launched
     (36 KV-attention launches per decode step), greedy tokens reproduced
     by a second engine with eight of its steps under ``torch.profiler``
     (the device's busy share), the KV-attention kernel
     held against its plain version on the live cache, and the reduced
     config's logits on the card against the same weights on the CPU;
  6. the format study: R-peak F1 over nine formats and cough AUC over
     three on the card, the paper's orderings asserted, three formats'
     F1 card against CPU; the quickstart (one decode-fused matmul launch);
     ``Arith.fma`` (one multiply-add launch per call).

Phase 2 also holds the multiply-add bitwise and the decode-fused matmul
within 1e-5 of its largest output against their plain versions, the IEEE
rounding on the card bitwise against the CPU's, and quire-mode dot and
matmul on the card against the exact oracle; phase 3's fleet pins every
fourth cough patient to fp16; phase 4 times both new kernels.  Each phase
prints its wall time.

The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or without
the repository's ``src/repro_torch`` beside this file, it exits non-zero
and prints no result.  It imports nothing of jax and nothing of ``repro``.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
N_PATIENTS = 64
N_WINDOWS = 4
MAX_BATCH = 32
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
SERVE_ARCH = "qwen3-8b"
SERVE_BATCH = 4                # slots per lane
SERVE_MAX_PROMPT = 64
SERVE_NEW_TOKENS = 32
SERVE_PROMPTS = 6              # each submitted on both lanes: 12 requests
PROFILE_STEPS = (8, 16)         # engine steps profiled in phase 5
KV_TOL = dict(rtol=2e-5, atol=2e-5)
MATMUL_REL_TOL = 1e-5          # decode-fused matmul: of its largest output
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
FFN_SHAPE = (64, 4096, 12288)  # qwen3-8b's FFN width, 64 rows
# the format study at the reference suite's sizes (tests/test_apps.py)
RPEAK_FORMATS = ("fp32", "posit16", "posit12", "posit10", "posit8",
                 "bfloat16", "fp16", "fp8e5m2", "fp8e4m3")
COUGH_FORMATS = ("fp32", "posit16", "fp16")
# the paper's values, as tests/test_apps.py records them beside its asserts
PAPER_F1 = {"fp32": "0.989", "posit16": "0.989", "posit10": "0.975",
            "fp16": "0.948", "fp8e4m3": "fails"}
PAPER_AUC = {"fp32": "0.919", "posit16": "0.876", "fp16": "0.763"}
IEEE_FORMATS = ("fp16", "bfloat16", "fp8e5m2", "fp8e4m3")
LOGIT_TOL = dict(rtol=2e-2, atol=2e-2)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 10, samples: int = 21) -> float:
    """Median milliseconds per call: ``samples`` event pairs, each around
    ``reps`` back-to-back calls, after warmup."""
    import torch
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def device_ms(fn, kernel: str, reps: int = 50) -> float:
    """Mean device time per launch of the kernel whose name contains
    ``kernel``, from ``torch.profiler`` over ``reps`` calls (no host time);
    NaN if the profiler recorded none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if kernel in e.key]
    n = sum(e.count for e in hits)
    us = sum(getattr(e, "self_device_time_total", 0) for e in hits)
    return us / n / 1e3 if n and us else float("nan")


def bits_equal(a, b) -> bool:
    import torch
    idt = torch.int32 if a.dtype == torch.float32 else torch.int64
    return bool(torch.equal(a.contiguous().view(idt),
                            b.contiguous().view(idt)))


def max_abs_err(a, b) -> float:
    import torch
    both_nan = torch.isnan(a) & torch.isnan(b)
    d = torch.where(both_nan, torch.zeros_like(a), (a - b).abs())
    d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
    return float(d.max()) if d.numel() else 0.0


def ulp_distance(a, b, fmt):
    """Distance in posit patterns (1 == one format ulp) between values."""
    import torch
    from repro_torch.core.posit import encode

    def ordered(v):   # n-bit two's complement as a signed int: value order
        p = encode(v, fmt).to(torch.int64) & fmt.mask
        return (p ^ fmt.nar_pattern) - fmt.nar_pattern
    return (ordered(a) - ordered(b)).abs()


# ---------------------------------------------------------------------------
# Phase 2: every kernel against its plain version on the card
# ---------------------------------------------------------------------------

def lattice_and_midpoints(fmt, dev):
    import torch
    from repro_torch.core.posit import decode
    vals = decode(torch.arange(1 << fmt.n, dtype=torch.int64), fmt)
    vals = torch.sort(vals[~torch.isnan(vals)]).values
    mids = (vals[:-1] + vals[1:]) / 2
    return torch.cat([vals, mids]).to(dev)


def random_f32(gen, n, dev):
    import torch
    x = torch.randn(n, generator=gen) * torch.exp2(
        torch.randint(-150, 128, (n,), generator=gen).float())
    special = torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                            float("nan"), 1e-40, -1e-40, 1e-45, 3e38,
                            -3e38])
    return torch.cat([x, special]).to(dev)


def check_kernels(dev, report):
    import torch
    from repro_torch.apps.cough import FFT_N
    from repro_torch.apps.dsp import _dct_basis, _mel_filterbank, get_fft_plan
    from repro_torch.core.formats import get_format
    from repro_torch.data.biosignals import AUDIO_SR
    from repro_torch.kernels.posit_matmul import (posit_matmul_round,
                                                  posit_matmul_round_torch)
    from repro_torch.kernels.posit_round import (posit_butterfly,
                                                 posit_butterfly_torch,
                                                 posit_round,
                                                 posit_round_torch)
    gen = torch.Generator().manual_seed(SEED)

    # posit_round: lattices and midpoints, random f32 with specials, f64
    err = 0.0
    cases = []
    for name in ("posit16", "posit10"):
        cases.append((name, lattice_and_midpoints(get_format(name), dev)))
    for name in ("posit8", "posit10", "posit16"):
        cases.append((name, random_f32(gen, 1 << 20, dev)))
    grid64 = (torch.randn(1 << 18, generator=gen, dtype=torch.float64)
              * torch.exp2(torch.randint(-140, 140, (1 << 18,),
                                         generator=gen).double()))
    cases.append(("posit32", torch.cat([grid64, torch.tensor(
        [0.0, 1e-310, -1e-310, float("inf"), float("nan")],
        dtype=torch.float64)]).to(dev)))
    for name, x in cases:
        fmt = get_format(name)
        k, p = posit_round(x, fmt), posit_round_torch(x, fmt)
        torch.cuda.synchronize()
        if not bits_equal(k, p):
            raise AssertionError(f"posit_round {name} {x.dtype}: not bitwise "
                                 f"equal to its plain version")
        err = max(err, max_abs_err(k, p))
        log(f"  posit_round {name} {str(x.dtype)[6:]} n={x.numel()}: bitwise")
    report["posit_round"]["max_abs_err"] = err

    # posit_butterfly: FFT stage planes at cough batch 32, both layouts
    fmt = get_format("posit16")
    plan = get_fft_plan(FFT_N, fmt.name, torch.float32, str(dev))
    err = 0.0
    for stage, (L, half, tr) in ((2, (4, 512, True)), (8, (256, 8, False))):
        shape = (MAX_BATCH, 2, L, half) if tr else (MAX_BATCH, 2, half, L)
        planes = [posit_round_torch(
            (torch.randn(shape, generator=gen) * 2.0 ** 20).to(dev), fmt)
            for _ in range(4)]
        wr, wi = plan.stages[stage]
        tw = (1, 1, -1, 1) if tr else (1, 1, 1, -1)
        ws = (wr.reshape(tw), wi.reshape(tw))
        k = posit_butterfly(*planes, *ws, fmt)
        p = posit_butterfly_torch(*planes, *ws, fmt)
        torch.cuda.synchronize()
        for a, b in zip(k, p):
            if not bits_equal(a, b):
                raise AssertionError(f"posit_butterfly stage {stage}: not "
                                     f"bitwise equal to its plain version")
            err = max(err, max_abs_err(a, b))
        log(f"  posit_butterfly stage {stage} plane {shape}: bitwise")
    report["posit_butterfly"]["max_abs_err"] = err

    # posit_matmul_round: the main path's shapes, within one format ulp
    rows = MAX_BATCH * 2
    mel = _mel_filterbank(FFT_N // 2 + 1, AUDIO_SR, 20, fmt.name,
                          torch.float32, str(dev)).T.contiguous()
    dct = _dct_basis(20, 13, fmt.name, torch.float32, str(dev)).T.contiguous()
    psd = posit_round_torch(torch.rand(rows, FFT_N // 2 + 1, generator=gen)
                            .to(dev) * 2.0 ** 40, fmt)
    shapes = {
        "mel": (psd, mel),
        "dct": (posit_round_torch(torch.randn(rows, 20, generator=gen)
                                  .to(dev) * 30, fmt), dct),
        "centroid": (psd, torch.linspace(0, 8000, FFT_N // 2 + 1,
                                         device=dev)[:, None].contiguous()),
        "votes": (posit_round_torch(torch.rand(MAX_BATCH, 10, generator=gen)
                                    .to(dev), fmt),
                  torch.ones(10, 1, device=dev)),
    }
    err = 0.0
    for name, (a, b) in shapes.items():
        k = posit_matmul_round(a, b, fmt)
        p = posit_matmul_round_torch(a, b, fmt)
        torch.cuda.synchronize()
        dist = ulp_distance(k, p, fmt)
        if int(dist.max()) > 1:
            raise AssertionError(f"posit_matmul_round {name}: "
                                 f"{int(dist.max())} ulp from the plain "
                                 f"version")
        share = float((dist != 0).float().mean())
        err = max(err, max_abs_err(k, p))
        log(f"  posit_matmul_round {name} {tuple(a.shape)}x{tuple(b.shape)}:"
            f" within 1 ulp, {share:.4f} of outputs not bitwise equal")
    report["posit_matmul_round"]["max_abs_err"] = err
    return shapes


def nan_aware_equal(a, b) -> bool:
    """Bitwise equal, counting any NaN equal to any NaN (the card's
    float-to-bf16 conversion writes another NaN payload than the CPU's)."""
    import torch
    na, nb = torch.isnan(a.float()), torch.isnan(b.float())
    idt = {torch.float64: torch.int64, torch.float32: torch.int32}.get(
        a.dtype, torch.int16)
    return bool(torch.equal(na, nb)) and bool(torch.equal(
        torch.where(na, 0, a.view(idt)), torch.where(nb, 0, b.view(idt))))


def kv_case(gen, B, S, KV, G, D, fmt, dev):
    """q (B, KV, G, D) and posit K/V bits (B, S, KV, D) of normal values."""
    import torch
    from repro_torch.kernels.posit_codec import posit_encode_torch
    q = torch.randn(B, KV, G, D, generator=gen).to(dev)
    k = posit_encode_torch(torch.randn(B, S, KV, D, generator=gen).to(dev),
                           fmt)
    v = posit_encode_torch(torch.randn(B, S, KV, D, generator=gen).to(dev),
                           fmt)
    return q, k, v


def check_serve_kernels(dev, report):
    """Decode and encode bitwise; the posit-KV attention within 2e-5."""
    import torch
    from repro_torch.core.formats import PositFormat, get_format
    from repro_torch.kernels.posit_codec import (posit_decode,
                                                 posit_decode_torch,
                                                 posit_encode,
                                                 posit_encode_torch)
    from repro_torch.kernels.posit_kv_attention import (
        posit_kv_attention, posit_kv_attention_torch)
    gen = torch.Generator().manual_seed(SEED + 2)

    # decode: every posit8/posit16 pattern, random posit(12, 2) bits
    cases = [(get_format(f"posit{n}"),
              torch.arange(1 << n).to(torch.int32).to(
                  get_format(f"posit{n}").storage_dtype).to(dev))
             for n in (8, 16)]
    p12 = PositFormat(12, 2)
    cases.append((p12, torch.randint(-2 ** 15, 2 ** 15, (1 << 20,),
                                     generator=gen, dtype=torch.int16)
                  .to(dev)))
    for fmt, bits in cases:
        for out_dtype in (torch.float32, torch.bfloat16):
            k = posit_decode(bits, fmt, out_dtype)
            p = posit_decode_torch(bits, fmt, out_dtype)
            torch.cuda.synchronize()
            if not nan_aware_equal(k, p):
                raise AssertionError(f"posit_decode {fmt.name} -> "
                                     f"{out_dtype}: not bitwise equal to "
                                     f"its plain version")
        log(f"  posit_decode {fmt.name} {bits.numel()} patterns to f32 and "
            f"bf16: bitwise")
    report["posit_decode"]["max_abs_err"] = 0.0

    # encode: random f32 with specials, every lattice point and midpoint
    for fmt in (get_format("posit8"), get_format("posit16"), p12):
        for what, x in (("random f32", random_f32(gen, 1 << 20, dev)),
                        ("lattice+midpoints",
                         lattice_and_midpoints(fmt, dev))):
            k, p = posit_encode(x, fmt), posit_encode_torch(x, fmt)
            torch.cuda.synchronize()
            if not torch.equal(k, p):
                raise AssertionError(f"posit_encode {fmt.name} {what}: not "
                                     f"bitwise equal to its plain version")
            log(f"  posit_encode {fmt.name} {what} n={x.numel()}: bitwise")
    report["posit_encode"]["max_abs_err"] = 0.0

    # kv-attention: the serve shape and a long ragged cache
    err = 0.0
    for name in ("posit8", "posit16"):
        fmt = get_format(name)
        for S in (96, 32768):
            q, kb, vb = kv_case(gen, 4, S, 8, 4, 128, fmt, dev)
            lengths = torch.tensor([0, 1, 777, S], dtype=torch.int32,
                                   device=dev)
            k = posit_kv_attention(q, kb, vb, lengths, fmt)
            p = posit_kv_attention_torch(q, kb, vb, lengths, fmt)
            torch.cuda.synchronize()
            if not torch.allclose(k, p, **KV_TOL):
                raise AssertionError(f"posit_kv_attention {name} S={S}: "
                                     f"{max_abs_err(k, p)} from its plain "
                                     f"version")
            if not torch.all(k[0] == 0):
                raise AssertionError("posit_kv_attention: length 0 row is "
                                     "not zero")
            err = max(err, max_abs_err(k, p))
            log(f"  posit_kv_attention {name} (4, {S}, 8, 128) lengths "
                f"{lengths.tolist()}: within 2e-5, max abs err "
                f"{max_abs_err(k, p):.3g}")
    report["posit_kv_attention"]["max_abs_err"] = err


def ieee_inputs():
    """The inputs of tests/test_torch_ieee.py: 2^20 random f32 values with
    specials, every finite fp16 value and midpoint, the fp8 overflow edges;
    and an f64 grid with the double-rounding cases."""
    import numpy as np
    rng = np.random.default_rng(0)
    with np.errstate(over="ignore"):
        x = (rng.standard_normal(1 << 20)
             * np.exp2(rng.integers(-150, 128, 1 << 20))).astype(np.float32)
    half = np.arange(1 << 16, dtype=np.uint16).view(np.float16)
    half = np.sort(half[np.isfinite(half)].astype(np.float64))
    mids = (half[:-1] + half[1:]) / 2
    edges = [448.0, 460.0, 463.9, 464.0, 464.01, 480.0, 500.0, 1e5, 65504.0,
             65519.99, 65520.0, 57344.0, 61440.0, np.inf, 0.0, 1e-40, 1e-45,
             2.0 ** -24, 2.0 ** -25, 2.0 ** -9, 2.0 ** -10, 2.0 ** -16, 3e38]
    e32 = np.asarray(edges + [np.nan])
    with np.errstate(over="ignore"):
        f32 = np.concatenate([x, half, mids, e32, -e32]).astype(np.float32)
    rng = np.random.default_rng(1)
    g = rng.standard_normal(1 << 16) * np.exp2(rng.integers(-40, 20, 1 << 16))
    near = np.concatenate([mids * (1 + 2.0 ** -40), mids * (1 - 2.0 ** -40),
                           mids * (1 + 2.0 ** -30)])
    crafted = [1 + 2 ** -11 + 2 ** -40, 1 + 2 ** -8 + 2 ** -40,
               1 + 2 ** -3 + 2 ** -40, 1 + 2 ** -4 + 2 ** -40,
               2 ** -25 + 2 ** -60, 464.0000001, 463.99999999, 1e300, 1e-300]
    e64 = np.asarray(edges + crafted + [np.nan])
    return f32, np.concatenate([g, half, mids, near, e64, -e64])


def rel_err(k, p) -> float:
    """max |k - p| over max |p|."""
    return float((k - p).abs().max() / p.abs().max())


def matmul_case(gen, M, K, N, fmt, dev):
    """Posit bits of realistic magnitudes: a (M, K) ~ N(0, 1) and
    b (K, N) ~ N(0, 1/K), encoded on the card."""
    import torch
    from repro_torch.kernels.posit_codec import posit_encode_torch
    a = posit_encode_torch(torch.randn(M, K, generator=gen).to(dev), fmt)
    b = posit_encode_torch((torch.randn(K, N, generator=gen)
                            / K ** 0.5).to(dev), fmt)
    return a, b


def check_format_kernels(dev, report):
    """The multiply-add bitwise, the decode-fused matmul within 1e-5 of its
    largest output, the IEEE rounding on the card bitwise against the CPU,
    quire-mode dot and matmul on the card against the exact oracle."""
    import numpy as np
    import torch
    from repro_torch.core.arith import Arith, backend_overrides
    from repro_torch.core.floatsim import round_to_float
    from repro_torch.core.formats import get_format
    from repro_torch.core.posit import decode, encode
    from repro_torch.core.quire import quire_dot_exact
    from repro_torch.kernels.posit_matmul import (posit_matmul,
                                                  posit_matmul_torch)
    from repro_torch.kernels.posit_round import (posit_fma_round,
                                                 posit_fma_round_torch)
    gen = torch.Generator().manual_seed(SEED + 4)

    # multiply-add: random f32 with specials, c = -fl(a*b) (where a
    # contracted FMA differs), broadcast operands, an f64 grid
    err = 0.0
    cases = [(name, [random_f32(gen, 1 << 20, dev) for _ in range(3)])
             for name in ("posit8", "posit10", "posit16")]
    a = (torch.randn(1 << 20, generator=gen) * 37).to(dev)
    b = (torch.randn(1 << 20, generator=gen) * 11).to(dev)
    cases.append(("posit16", [a, b, -(a * b)]))
    cases.append(("posit10", [a[:4096, None], b[None, :256],
                              torch.tensor(0.5, device=dev)]))
    for name in ("posit24", "posit32"):
        cases.append((name, [(torch.randn(1 << 18, generator=gen,
                                          dtype=torch.float64)
                              * torch.exp2(torch.randint(
                                  -100, 100, (1 << 18,), generator=gen)
                                  .double())).to(dev) for _ in range(3)]))
    for i, (name, ops) in enumerate(cases):
        fmt = get_format(name)
        k, p = posit_fma_round(*ops, fmt), posit_fma_round_torch(*ops, fmt)
        torch.cuda.synchronize()
        if not bits_equal(k, p):
            raise AssertionError(f"posit_fma_round {name} case {i}: not "
                                 f"bitwise equal to its plain version")
        if i == 3 and not torch.all(k == 0):
            raise AssertionError("posit_fma_round: a*b - fl(a*b) is not 0: "
                                 "the multiply-add was contracted")
        err = max(err, max_abs_err(k, p))
        log(f"  posit_fma_round {name} {tuple(k.shape)} "
            f"{str(k.dtype)[6:]}{' c = -fl(a*b)' if i == 3 else ''}: "
            f"bitwise")
    report["posit_fma_round"]["max_abs_err"] = err

    # decode-fused matmul: the quickstart's shape and the FFN width
    err = 0.0
    for name in ("posit16", "posit8"):
        fmt = get_format(name)
        for M, K, N in ((128, 256, 256), FFN_SHAPE):
            a, b = matmul_case(gen, M, K, N, fmt, dev)
            k, p = posit_matmul(a, b, fmt), posit_matmul_torch(a, b, fmt)
            torch.cuda.synchronize()
            rel = rel_err(k, p)
            if not rel <= MATMUL_REL_TOL:
                raise AssertionError(f"posit_matmul {name} ({M}, {K}) x "
                                     f"({K}, {N}): {rel:.3g} of the largest "
                                     f"output from its plain version")
            err = max(err, max_abs_err(k, p))
            log(f"  posit_matmul {name} ({M}, {K}) x ({K}, {N}): max "
                f"error {rel:.3g} of the largest output (tolerance "
                f"{MATMUL_REL_TOL:g}), max abs err {max_abs_err(k, p):.3g}")
    report["posit_matmul"]["max_abs_err"] = err

    # IEEE rounding: the card's run bitwise against the CPU's
    f32, f64 = ieee_inputs()
    for name in IEEE_FORMATS:
        for x in (torch.from_numpy(f32), torch.from_numpy(f64)):
            k = round_to_float(x.to(dev), get_format(name)).cpu()
            p = round_to_float(x, get_format(name))
            if not nan_aware_equal(k, p):
                raise AssertionError(f"round_to_float {name} {x.dtype}: the "
                                     f"card's bits differ from the CPU's")
        log(f"  round_to_float {name}: {len(f32)} f32 and {len(f64)} f64 "
            f"values, the card bitwise equal to the CPU")

    # quire mode: dot and matmul on the card against the exact oracle
    rng = np.random.default_rng(SEED + 4)
    for name in ("posit8", "posit10", "posit16"):
        fmt = get_format(name)
        ar = Arith.make(name)

        def bits(*shape):
            v = rng.integers(0, 1 << fmt.n, size=shape)
            v[v == fmt.nar_pattern] = 0
            return v.astype(np.int64)

        def on_card(v):
            return decode(torch.from_numpy(v).to(dev), fmt)

        with backend_overrides(quire="on"):
            for k in (1, 17, 201):
                a, b = bits(k), bits(k)
                got = int(encode(ar.dot(on_card(a), on_card(b)), fmt)) \
                    & fmt.mask
                if got != quire_dot_exact(a, b, fmt):
                    raise AssertionError(f"quire dot {name} k={k} on the "
                                         f"card misses the exact oracle")
            A, B = bits(5, 37), bits(37, 4)
            got = (encode(ar.matmul(on_card(A), on_card(B)), fmt).cpu()
                   .to(torch.int64) & fmt.mask)
            for i in range(5):
                for j in range(4):
                    if int(got[i, j]) != quire_dot_exact(A[i], B[:, j], fmt):
                        raise AssertionError(f"quire matmul {name} [{i}, "
                                             f"{j}] on the card misses the "
                                             f"exact oracle")
        log(f"  quire-mode {name} dot (k = 1, 17, 201) and (5, 37) x (37, 4) "
            f"matmul on the card: equal to the exact oracle")


# ---------------------------------------------------------------------------
# Phase 3: the main path
# ---------------------------------------------------------------------------

def build_fleet(rng):
    """Per-patient chunk queues: half cough, half ECG; every fourth cough
    patient pinned to fp16 and every fourth ECG patient to posit8, as the
    reference's mixed fleet (benchmarks/stream_bench.py) pins them."""
    from repro_torch.data.biosignals import (cough_stream_signals,
                                             ecg_stream_signal, ragged_chunks)
    from repro_torch.stream.pipelines import RPEAK_WINDOW_S
    queues, pins, records = [], {}, {}
    n_cough = N_PATIENTS // 2
    for p in range(N_PATIENTS):
        if p < n_cough:
            pid = f"cough-{p:03d}"
            a, i, _ = cough_stream_signals(N_WINDOWS, seed=p)
            records[pid] = (a, i)
            queues.append((pid, "cough", "audio",
                           list(ragged_chunks(a, rng, 400, 9600))))
            queues.append((pid, "cough", "imu",
                           list(ragged_chunks(i, rng, 4, 60))))
            if p % 4 == 3:
                pins[pid] = ("cough", "fp16")
        else:
            pid = f"ecg-{p - n_cough:03d}"
            s, true_r = ecg_stream_signal(N_WINDOWS * RPEAK_WINDOW_S,
                                          seed=1000 + p)
            records[pid] = (s, true_r)
            queues.append((pid, "rpeak", "ecg",
                           list(ragged_chunks(s[None, :], rng, 50, 1000))))
            if p % 4 == 3:
                pins[pid] = ("rpeak", "posit8")
    return queues, pins, records


def run_main_path(dev, forest, counters):
    import numpy as np
    from repro_torch.stream import StreamEngine, cough_pipeline, rpeak_pipeline
    rng = np.random.default_rng(SEED)
    queues, pins, records = build_fleet(rng)
    engine = StreamEngine({"cough": cough_pipeline(forest),
                           "rpeak": rpeak_pipeline()},
                          max_batch=MAX_BATCH, device=dev)
    for pid, (task, fmt) in pins.items():
        engine.register_patient(pid, task, fmt=fmt)
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    live = [q for q in queues if q[3]]
    while live:
        k = int(rng.integers(len(live)))
        pid, task, mod, chunks = live[k]
        engine.ingest(pid, task, mod, chunks.pop(0))
        if not chunks:
            live.pop(k)
    engine.drain()
    engine.finalize_all()
    wall = time.perf_counter() - t0
    launches = {c.__name__: c.launches for c in counters}
    return engine, records, pins, wall, launches


def check_main_path(engine, records, pins, forest, wall, launches):
    import numpy as np
    import torch
    from repro_torch.apps.bayeslope import detect_rpeaks
    from repro_torch.apps.cough import extract_features, make_cough_scorer
    from repro_torch.apps.metrics import rpeak_f1
    from repro_torch.core.arith import Arith
    from repro_torch.data.biosignals import AUDIO_SR, ECG_FS, IMU_SR, WINDOW_S

    results = engine.pop_results()
    seen = {}
    for r in results:
        seen[(r.patient, r.widx)] = seen.get((r.patient, r.widx), 0) + 1
    want = {(pid, w) for pid in records for w in range(N_WINDOWS)}
    if set(seen) != want or any(v != 1 for v in seen.values()):
        raise AssertionError(f"windows not scored exactly once: "
                             f"{len(seen)} distinct of {len(want)}, "
                             f"{sum(seen.values())} results")
    summary = engine.fleet_summary()
    if summary["fleet"]["windows"] != len(want):
        raise AssertionError(f"ledger counted {summary['fleet']['windows']} "
                             f"windows, expected {len(want)}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"{name} never launched on the main path")
    log(f"  windows scored: {len(results)} in {wall:.3f} s "
        f"({len(results) / wall:.1f} windows/s, host clock)")
    for key, row in summary.items():
        log(f"  ledger {key}: {row['windows']} windows, "
            f"{row['nj_per_window']:.3f} nJ/window")
    log(f"  launches on the main path: {launches}")

    # outputs: finite, the expected shapes, and equal to the same windows
    # run by the port on the CPU (tier 2: p_cough within one format ulp,
    # identical R-peak lists)
    fmts = {(r.patient, r.fmt) for r in results}
    for pid, (task, fmt) in pins.items():
        if (pid, fmt) not in fmts:
            raise AssertionError(f"{pid} was pinned to {fmt} but not run "
                                 f"in it")
    p_gpu = {}
    for r in results:
        out = r.outputs
        if r.task == "cough":
            p = np.asarray(out["p_cough"])
            if p.shape != () or not (0.0 <= float(p) <= 1.0):
                raise AssertionError(f"bad p_cough {p!r} for {r.patient}")
            p_gpu[(r.patient, r.widx)] = float(p)
        else:
            s = np.asarray(out["scores"])
            if s.shape != (500,) or not np.all(np.isfinite(s)):
                raise AssertionError(f"bad scores for {r.patient}")
    n_a, n_i = int(AUDIO_SR * WINDOW_S), int(IMU_SR * WINDOW_S)
    ref_pids = ["cough-000", "cough-001"]
    audio = np.stack([records[p][0][:, w * n_a:(w + 1) * n_a]
                      for p in ref_pids for w in range(N_WINDOWS)])
    imu = np.stack([records[p][1][:, w * n_i:(w + 1) * n_i]
                    for p in ref_pids for w in range(N_WINDOWS)])
    ar = Arith.make("posit16")
    feats = [extract_features(ar, torch.as_tensor(audio, dtype=torch.float32,
                                                  device=d),
                              torch.as_tensor(imu, dtype=torch.float32,
                                              device=d)).cpu()
             for d in (engine.device, "cpu")]
    dist = int(ulp_distance(*feats, ar.fmt).max())
    if dist > 1:
        raise AssertionError(f"cough features on the card are {dist} ulp "
                             f"from the CPU run")
    p_cpu = make_cough_scorer("posit16", forest, device="cpu")(
        audio, imu).numpy()
    got = np.asarray([p_gpu[(p, w)] for p in ref_pids
                      for w in range(N_WINDOWS)], np.float32)
    log(f"  cough features of {len(got)} windows within {dist} ulp of the "
        f"CPU run; p_cough equal in {int(np.sum(got == p_cpu))} of "
        f"{len(got)}")
    # an fp16 patient: features within one fp16 ulp of the CPU run (the
    # IEEE chains are bitwise; the MFCC's log is each device's libm)
    pid = "cough-003"
    a16 = np.stack([records[pid][0][:, w * n_a:(w + 1) * n_a]
                    for w in range(N_WINDOWS)])
    i16 = np.stack([records[pid][1][:, w * n_i:(w + 1) * n_i]
                    for w in range(N_WINDOWS)])
    ar16 = Arith.make("fp16")
    f16 = [extract_features(
        ar16, torch.as_tensor(a16, dtype=torch.float32, device=d),
        torch.as_tensor(i16, dtype=torch.float32, device=d)).cpu()
        for d in (engine.device, "cpu")]
    if not torch.equal(torch.isnan(f16[0]), torch.isnan(f16[1])):
        raise AssertionError("fp16 cough features: NaNs differ between the "
                             "card and the CPU")
    h = [torch.nan_to_num(f, nan=0.0).to(torch.float16).view(torch.int16)
         .to(torch.int64) for f in f16]
    h = [torch.where(v < 0, -(v & 0x7FFF), v) for v in h]
    dist16 = int((h[0] - h[1]).abs().max())
    if dist16 > 1:
        raise AssertionError(f"fp16 cough features on the card are {dist16} "
                             f"fp16 ulp from the CPU run")
    p16 = make_cough_scorer("fp16", forest, device="cpu")(a16, i16).numpy()
    g16 = np.asarray([p_gpu[(pid, w)] for w in range(N_WINDOWS)], np.float32)
    log(f"  fp16 patient {pid}: features within {dist16} fp16 ulp of the "
        f"CPU run; p_cough equal in {int(np.sum(g16 == p16))} of "
        f"{len(g16)}")
    ecg = sorted(p for p in records if p.startswith("ecg"))
    peaks_per, f1s = [], []
    for pid in ecg:
        peaks = engine.tracker_for(pid, "rpeak").peaks
        peaks_per.append(len(peaks))
        f1s.append(rpeak_f1(peaks, records[pid][1], ECG_FS)[0])
    for pid in (ecg[0], ecg[3]):
        fmt = pins.get(pid, ("rpeak", "posit10"))[1]
        ref = detect_rpeaks(Arith.make(fmt), records[pid][0], device="cpu")
        if engine.tracker_for(pid, "rpeak").peaks != ref:
            raise AssertionError(f"R-peaks of {pid} ({fmt}) differ from the "
                                 f"CPU run")
    log(f"  R-peaks per ECG patient: {peaks_per}; mean F1 against the "
        f"records' true R positions {float(np.mean(f1s)):.4f}; {ecg[0]} and "
        f"{ecg[3]} equal the CPU run")
    if float(np.mean(f1s)) < 0.8:
        raise AssertionError(f"R-peak F1 {np.mean(f1s):.4f} below 0.8")
    return len(results), wall


def report_busy(prof, wall: float, what: str, top: int) -> None:
    """Log the device's busy share of ``wall`` seconds and its top kernels,
    from the device-side (kernel and memcpy) events of a profile: an
    operator's own row carries the device time of the kernels it launched,
    so summing every row would count that time twice."""
    from torch.autograd import DeviceType
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0]
    if not rows:
        log(f"  {what}: the profiler recorded no device time: not measured")
        return
    busy_s = sum(r[0] for r in rows) * 1e-6
    log(f"  {what}: {wall:.3f} s wall, device busy {busy_s * 1e3:.2f} ms "
        f"({100 * busy_s / wall:.2f}% of wall)")
    for us, count, key in sorted(rows, reverse=True)[:top]:
        log(f"    {us / 1e3:9.3f} ms {count:7d} calls  {key[:70]}")


def profile_main_path(dev, forest, counters):
    """The main path once more under ``torch.profiler``: device busy share
    of the host-clock window and the kernels that take the device time.
    The launch counts were read from the first run; this one only times."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_main_path(dev, forest, counters)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    report_busy(prof, wall, "under the profiler", 6)


# ---------------------------------------------------------------------------
# Phase 5: the serve path
# ---------------------------------------------------------------------------

def serve_requests(cfg):
    """SERVE_PROMPTS prompts of 8-64 tokens from a numpy seed, each to be
    submitted once on each lane with the same options: prompt 1 sampled at
    temperature 0.8, prompt 2 stopped at an EOS id (set by the caller)."""
    import numpy as np
    rng = np.random.default_rng(SEED)
    lens = rng.integers(8, SERVE_MAX_PROMPT + 1, SERVE_PROMPTS)
    return [dict(prompt=rng.integers(0, cfg.vocab, n).astype(np.int32),
                 temperature=0.8 if i == 1 else 0.0)
            for i, n in enumerate(lens)]


def serve_engine(model, params, dev):
    from repro_torch.serve import ServeConfig, ServingEngine
    return ServingEngine(model, params, ServeConfig(
        batch_size=SERVE_BATCH, max_prompt=SERVE_MAX_PROMPT,
        max_new_tokens=SERVE_NEW_TOKENS, seed=SEED), device=dev)


def submit_all(engine, reqs):
    from repro_torch.serve import AGGRESSIVE_SERVE, PAPER_SERVE
    subs = {}
    for r in reqs:
        for lane in (AGGRESSIVE_SERVE, PAPER_SERVE):
            rid = engine.submit(r["prompt"], temperature=r["temperature"],
                                eos_id=r.get("eos_id"), policy=lane)
            subs[rid] = (r, lane)
    return subs


def first_greedy_token(engine, prompt, dev):
    """The greedy token the engine's prefill gives ``prompt`` (the same on
    both lanes: their weights are both posit16 and the prefill attends over
    the fresh bf16 K/V)."""
    import numpy as np
    import torch
    from repro_torch.serve import AGGRESSIVE_SERVE
    lane = engine._lane(AGGRESSIVE_SERVE)
    logits, _ = lane.model.prefill(
        lane.params, {"tokens": torch.as_tensor(prompt[None].astype(
            np.int64), device=dev),
                      "lengths": torch.tensor([len(prompt)], device=dev)},
        lane.capacity)
    return int(torch.argmax(logits[0, -1, :engine.model.cfg.vocab]))


def run_serve(dev, cfg, counters):
    """The serve main path at ``cfg``'s width: returns the completions,
    the ledger summary, the wall time, the launch counts of the serve run
    and one captured layer-0 KV-attention call (q, K/V bits, lengths)."""
    import gc
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    engine = serve_engine(model, params, dev)
    reqs = serve_requests(cfg)
    reqs[2]["eos_id"] = first_greedy_token(engine, reqs[2]["prompt"], dev)
    torch.cuda.synchronize()
    log(f"  {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"vocab {cfg.padded_vocab}; f32 init + posit16 quantization in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2 ** 30:.1f} GiB allocated")

    captured = {}
    real = attn.posit_kv_attention

    def capture(q, k_bits, v_bits, length, fmt, *a, **kw):
        # layer 0 of the posit8 lane's 6th decode step (lanes alternate)
        n = captured.setdefault("calls", 0)
        captured["calls"] = n + 1
        if n == 10 * cfg.n_layers and "args" not in captured:
            captured["args"] = (q.clone(), k_bits.clone(), v_bits.clone(),
                                length.clone(), fmt)
        return real(q, k_bits, v_bits, length, fmt, *a, **kw)

    subs = submit_all(engine, reqs)
    attn.posit_kv_attention = capture
    try:
        for c in counters:
            c.launches = 0
        t0 = time.perf_counter()
        comps = engine.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters}
    finally:
        attn.posit_kv_attention = real
    summary = engine.ledger.summary()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return (model, params, reqs, subs, comps, summary, wall, launches,
            captured.get("args"), peak)


def check_serve(cfg, subs, comps, summary, launches):
    from repro_torch.serve import AGGRESSIVE_SERVE, PAPER_SERVE
    by_rid = {}
    for c in comps:
        if c.rid in by_rid:
            raise AssertionError(f"request {c.rid} completed twice")
        by_rid[c.rid] = c
    if set(by_rid) != set(subs):
        raise AssertionError(f"completed {sorted(by_rid)}, submitted "
                             f"{sorted(subs)}")
    for rid, c in by_rid.items():
        r, lane = subs[rid]
        eos = r.get("eos_id")
        n = len(c.tokens)
        if c.lane != lane.lane or not 1 <= n <= SERVE_NEW_TOKENS:
            raise AssertionError(f"request {rid}: {n} tokens on {c.lane}")
        if c.finish_reason == "eos":
            ok = eos is not None and c.tokens[-1] == eos
        else:
            ok = n == SERVE_NEW_TOKENS and (eos is None
                                            or eos not in c.tokens)
        if not ok:
            raise AssertionError(f"request {rid} finished "
                                 f"{c.finish_reason} after {n} tokens")
    p8, p16 = summary[AGGRESSIVE_SERVE.lane], summary[PAPER_SERVE.lane]
    for lane, row in ((AGGRESSIVE_SERVE.lane, p8), (PAPER_SERVE.lane, p16)):
        if not row["nj_per_token"] > 0:
            raise AssertionError(f"lane {lane}: nJ/token {row}")
    if p8["decode_tokens"] != p16["decode_tokens"] or \
            2 * p8["kv_read_bytes"] != p16["kv_read_bytes"]:
        raise AssertionError(f"posit8 lane KV bytes {p8['kv_read_bytes']} "
                             f"are not half the posit16 lane's "
                             f"{p16['kv_read_bytes']}")
    for name in ("posit_decode", "posit_encode", "posit_kv_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the serve path")
    steps = p8["decode_steps"] + p16["decode_steps"]
    if launches["posit_kv_attention"] != cfg.n_layers * steps:
        raise AssertionError(f"posit_kv_attention launched "
                             f"{launches['posit_kv_attention']} times for "
                             f"{steps} decode steps of {cfg.n_layers} "
                             f"layers: the fused route was not taken "
                             f"every time")
    return by_rid


def serve_reduced_on_card_and_cpu(dev):
    """The reduced config, run by the port on the card (the kernel route)
    and on the CPU (the plain route) with the same weights: ragged prefill
    and four decode steps fed the CPU's greedy tokens; logits within 2e-2
    and the same greedy tokens wherever the top-2 margin exceeds 4e-2."""
    import numpy as np
    import torch
    from repro_torch.configs import CONFIGS, reduced
    from repro_torch.core.formats import get_format
    from repro_torch.core.policy import AGGRESSIVE_POLICY
    from repro_torch.core.quant import quantize_params
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.models.convert import params_from_jax
    cfg = reduced(CONFIGS[SERVE_ARCH])
    cpu = build_model(cfg, AGGRESSIVE_POLICY, device="cpu")
    raw = tree_map(lambda t: t.numpy(),
                   cpu.init(torch.Generator().manual_seed(SEED)))
    rng = np.random.default_rng(SEED)
    lens = np.array([5, 3, 9, 16], np.int32)
    toks = np.zeros((4, 16), np.int64)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, cfg.vocab, n)
    outs = {}
    for d in ("cpu", dev):
        model = build_model(cfg, AGGRESSIVE_POLICY, device=d)
        params = quantize_params(params_from_jax(raw, d),
                                 get_format("posit16"),
                                 cast_rest=torch.bfloat16)
        logits, caches = model.prefill(
            params, {"tokens": torch.from_numpy(toks).to(d),
                     "lengths": torch.from_numpy(lens).to(d)}, 24)
        steps = [logits[:, -1].float().cpu()]
        for s in range(4):
            fed = outs["cpu"][s] if d != "cpu" else steps[-1]
            nxt = fed[:, :cfg.vocab].argmax(-1)
            logits, caches = model.decode_step(params, nxt[:, None].to(d),
                                               caches)
            steps.append(logits[:, -1].float().cpu())
        outs[d] = steps
    worst, n_equal, n_clear = 0.0, 0, 0
    for s, (a, b) in enumerate(zip(outs[dev], outs["cpu"])):
        if not torch.allclose(a, b, **LOGIT_TOL):
            raise AssertionError(f"reduced {SERVE_ARCH} step {s}: card "
                                 f"logits {max_abs_err(a, b):.3g} from "
                                 f"the CPU's")
        a, b = a[:, :cfg.vocab], b[:, :cfg.vocab]
        same = a.argmax(-1) == b.argmax(-1)
        # a greedy token is held equal where the CPU's top two logits are
        # more than 4e-2 apart, as in tests/test_torch_serve.py: a closer
        # pair may swap under bf16 rounding differences of either device
        top2 = b.topk(2, dim=-1).values
        clear = (top2[:, 0] - top2[:, 1]) > 4e-2
        if not torch.all(same[clear]):
            raise AssertionError(f"reduced {SERVE_ARCH} step {s}: greedy "
                                 f"tokens differ between card and CPU")
        worst = max(worst, max_abs_err(a, b))
        n_equal += int(same.sum())
        n_clear += int(clear.sum())
    log(f"  reduced {SERVE_ARCH} on the card vs the CPU: prefill + 4 decode "
        f"steps, logits within {worst:.3g}; greedy tokens equal in "
        f"{n_equal} of {5 * len(lens)} ({n_clear} with a top-2 margin "
        f"above 4e-2, all equal)")


def profile_serve(dev, model, params, reqs, want, card):
    """A second engine with the same seed and requests: every greedy token
    reproduced, and the device's busy share under ``torch.profiler`` over
    a steady window of engine steps (all slots decoding)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    engine = serve_engine(model, params, dev)
    subs = submit_all(engine, reqs)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    step, wall = 0, 0.0
    while not engine.scheduler.idle:
        if step == PROFILE_STEPS[0]:
            torch.cuda.synchronize()
            prof.start()
            t0 = time.perf_counter()
        engine.step()
        if step == PROFILE_STEPS[1] - 1:
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof.stop()
        step += 1
    got = {c.rid: c.tokens for c in engine.scheduler.pop_completions()}
    n_greedy = 0
    for rid, (r, _) in subs.items():
        if r["temperature"] == 0:
            if not (got[rid].shape == want[rid].tokens.shape
                    and (got[rid] == want[rid].tokens).all()):
                raise AssertionError(f"greedy tokens of request {rid} not "
                                     f"reproduced by a second engine")
            n_greedy += 1
    log(f"  a second engine reproduced the greedy tokens of {n_greedy} "
        f"requests")
    report_busy(prof, wall, f"under the profiler, engine steps "
                f"{PROFILE_STEPS[0]}-{PROFILE_STEPS[1] - 1} (both lanes "
                f"decoding) ({card})", 8)


# ---------------------------------------------------------------------------
# Phase 6: the format study, the quickstart and Arith.fma
# ---------------------------------------------------------------------------

def run_study(dev, counters):
    """The paper's two format studies on the card at the reference suite's
    sizes, with its orderings asserted; returns the launch counts of the
    run and the two result tables."""
    from repro_torch.apps.bayeslope import run_rpeak_detection
    from repro_torch.apps.cough import run_cough_detection
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    f1 = run_rpeak_detection(RPEAK_FORMATS, n_subjects=2,
                             segments_per_subject=5, segment_s=12.0,
                             device=dev)
    t1 = time.perf_counter()
    aucs = run_cough_detection(COUGH_FORMATS, n_windows=160, n_train=320,
                               device=dev)
    t2 = time.perf_counter()
    launches = {c.__name__: c.launches for c in counters}
    log(f"  R-peak study (9 formats, 2 subjects x 5 segments of 12 s) in "
        f"{t1 - t0:.1f} s; cough study (3 formats, 160 windows, forest "
        f"trained on 320) in {t2 - t1:.1f} s")
    log(f"  {'format':10s} {'F1':>7s} {'paper':>7s}   {'AUC':>7s} "
        f"{'paper':>7s}")
    for name in RPEAK_FORMATS:
        auc = aucs.get(name, {}).get("auc")
        log(f"  {name:10s} {f1[name]:7.4f} {PAPER_F1.get(name, '-'):>7s}   "
            f"{'-' if auc is None else f'{auc:.4f}':>7s} "
            f"{PAPER_AUC.get(name, '-'):>7s}")
    checks = [("fp32 F1 > 0.95", f1["fp32"] > 0.95),
              ("posit16 F1 > 0.95", f1["posit16"] > 0.95),
              ("posit10 F1 > 0.9", f1["posit10"] > 0.9),
              ("fp16 F1 < posit10 F1", f1["fp16"] < f1["posit10"]),
              ("fp8e4m3 F1 < 0.1", f1["fp8e4m3"] < 0.1),
              ("fp32 AUC > 0.85", aucs["fp32"]["auc"] > 0.85),
              ("posit16 AUC > fp16 AUC",
               aucs["posit16"]["auc"] > aucs["fp16"]["auc"])]
    for what, ok in checks:
        if not ok:
            raise AssertionError(f"format study: {what} does not hold")
    log(f"  the paper's orderings hold: {'; '.join(w for w, _ in checks)}")
    for name in ("posit_round", "posit_butterfly", "posit_matmul_round"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched in the study")
    log(f"  launches in the study: {launches}")

    # three formats on two segments: the card's F1 equal to the CPU's
    few = ("posit10", "fp16", "fp8e4m3")
    kw = dict(n_subjects=1, segments_per_subject=2, segment_s=12.0)
    card, cpu = (run_rpeak_detection(few, device=d, **kw)
                 for d in (dev, "cpu"))
    if card != cpu:
        raise AssertionError(f"R-peak F1 on the card {card} differs from the "
                             f"CPU's {cpu}")
    log(f"  R-peak F1 on 2 segments, card = CPU: {card}")
    return launches, f1, aucs


def run_quickstart(dev, counters):
    """``repro_torch.quickstart`` on the card: one decode-fused matmul
    launch, and its numbers against the same steps on the CPU."""
    import contextlib
    import io
    from repro_torch import quickstart
    for c in counters:
        c.launches = 0
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        card = quickstart.run(dev)
    launches = {c.__name__: c.launches for c in counters}
    for line in out.getvalue().splitlines():
        log(f"  | {line}")
    if launches["posit_matmul"] != 1:
        raise AssertionError(f"quickstart: {launches['posit_matmul']} "
                             f"posit_matmul launches, expected 1")
    with contextlib.redirect_stdout(io.StringIO()):
        cpu = quickstart.run("cpu")
    for key in ("fig2", "round_err", "kv_ratio"):
        if card[key] != cpu[key]:
            raise AssertionError(f"quickstart {key}: {card[key]} on the card, "
                                 f"{cpu[key]} on the CPU")
    for key in ("posit16", "fp16"):
        if card[key].tobytes() != cpu[key].tobytes():
            raise AssertionError(f"quickstart {key} rounding differs from "
                                 f"the CPU's")
    d = abs(card["matmul_rel_err"] - cpu["matmul_rel_err"])
    if d > 1e-6:
        raise AssertionError(f"quickstart matmul error {d:.3g} from the "
                             f"CPU's")
    log(f"  quickstart on the card: numbers equal to the CPU run (the "
        f"matmul's error within {d:.2g}); launches {launches}")
    return launches


def run_fma(dev, counters):
    """``Arith.fma`` on the card: one multiply-add launch per call, each
    bitwise equal to the CPU's result."""
    import torch
    from repro_torch.core.arith import Arith
    gen = torch.Generator().manual_seed(SEED + 6)
    a, b, c = (torch.randn(MAX_BATCH, 2, 4096, generator=gen) * 300
               for _ in range(3))
    names = ("posit8", "posit10", "posit16")
    for cnt in counters:
        cnt.launches = 0
    outs = [Arith.make(n).fma(a.to(dev), b.to(dev), c.to(dev))
            for n in names]
    launches = {cnt.__name__: cnt.launches for cnt in counters}
    if launches["posit_fma_round"] != len(names):
        raise AssertionError(f"Arith.fma: {launches['posit_fma_round']} "
                             f"launches for {len(names)} calls")
    for n, k in zip(names, outs):
        if not bits_equal(k.cpu(), Arith.make(n).fma(a, b, c)):
            raise AssertionError(f"Arith.fma {n} on the card differs from "
                                 f"the CPU's bits")
    log(f"  Arith.fma on (32, 2, 4096) f32 in {', '.join(names)}: bitwise "
        f"equal to the CPU; launches {launches}")
    return launches


# ---------------------------------------------------------------------------
# Phase 4: times
# ---------------------------------------------------------------------------

def time_kernels(dev, shapes, report):
    import torch
    from repro_torch.apps.cough import FFT_N
    from repro_torch.apps.dsp import get_fft_plan
    from repro_torch.core.formats import get_format
    from repro_torch.kernels.posit_matmul import (posit_matmul_round,
                                                  posit_matmul_round_torch)
    from repro_torch.kernels.posit_round import (posit_butterfly,
                                                 posit_butterfly_torch,
                                                 posit_round,
                                                 posit_round_torch)
    fmt = get_format("posit16")
    gen = torch.Generator().manual_seed(SEED + 1)

    # round: the ingest rounding of one cough batch, (32, 2, 4096) f32
    x = (torch.randn(MAX_BATCH, 2, FFT_N, generator=gen) * 2.0 ** 17).to(dev)
    nbytes = 2 * x.numel() * 4
    report["posit_round"].update(
        ms=cuda_ms(lambda: posit_round(x, fmt)),
        device_ms=device_ms(lambda: posit_round(x, fmt),
                            "posit_round_kernel"),
        plain_ms=cuda_ms(lambda: posit_round_torch(x, fmt)),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None, shape=list(x.shape))

    # butterfly: one transposed Stockham stage plane of that batch
    plan = get_fft_plan(FFT_N, fmt.name, torch.float32, str(dev))
    shape = (MAX_BATCH, 2, 4, 512)
    planes = [posit_round_torch(torch.randn(shape, generator=gen).to(dev)
                                * 2.0 ** 20, fmt) for _ in range(4)]
    ws = tuple(w.reshape(1, 1, -1, 1) for w in plan.stages[2])
    n = planes[0].numel()
    nbytes = 8 * n * 4 + 2 * ws[0].numel() * 4
    report["posit_butterfly"].update(
        ms=cuda_ms(lambda: posit_butterfly(*planes, *ws, fmt)),
        device_ms=device_ms(lambda: posit_butterfly(*planes, *ws, fmt),
                            "posit_butterfly_kernel"),
        plain_ms=cuda_ms(lambda: posit_butterfly_torch(*planes, *ws, fmt)),
        bound_ms=max(nbytes / HBM_BYTES_PER_S,
                     10 * n / F32_FLOPS_PER_S) * 1e3,
        bound_by="bytes", library_ms=None, shape=list(shape))

    # matmul: the mel filterbank product of that batch
    a, b = shapes["mel"]
    (M, K), N = a.shape, b.shape[1]
    nbytes = 4 * (M * K + K * N + M * N)
    flops = 2 * M * K * N
    by_bytes = nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S
    report["posit_matmul_round"].update(
        ms=cuda_ms(lambda: posit_matmul_round(a, b, fmt)),
        device_ms=device_ms(lambda: posit_matmul_round(a, b, fmt),
                            "posit_matmul_round_kernel"),
        plain_ms=cuda_ms(lambda: posit_matmul_round_torch(a, b, fmt)),
        bound_ms=max(nbytes / HBM_BYTES_PER_S,
                     flops / F32_FLOPS_PER_S) * 1e3,
        bound_by="bytes" if by_bytes else "operations",
        library_ms=cuda_ms(lambda: posit_round_torch(torch.matmul(a, b),
                                                     fmt)),
        shape=[M, K, N])


def time_format_kernels(dev, report):
    """The multiply-add at the round kernel's main-path shape (32, 2, 4096)
    f32, all three operands full size; the decode-fused matmul at the FFN
    width in posit16, beside ``torch.matmul`` on the bf16 operands already
    decoded (the decode not counted)."""
    import torch
    from repro_torch.core.formats import get_format
    from repro_torch.kernels.posit_codec import posit_decode
    from repro_torch.kernels.posit_matmul import (posit_matmul,
                                                  posit_matmul_torch)
    from repro_torch.kernels.posit_round import (posit_fma_round,
                                                 posit_fma_round_torch)
    fmt = get_format("posit16")
    gen = torch.Generator().manual_seed(SEED + 5)
    a, b, c = ((torch.randn(MAX_BATCH, 2, 4096, generator=gen) * 300).to(dev)
               for _ in range(3))
    n = a.numel()
    report["posit_fma_round"].update(
        ms=cuda_ms(lambda: posit_fma_round(a, b, c, fmt)),
        device_ms=device_ms(lambda: posit_fma_round(a, b, c, fmt),
                            "posit_fma_round_kernel"),
        plain_ms=cuda_ms(lambda: posit_fma_round_torch(a, b, c, fmt)),
        bound_ms=4 * n * 4 / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None, shape=list(a.shape))

    M, K, N = FFN_SHAPE
    ab, bb = matmul_case(gen, M, K, N, fmt, dev)
    nbytes = (ab.numel() + bb.numel()) * ab.element_size() + M * N * 4
    flops = 2 * M * K * N
    by_bytes = nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS_PER_S
    a16, b16 = posit_decode(ab, fmt, torch.bfloat16), posit_decode(
        bb, fmt, torch.bfloat16)
    report["posit_matmul"].update(
        ms=cuda_ms(lambda: posit_matmul(ab, bb, fmt)),
        device_ms=device_ms(lambda: posit_matmul(ab, bb, fmt),
                            "posit_matmul_decode_kernel"),
        plain_ms=cuda_ms(lambda: posit_matmul_torch(ab, bb, fmt), reps=2,
                         samples=5),
        bound_ms=max(nbytes / HBM_BYTES_PER_S,
                     flops / BF16_FLOPS_PER_S) * 1e3,
        bound_by="bytes" if by_bytes else "operations",
        library_ms=cuda_ms(lambda: torch.matmul(a16, b16)),
        shape=[M, K, N, "posit16"])


def time_serve_kernels(dev, report):
    """The serve kernels at serve-path shapes: decode and encode of one
    (4096, 12288) FFN weight, the (4, 1, 8, 128) KV write, and the
    KV-attention at the lanes' cache (S = 96) and at S = 32768.  The
    KV-attention's library time is ``scaled_dot_product_attention`` on K/V
    already decoded to f32 (the decode not counted).  Returns the rows
    that are logged beside the JSON line's."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.formats import get_format
    from repro_torch.kernels.posit_codec import (posit_decode,
                                                 posit_decode_torch,
                                                 posit_encode,
                                                 posit_encode_torch)
    from repro_torch.kernels.posit_kv_attention import (
        posit_kv_attention, posit_kv_attention_torch)
    p16 = get_format("posit16")
    gen = torch.Generator().manual_seed(SEED + 3)
    rows = []

    w = (torch.randn(4096, 12288, generator=gen) / 64).to(dev)
    bits = posit_encode(w, p16)
    n = w.numel()
    report["posit_decode"].update(
        ms=cuda_ms(lambda: posit_decode(bits, p16, torch.bfloat16)),
        device_ms=device_ms(lambda: posit_decode(bits, p16, torch.bfloat16),
                            "posit_decode_kernel"),
        plain_ms=cuda_ms(lambda: posit_decode_torch(bits, p16,
                                                    torch.bfloat16),
                         reps=2, samples=5),
        bound_ms=n * (2 + 2) / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None, shape=[4096, 12288, "int16->bf16"])
    report["posit_encode"].update(
        ms=cuda_ms(lambda: posit_encode(w, p16)),
        device_ms=device_ms(lambda: posit_encode(w, p16),
                            "posit_encode_kernel"),
        plain_ms=cuda_ms(lambda: posit_encode_torch(w, p16), reps=2,
                         samples=5),
        bound_ms=n * (4 + 2) / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None, shape=[4096, 12288, "f32->int16"])
    kv = torch.randn(4, 1, 8, 128, generator=gen).to(dev)
    p8 = get_format("posit8")
    rows.append(dict(
        name="posit_encode", shape=[4, 1, 8, 128, "f32->int8"],
        ms=cuda_ms(lambda: posit_encode(kv, p8)),
        device_ms=device_ms(lambda: posit_encode(kv, p8),
                            "posit_encode_kernel"),
        plain_ms=cuda_ms(lambda: posit_encode_torch(kv, p8)),
        bound_ms=kv.numel() * 5 / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None))

    for name, S in (("posit8", 96), ("posit16", 96), ("posit8", 32768),
                    ("posit16", 32768)):
        fmt = get_format(name)
        q, kb, vb = kv_case(gen, 4, S, 8, 4, 128, fmt, dev)
        B, KV, G, D = q.shape
        lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
        nbytes = (2 * q.numel() * 4 + 2 * kb.numel() * kb.element_size()
                  + lengths.numel() * 4)
        flops = 4 * B * KV * G * S * D
        kf = posit_decode(kb, fmt).transpose(1, 2)      # (B, KV, S, D)
        vf = posit_decode(vb, fmt).transpose(1, 2)
        mask = (torch.arange(S, device=dev)[None, :]
                < lengths[:, None])[:, None, None, :]
        slow = dict(reps=2, samples=5) if S > 1024 else {}
        row = dict(
            name="posit_kv_attention", shape=[B, S, KV, D, name],
            ms=cuda_ms(lambda: posit_kv_attention(q, kb, vb, lengths, fmt)),
            device_ms=device_ms(
                lambda: posit_kv_attention(q, kb, vb, lengths, fmt),
                "posit_kv_attention_kernel"),
            plain_ms=cuda_ms(lambda: posit_kv_attention_torch(
                q, kb, vb, lengths, fmt), **slow),
            bound_ms=max(nbytes / HBM_BYTES_PER_S,
                         flops / F32_FLOPS_PER_S) * 1e3,
            bound_by=("bytes" if nbytes / HBM_BYTES_PER_S
                      >= flops / F32_FLOPS_PER_S else "operations"),
            library_ms=cuda_ms(lambda: F.scaled_dot_product_attention(
                q, kf, vf, attn_mask=mask)))
        if (name, S) == ("posit8", 96):     # the posit8 lane's cache
            report["posit_kv_attention"].update(row)
        else:
            rows.append(row)
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: src/repro_torch not found beside {ROOT}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # f32 accumulation in the bf16 products, as the reference's
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from repro_torch.apps.cough import train_reference_forest
    from repro_torch.kernels import build
    from repro_torch.kernels.posit_codec import posit_decode, posit_encode
    from repro_torch.kernels.posit_kv_attention import (
        posit_kv_attention, posit_kv_attention_torch)
    from repro_torch.kernels.posit_matmul import (posit_matmul,
                                                  posit_matmul_round)
    from repro_torch.kernels.posit_round import (posit_butterfly,
                                                 posit_fma_round, posit_round)

    dev = torch.device("cuda")
    card = card_line()
    t_start = time.perf_counter()

    def phase(msg):
        log(f"{msg} (at {time.perf_counter() - t_start:.1f} s)")

    phase(f"phase 1: card {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    libs = build.build()
    log(f"  built {', '.join(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.1f} s")

    src = "src/repro_torch/kernels"
    report = {
        "posit_round": dict(
            name="posit_round", route="cuda",
            source=f"{src}/csrc/posit_round.cu",
            replaces="src/repro/kernels/posit_round.py:63"),
        "posit_butterfly": dict(
            name="posit_butterfly", route="cuda",
            source=f"{src}/csrc/posit_round.cu",
            replaces="src/repro/kernels/posit_round.py:101"),
        "posit_matmul_round": dict(
            name="posit_matmul_round", route="cuda",
            source=f"{src}/csrc/posit_matmul.cu",
            replaces="src/repro/kernels/posit_matmul.py:92"),
        "posit_decode": dict(
            name="posit_decode", route="cuda",
            source=f"{src}/csrc/posit_codec.cu",
            replaces="src/repro/kernels/posit_decode.py:30"),
        "posit_encode": dict(
            name="posit_encode", route="cuda",
            source=f"{src}/csrc/posit_codec.cu",
            replaces="src/repro/kernels/posit_encode.py:25"),
        "posit_kv_attention": dict(
            name="posit_kv_attention", route="cuda",
            source=f"{src}/csrc/posit_kv_attention.cu",
            replaces="src/repro/kernels/posit_kv_attention.py:81"),
        "posit_fma_round": dict(
            name="posit_fma_round", route="cuda",
            source=f"{src}/csrc/posit_round.cu",
            replaces="src/repro/kernels/posit_round.py:81"),
        "posit_matmul": dict(
            name="posit_matmul", route="cuda",
            source=f"{src}/csrc/posit_matmul.cu",
            replaces="src/repro/kernels/posit_matmul.py:57"),
    }
    counters = (posit_round, posit_butterfly, posit_matmul_round,
                posit_decode, posit_encode, posit_kv_attention,
                posit_fma_round, posit_matmul)
    stream_kernels = ("posit_round", "posit_butterfly", "posit_matmul_round")
    phase("phase 2: kernels against their plain versions")
    shapes = check_kernels(dev, report)
    check_serve_kernels(dev, report)
    check_format_kernels(dev, report)

    phase("phase 3: stream path, 64-patient fleet")
    t0 = time.perf_counter()
    forest = train_reference_forest(96, 123, n_trees=10, depth=5, device=dev)
    log(f"  forest trained in {time.perf_counter() - t0:.1f} s")
    engine, records, pins, wall, launches = run_main_path(dev, forest,
                                                          counters)
    check_main_path(engine, records, pins, forest, wall,
                    {k: launches[k] for k in stream_kernels})
    for name in stream_kernels:
        report[name]["launches"] = launches[name]
    del engine
    profile_main_path(dev, forest, counters)

    phase("phase 4: times (median ms per call, CUDA events)")
    time_kernels(dev, shapes, report)
    time_format_kernels(dev, report)
    extra = time_serve_kernels(dev, report)
    for r in [*report.values(), *extra]:
        lib = ("-" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        log(f"  {r['name']} {r['shape']}: {r['ms']:.4f} ms per call "
            f"({r['device_ms']:.4f} ms of it on the device), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
            f"{r['plain_ms']:.4f} ms, library {lib}")
    torch.cuda.empty_cache()

    phase(f"phase 5: serve path, {SERVE_ARCH} at full width, "
          f"{2 * SERVE_PROMPTS} requests on two lanes")
    from repro_torch.configs import CONFIGS
    cfg = CONFIGS[SERVE_ARCH]
    (model, params, reqs, subs, comps, summary, wall, launches, captured,
     peak) = run_serve(dev, cfg, counters)
    by_rid = check_serve(cfg, subs, comps, summary, launches)
    for name in ("posit_decode", "posit_encode", "posit_kv_attention"):
        report[name]["launches"] = launches[name]
    log(f"  {len(comps)} requests completed once each in {wall:.3f} s "
        f"(host clock), peak {peak:.1f} GiB allocated; launches on the "
        f"serve path: {launches}")
    for lane, row in summary.items():
        tok_s = 1e6 / row["us_per_token"] if row["us_per_token"] else 0.0
        step_ms = (row["decode_tokens"] * row["us_per_token"] * 1e-3
                   / row["decode_steps"] if row["decode_steps"] else 0.0)
        prefill_ms = (row["prefill_tokens"] * row["prefill_us_per_token"]
                      * 1e-3 / row["requests"] if row["requests"] else 0.0)
        log(f"  ledger {lane}: {row['requests']} requests, "
            f"{row['decode_tokens']} decode tokens in "
            f"{row['decode_steps']} steps, {tok_s:.1f} tokens/s, "
            f"{step_ms:.2f} ms per decode step, {prefill_ms:.2f} ms per "
            f"prefill, {row['nj_per_token']:.1f} nJ/token, KV read "
            f"{row['kv_read_bytes']:.0f} B ({card})")
    q, kb, vb, lengths, fmt = captured
    k = posit_kv_attention(q, kb, vb, lengths, fmt)
    p = posit_kv_attention_torch(q, kb, vb, lengths, fmt)
    torch.cuda.synchronize()
    if not torch.allclose(k, p, **KV_TOL):
        raise AssertionError(f"posit_kv_attention on the live layer-0 cache:"
                             f" {max_abs_err(k, p):.3g} from its plain "
                             f"version")
    log(f"  posit_kv_attention on the live layer-0 cache "
        f"{tuple(kb.shape)} {fmt.name}, lengths {lengths.tolist()}: within "
        f"2e-5 of its plain version (max abs err {max_abs_err(k, p):.3g})")
    profile_serve(dev, model, params, reqs, by_rid, card)
    del model, params
    torch.cuda.empty_cache()
    serve_reduced_on_card_and_cpu(dev)

    phase("phase 6: the format study, the quickstart and Arith.fma")
    t0 = time.perf_counter()
    run_study(dev, counters)
    report["posit_matmul"]["launches"] = run_quickstart(
        dev, counters)["posit_matmul"]
    report["posit_fma_round"]["launches"] = run_fma(
        dev, counters)["posit_fma_round"]
    log(f"  phase 6 in {time.perf_counter() - t0:.1f} s ({card})")
    phase("done")

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in report.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
