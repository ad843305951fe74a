#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each fatal on failure:
  1. the card's name and power limit, then the build of the CUDA kernels
     (one nvcc per source, in parallel) and its time, the registers and
     spills ``nvcc -Xptxas -v`` reports for the codec, the round, the
     decode-fused matmul and the KV-attention, and the HGMMA (``wgmma``)
     instructions in the matmul's SASS;
  2. each kernel against its plain torch version on the card: the round,
     the butterfly, the codec's decode, encode and KV append bitwise (the
     append in its three modes, positions it does not write untouched),
     the rounded matmul within one format ulp and the same bits on a
     second call (the main path's four shapes, ragged ones, f64), the
     posit-KV attention within rtol = atol = 2e-5; the round and the
     decode also on views at every element offset within 16 bytes and
     ragged lengths (every decode container, both output types), the
     decode tables built on the card against their plain version, the
     KV-attention at 48 query rows per KV head; the FFT stage-range
     kernel bitwise at the cough rfft's middle stages (batch 32), whole
     FFTs of 4096 and 256 points in posit10 and posit8 (two passes, odd
     batches) and in f64, and equal to the earlier route it replaced; the
     multiply-add at every element offset within 16 bytes and under row,
     column and host 0-d broadcasts, in f32 and f64;
  3. the stream path: a 64-patient fleet (32 cough patients at posit16
     with every fourth pinned to fp16, 32 ECG patients at posit10 with
     every fourth pinned to posit8)
     streamed in ragged chunks through ``StreamEngine``, with every window
     scored exactly once, every stream kernel's launch count above zero
     (the round's equal to the reference design's 8221, the rounded
     matmul's to its 12 calls, the FFT stage range's to 3, one per posit16
     cough batch, and no butterfly launch),
     and the outputs checked against the same windows run by the port on
     the CPU; then the same fleet once more under ``torch.profiler`` for
     the device's busy share, its device kernels and its top kernels, and
     four times more in turns with its FFT stages through the stage-range
     kernel and through the earlier route (windows/s of each);
  4. each kernel's median time per call (CUDA events) and its device time
     per call (profiler: every kernel the call launches, a combine kernel
     included) beside its bound, its plain version's time and, where one
     exists, one library call's; the KV-attention also at S = 32768 (its
     split path), the decode-fused matmul also beside the unfused route
     (the codec's decode of both operands, then ``torch.matmul``), the
     decode at every serve weight shape, the round at the fleet's two
     shapes beside an empty kernel's bare launch, with the host time of
     each step of its wrapper; the rounded matmul at its four main-path
     shapes beside an empty kernel's device time; the KV append at the
     serve shape (posit8 and posit16) beside the earlier route it replaced
     (``earlier_kv_append``: casts, two encode launches and the eager
     scatter), each with its device kernels per call; the FFT stage range
     at the cough shape beside the earlier route it replaced
     (``earlier_fft_stages``: nine butterfly launches with their copies
     and joins), each with its device kernels per call, and its stage
     loop's instructions counted in its SASS beside the issue and ALU-pipe
     floors that count gives; the multiply-add
     with three full operands, a row broadcast and a host 0-d operand;
  5. the serve path: qwen3-8b at full width (36 layers, random weights from
     a seeded generator on the card) behind ``ServingEngine`` with two
     lanes (posit16 weights; posit8 and posit16 KV), 12 requests, every
     request completed once, the codec and KV-attention kernels launched
     (36 KV-attention launches per decode step, one KV append per layer
     and decode step or prefill, no encode launch while serving: the
     weights are encoded at load), greedy tokens reproduced by a second
     engine with eight of its steps under ``torch.profiler`` (the device's
     busy share and kernels per lane-step, the weight decode's device time
     per lane-step beside its byte bound), the serve run four times more
     in turns with the KV write through the append kernel and through the
     earlier route (ms per decode step of each), the KV-attention kernel
     held against its plain version on the live cache, and the reduced
     config's logits on the card against the same weights on the CPU;
  6. the format study: R-peak F1 over nine formats and cough AUC over
     three on the card, the paper's orderings asserted, three formats'
     F1 card against CPU; the quickstart (one decode-fused matmul launch);
     ``Arith.fma`` (one multiply-add launch per call).

Phase 2 also holds the multiply-add bitwise and the decode-fused matmul
within 1e-5 of its largest output against their plain versions (at the
quickstart's shape, the FFN width in posit16 and posit8, a ragged shape
and an int32 container), the IEEE rounding on the card bitwise against the
CPU's, and quire-mode dot and matmul on the card against the exact oracle;
the KV-attention is held at S = 96 (one split) and S = 32768 (many).
Phase 3's fleet pins every fourth cough patient to fp16.  Each phase
prints its wall time.

Four lines end the output: a JSON object with the kernels' rows at other
shapes than the main path's (``kernels_at_other_shapes``), the card's
name and power limit, a JSON object with one entry per kernel, and
``{"ok": true, "device": {...}}``.  Without CUDA, or without
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
FLEET_ROUND_LAUNCHES = 8221    # the 64-patient fleet's posit_round launches
FLEET_MATMUL_ROUND_CALLS = 12  # ... and its posit_matmul_round calls
FLEET_FFT_STAGE_LAUNCHES = 3   # ... and its posit_fft_stages launches (one
                               # per posit16 cough batch of 32 windows)
# an H100 SXM's warp-instruction issue rate (4 schedulers an SM, one warp
# instruction a clock each, at the 1.98 GHz boost clock) and the rate of its
# integer ALU pipe (16 INT32 lanes a scheduler: a warp instruction every
# other clock), for the floors of the FFT stage range's SASS count
SM_CLOCK_HZ = 1.98e9
WARP_ISSUE_PER_SM_CLOCK = 4
WARP_ALU_PER_SM_CLOCK = 2
# the opcodes the SASS count files under the integer ALU pipe (IMAD, which
# issues to the FMA pipe, is not among them)
ALU_OPCODES = ("IADD3", "LOP3", "SHF", "LEA", "ISETP", "SEL", "IMNMX",
               "VIMNMX", "FLO", "POPC", "PRMT", "BMSK", "SGXT", "IABS",
               "BREV", "PLOP3", "P2R", "R2P", "LOP")
PROFILE_TRIES = 3              # profiles taken before a device time is NaN
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


def device_ms(fn, kernels, reps: int = 50) -> float:
    """Mean device time per call of ``fn``: the device time of every kernel
    whose name contains one of ``kernels`` (a name or a tuple of names: a
    combine or reduction kernel the call launches is counted), from
    ``torch.profiler`` over ``reps`` calls (no host time), divided by the
    number of calls.  A profile that recorded none of them (the profiler
    drops a window's events now and then) is taken again, up to
    ``PROFILE_TRIES`` profiles; NaN if none recorded any."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    names = (kernels,) if isinstance(kernels, str) else tuple(kernels)
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if any(k in e.key for k in names)]
        us = sum(getattr(e, "self_device_time_total", 0) for e in hits)
        if us:
            return us / reps / 1e3
    return float("nan")


def device_kernels(fn, reps: int = 50):
    """(device ms per call, device kernels per call) of ``fn``: every
    kernel, copy and fill that ``torch.profiler`` records on the card, in
    a profile of 2 ``reps`` calls less one of ``reps`` calls, over
    ``reps`` (the profiler may miss the first few events of a window; the
    difference cancels that); NaN if it recorded none."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def totals(calls):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count > 0]
        return (sum(e.self_device_time_total for e in rows),
                sum(e.count for e in rows))
    fn()
    torch.cuda.synchronize()
    us1, n1 = totals(reps)
    us2, n2 = totals(2 * reps)
    if not n1 or not n2:
        return float("nan"), float("nan")
    return (us2 - us1) / reps / 1e3, (n2 - n1) / reps


def ptxas_report(log_text: str):
    """(entry, registers, spill stores, spill loads, stack) of every kernel
    in ``nvcc -Xptxas -v`` output."""
    import re
    rows, entry, spills = [], None, (0, 0, 0)
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            spills = tuple(int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            rows.append((entry, int(m.group(1)), spills[1], spills[2],
                         spills[0]))
            entry = None
    return rows


def sass_listing(lib):
    """{kernel: [(address, instruction), ...]} of the shared library
    ``lib``'s SASS (``cuobjdump -sass``), each instruction without its
    predicate guard."""
    import re
    from repro_torch.kernels import build
    tool = Path(build._nvcc()).with_name("cuobjdump")
    out = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    fns, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = fns.setdefault(line.split("Function :")[1].strip(), [])
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([^;]*);",
                     line)
        if m and fn is not None:
            fn.append((int(m.group(1), 16), m.group(2).strip()))
    return fns


def sass_count(lib, opcode: str):
    """{kernel: count} of SASS instructions whose opcode starts with
    ``opcode`` in the shared library ``lib``."""
    return {fn: n for fn, ins in sass_listing(lib).items()
            if (n := sum(i.startswith(opcode) for _, i in ins))}


def stage_loop_sass(lib):
    """The f32 stage-range kernel's stage loop read off its SASS: (the
    instructions of one stage's loop body, those of its butterfly loop's
    body, and the ALU-pipe ones (``ALU_OPCODES``) among each).  The
    stage loop is the one whose backward branch follows the kernel's last
    barrier (the one ending a stage), the butterfly loop the one whose
    backward branch lies between that barrier and the first (the load's);
    the kernel keeps both loops rolled, so each body is one copy.  A thread
    that takes one butterfly a stage issues the stage body once a stage,
    less the few instructions a zero or NaN value skips."""
    import re
    ins = next(v for k, v in sass_listing(lib).items()
               if "posit_fft_stages_kernelIf" in k)
    at = {addr: i for i, (addr, _) in enumerate(ins)}
    bars = [i for i, (_, x) in enumerate(ins) if x.startswith("BAR")]

    def back(lo, hi):                   # first backward branch in (lo, hi)
        for i in range(lo + 1, hi):
            m = re.match(r"BRA(?:\.\S+)?\s+(?:!?U?P\w+,\s*)?0x([0-9a-f]+)",
                         ins[i][1])
            if m and int(m.group(1), 16) <= ins[i][0]:
                return at[int(m.group(1), 16)], i
        raise AssertionError("posit_fft_stages_kernel<float>: no loop found "
                             "around its barriers in the SASS")
    s0, s1 = back(bars[-1], len(ins))
    b0, b1 = back(bars[0], bars[-1])
    ops = [x.split()[0].split(".")[0] for _, x in ins]
    return (s1 - s0 + 1, b1 - b0 + 1,
            sum(op in ALU_OPCODES for op in ops[s0:s1 + 1]),
            sum(op in ALU_OPCODES for op in ops[b0:b1 + 1]))


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
                                                  posit_matmul_round_torch,
                                                  round_matmul_plan)
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
    # the 16-byte accesses' head and tail: views at every element offset
    # within 16 bytes, ragged lengths, a 0-d tensor
    fmt = get_format("posit10")
    for x in (cases[2][1], cases[-1][1]):
        per = 16 // x.element_size()
        views = [x[off:off + n] for off in range(per)
                 for n in (1, per + 1, 4099, 100003)] + [x[5]]
        for v in views:
            k, p = posit_round(v, fmt), posit_round_torch(v, fmt)
            torch.cuda.synchronize()
            if not bits_equal(k, p):
                raise AssertionError(f"posit_round {x.dtype} view at offset "
                                     f"{v.storage_offset()} of "
                                     f"{v.numel()}: not bitwise equal")
        log(f"  posit_round {str(x.dtype)[6:]}: {len(views)} views at element"
            f" offsets 0-{per - 1}, ragged lengths and 0-d: bitwise")
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
    # ragged M and N, K split or not, and the mel product in f64
    cases = list(shapes.items()) + [
        ("ragged", (psd[:37], mel[:, :19].contiguous())),
        ("ragged", (posit_round_torch(torch.rand(3, 700, generator=gen)
                                      .to(dev) * 1e3, fmt),
                    posit_round_torch(torch.randn(700, 5, generator=gen)
                                      .to(dev), fmt))),
        ("mel f64", (psd.double(), mel.double()))]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err = 0.0
    for name, (a, b) in cases:
        k = posit_matmul_round(a, b, fmt)
        again = posit_matmul_round(a, b, fmt)
        p = posit_matmul_round_torch(a, b, fmt)
        torch.cuda.synchronize()
        dist = ulp_distance(k, p, fmt)
        if int(dist.max()) > 1:
            raise AssertionError(f"posit_matmul_round {name}: "
                                 f"{int(dist.max())} ulp from the plain "
                                 f"version")
        if not bits_equal(k, again):
            raise AssertionError(f"posit_matmul_round {name}: two calls "
                                 f"gave different bits")
        share = float((dist != 0).float().mean())
        err = max(err, max_abs_err(k, p))
        (M, K), N = a.shape, b.shape[1]
        log(f"  posit_matmul_round {name} {str(a.dtype)[6:]} ({M}, {K})x"
            f"({K}, {N}), plan (tm, tn, splits, k per split) "
            f"{round_matmul_plan(M, K, N, sms)}: within 1 ulp, {share:.4f} "
            f"of outputs not bitwise equal, the same bits on a second call")
    report["posit_matmul_round"]["max_abs_err"] = err
    return shapes


def earlier_fft_stages(z, twiddles, s0, s1, fmt):
    """The FFT's stages ``s0 .. s1-1`` as they ran before the stage-range
    kernel (``posit_fft_stages``'s arguments and results): one
    ``posit_butterfly`` launch a stage, the four half-planes copied
    contiguous before it and u and v joined by two ``torch.cat`` and a
    ``torch.stack`` after it.  Timed beside ``posit_fft_stages``, in one
    run, on one card."""
    import torch
    from repro_torch.kernels.posit_fft import MIN_RUN, stage_twiddles
    from repro_torch.kernels.posit_round import posit_butterfly
    nb, tr, n = z.dim() - 3, True, twiddles.shape[-1] + 1
    for s in range(s0, s1):
        R = n >> s
        if tr and R // 2 < MIN_RUN:
            z = z.transpose(-1, -2)
            tr = False
        if tr:
            e, o = z[..., : R // 2], z[..., R // 2:]
        else:
            e, o = z[..., : R // 2, :], z[..., R // 2:, :]
        ax = -2 if tr else -1
        shp = (*([1] * nb), -1, 1) if tr else (*([1] * nb), 1, -1)
        wr, wi = stage_twiddles(twiddles, s)
        u_re, u_im, v_re, v_im = posit_butterfly(
            e[0].contiguous(), e[1].contiguous(), o[0].contiguous(),
            o[1].contiguous(), wr.reshape(shp), wi.reshape(shp), fmt)
        z = torch.stack([torch.cat([u_re, v_re], dim=ax),
                         torch.cat([u_im, v_im], dim=ax)])
    return z, tr


def fft_state(gen, fmt, n, s0, batch, dtype, dev):
    """A stacked FFT state entering stage ``s0`` (transposed), posit
    values of ``fmt``."""
    import torch
    from repro_torch.kernels.posit_round import posit_round_torch
    L, R = 1 << s0, n >> s0
    return posit_round_torch(torch.randn(2, *batch, L, R, generator=gen,
                                         dtype=dtype) * 2.0 ** 10,
                             fmt).to(dev)


def check_fft_stages(dev, report):
    """``posit_fft_stages`` bitwise against its plain version: the cough
    rfft's middle stages at batch 32, whole FFTs of 4096 and 256 points in
    posit10 and posit8 (two passes; odd batches), one f64 case; and the
    earlier route bitwise equal to it at the cough shape."""
    import torch
    from repro_torch.apps.cough import FFT_N
    from repro_torch.apps.dsp import get_fft_plan
    from repro_torch.core.formats import get_format
    from repro_torch.kernels.posit_fft import (fft_pass_plan,
                                               posit_fft_stages,
                                               posit_fft_stages_torch)
    gen = torch.Generator().manual_seed(SEED + 8)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    f32, f64 = torch.float32, torch.float64
    levels = FFT_N.bit_length() - 1
    cases = [("posit16", FFT_N, 2, levels - 1, (MAX_BATCH, 2), f32),
             ("posit10", FFT_N, 0, levels, (3,), f32),
             ("posit8", FFT_N, 0, levels, (2, 2), f32),
             ("posit10", 256, 0, 8, (MAX_BATCH, 2), f32),
             ("posit8", 256, 0, 8, (3,), f32),
             ("posit16", FFT_N, 2, levels - 1, (5,), f64)]
    err, multi_odd = 0.0, False
    for name, n, s0, s1, batch, dtype in cases:
        fmt = get_format(name)
        plan = get_fft_plan(n, name, dtype, str(dev))
        z = fft_state(gen, fmt, n, s0, batch, dtype, dev)
        k, tr_k = posit_fft_stages(z, plan.table, s0, s1, fmt)
        p, tr_p = posit_fft_stages_torch(z, plan.table, s0, s1, fmt)
        torch.cuda.synchronize()
        if tr_k != tr_p or not bits_equal(k, p):
            raise AssertionError(f"posit_fft_stages {name} n={n} stages "
                                 f"{s0}..{s1 - 1} batch {batch}: not "
                                 f"bitwise equal to its plain version")
        err = max(err, max_abs_err(k, p))
        nfft = z[0].numel() // n
        passes = fft_pass_plan(n, s0, s1, nfft, dtype, sms)
        multi_odd |= len(passes) > 1 and nfft % 2 == 1
        log(f"  posit_fft_stages {name} {str(dtype)[6:]} n={n} stages "
            f"{s0}..{s1 - 1} batch {batch}, passes (first stage, end, group, "
            f"groups a block, threads, shared bytes, blocks) "
            f"{[tuple(q) for q in passes]}: bitwise")
    if not multi_odd:
        raise AssertionError("posit_fft_stages: no case with two passes "
                             "and an odd batch")
    fmt = get_format("posit16")
    plan = get_fft_plan(FFT_N, fmt.name, f32, str(dev))
    z = fft_state(gen, fmt, FFT_N, 2, (MAX_BATCH, 2), f32, dev)
    k, _ = posit_fft_stages(z, plan.table, 2, levels - 1, fmt)
    e, _ = earlier_fft_stages(z, plan.table, 2, levels - 1, fmt)
    torch.cuda.synchronize()
    if not bits_equal(k, e.contiguous()):
        raise AssertionError("posit_fft_stages: not bitwise equal to the "
                             "earlier nine-launch route")
    log(f"  posit_fft_stages at the cough shape {tuple(z.shape)}: bitwise "
        f"equal to the earlier route (one posit_butterfly launch a stage)")
    report["posit_fft_stages"]["max_abs_err"] = err


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
    from repro_torch.kernels.posit_codec import (decode_table, posit_decode,
                                                 posit_decode_table_torch,
                                                 posit_decode_torch,
                                                 posit_encode,
                                                 posit_encode_torch)
    from repro_torch.kernels.posit_kv_attention import (
        kv_split_plan, posit_kv_attention, posit_kv_attention_torch,
        query_groups)
    gen = torch.Generator().manual_seed(SEED + 2)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

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
    for name in ("posit8", "posit10", "posit12", "posit16", "posit16e3"):
        for out_dtype in (torch.float32, torch.bfloat16):
            fmt = get_format(name)
            idt = torch.int32 if out_dtype == torch.float32 else torch.int16
            if not torch.equal(
                    decode_table(fmt, out_dtype, dev).cpu().view(idt),
                    posit_decode_table_torch(fmt, out_dtype).view(idt)):
                raise AssertionError(f"posit_decode table {name} "
                                     f"{out_dtype}: the card's differs from "
                                     f"its plain version")
    log("  posit_decode tables built on the card (posit8/10/12/16/16e3, f32 "
        "and bf16): bitwise equal to their plain version")
    # the 16-byte accesses' head and tail: every container, both outputs,
    # views at every element offset within 16 bytes, ragged lengths
    n_views = 0
    for name, container in (("posit8", torch.int8), ("posit16", torch.int16),
                            ("posit16", torch.int32),
                            ("posit32", torch.int32)):
        fmt = get_format(name)
        lo = -(1 << (fmt.n - 1))
        base = torch.randint(lo, -lo, (1 << 20,), generator=gen,
                             dtype=torch.int64).to(container).to(dev)
        per = 16 // base.element_size()
        for off in range(per):
            for n in (1, per - 1, per + 1, 4099, 100003):
                v = base[off:off + n]
                for out_dtype in (torch.float32, torch.bfloat16):
                    k = posit_decode(v, fmt, out_dtype)
                    p = posit_decode_torch(v, fmt, out_dtype)
                    torch.cuda.synchronize()
                    if not nan_aware_equal(k, p):
                        raise AssertionError(
                            f"posit_decode {name} in {container} -> "
                            f"{out_dtype}, offset {off}, length {n}: not "
                            f"bitwise equal to its plain version")
                    n_views += 1
    log(f"  posit_decode {n_views} views (int8/int16/int32 containers, f32 "
        f"and bf16, element offsets 0-15, ragged lengths): bitwise")
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
    check_kv_append(dev, gen, report)

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
                f"{lengths.tolist()}, plan (bs, key blocks, blocks per "
                f"split, splits) {kv_split_plan(S, 512, 32, sms)}: within "
                f"2e-5, max abs err {max_abs_err(k, p):.3g}")
        # granite-20b's 48 query rows over one KV head, D = 128
        for S in (96, 4096):
            q, kb, vb = kv_case(gen, 4, S, 1, 48, 128, fmt, dev)
            lengths = torch.tensor([1, S // 3, S - 1, S], dtype=torch.int32,
                                   device=dev)
            k = posit_kv_attention(q, kb, vb, lengths, fmt)
            p = posit_kv_attention_torch(q, kb, vb, lengths, fmt)
            torch.cuda.synchronize()
            if not torch.allclose(k, p, **KV_TOL):
                raise AssertionError(f"posit_kv_attention {name} G=48 S={S}:"
                                     f" {max_abs_err(k, p)} from its plain "
                                     f"version")
            err = max(err, max_abs_err(k, p))
            log(f"  posit_kv_attention {name} q (4, 1, 48, 128), K/V (4, "
                f"{S}, 1, 128), query groups (rows, groups) "
                f"{query_groups(48, 128)}, splits "
                f"{kv_split_plan(S, 512, 4, sms)[3]}: within 2e-5, max abs "
                f"err {max_abs_err(k, p):.3g}")
    report["posit_kv_attention"]["max_abs_err"] = err


def kv_append_case(gen, fmt, in_dtype, B, cap, KV, D, s_new, dev):
    """Two layers of random K/V storage (layer 1 is written: a view at an
    offset) and new K/V rows of random magnitudes with specials."""
    import torch
    lo = -(1 << (fmt.n - 1))
    store = [torch.randint(lo, -lo, (2, B, cap, KV, D), generator=gen)
             .to(fmt.storage_dtype).to(dev) for _ in range(2)]
    rows = []
    for _ in range(2):
        x = torch.randn(B, s_new, KV, D, generator=gen) * torch.exp2(
            torch.randint(-30, 30, (B, s_new, KV, D), generator=gen).float())
        x.view(-1)[:6] = torch.tensor([0.0, -0.0, float("inf"),
                                       float("nan"), 1e-40, -3e38])
        rows.append(x.to(in_dtype).to(dev))
    return store, rows


def check_kv_append(dev, gen, report):
    """The KV append bitwise against its plain version at the serve shape
    (B = 4, cap = 96, KV = 8, D = 128) in its three modes, posit8 and
    posit16, bf16 and f32 rows, and at a row width of 12 (one value a
    thread); one launch a call; the other layer and a dropped row
    untouched."""
    import torch
    from repro_torch.core.formats import get_format
    from repro_torch.kernels.posit_codec import (posit_kv_append,
                                                 posit_kv_append_torch)
    B, cap = 4, 96
    modes = {"per-row decode": (1, 8, 128, [0, cap - 1, cap, 17]),
             "per-row prefill": (37, 8, 128, [0, 0, 0, 0]),
             "scalar length": (5, 8, 128, 40),
             "scalar length, clamped": (9, 8, 128, cap - 3),
             "per-row decode, row width 12": (1, 3, 4, [3, 0, cap, 95])}
    n = 0
    for name in ("posit8", "posit16"):
        fmt = get_format(name)
        for in_dtype in (torch.bfloat16, torch.float32):
            for mode, (s_new, KV, D, length) in modes.items():
                store, (k_new, v_new) = kv_append_case(
                    gen, fmt, in_dtype, B, cap, KV, D, s_new, dev)
                length = torch.tensor(length, dtype=torch.int32, device=dev)
                orig = [t.clone() for t in store]
                want = [t.clone() for t in store]
                posit_kv_append_torch(k_new, v_new, want[0][1], want[1][1],
                                      length, fmt)
                before = posit_kv_append.launches
                posit_kv_append(k_new, v_new, store[0][1], store[1][1],
                                length, fmt)
                torch.cuda.synchronize()
                if posit_kv_append.launches != before + 1:
                    raise AssertionError("posit_kv_append: not one launch "
                                         "a call")
                dropped = (length.tolist().index(cap)
                           if length.dim() and cap in length.tolist()
                           else None)
                for got, w, o in zip(store, want, orig):
                    if not torch.equal(got, w):
                        raise AssertionError(
                            f"posit_kv_append {name} {in_dtype} {mode}: not"
                            f" bitwise equal to its plain version")
                    if not torch.equal(got[0], o[0]) or (
                            dropped is not None
                            and not torch.equal(got[1][dropped],
                                                o[1][dropped])):
                        raise AssertionError(
                            f"posit_kv_append {name} {in_dtype} {mode}: "
                            f"wrote outside its positions")
                n += 1
    log(f"  posit_kv_append (4, 96, 8, 128) posit8/posit16, bf16/f32 rows, "
        f"{', '.join(modes)}: {n} cases bitwise equal to the plain version, "
        f"one launch each, unwritten positions untouched")
    report["posit_kv_append"]["max_abs_err"] = 0.0


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
    from repro_torch.kernels.posit_matmul import (matmul_plan, posit_matmul,
                                                  posit_matmul_torch)
    from repro_torch.kernels.posit_round import (posit_fma_round,
                                                 posit_fma_round_torch)
    gen = torch.Generator().manual_seed(SEED + 4)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

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
    # the flat path at every element offset within 16 bytes (operands
    # alike: 16-byte loads with a head and a tail, the results stored one
    # value at a time where the output is not at their offset; unlike: one
    # value a thread), and the broadcast path under row, column and host
    # 0-d operands
    fmt = get_format("posit10")
    for dtype in (torch.float32, torch.float64):
        base = [torch.randn(70000, generator=gen, dtype=dtype) * 41
                for _ in range(3)]
        on = [t.to(dev) for t in base]
        per = 16 // base[0].element_size()
        cases = [((off, off, off), m) for off in range(per)
                 for m in (1, per + 1, 4099, 65537)]
        cases += [((0, off, (2 * off) % per), 40001)
                  for off in range(1, per)]
        for offs, m in cases:
            k = posit_fma_round(*(t[o:o + m] for t, o in zip(on, offs)), fmt)
            p = posit_fma_round_torch(*(t[o:o + m]
                                        for t, o in zip(on, offs)), fmt)
            torch.cuda.synchronize()
            if not bits_equal(k, p):
                raise AssertionError(f"posit_fma_round {dtype} views at "
                                     f"offsets {offs} of {m}: not bitwise")
            err = max(err, max_abs_err(k, p))
        a, b, c = (t[:64 * 96].reshape(64, 96) for t in on)
        s = torch.tensor(0.375, dtype=dtype)
        bcast = ((a, b[:1], c), (a[:, :1], b, c[:1]), (a, s, c), (s, b, s),
                 (a[:, :1], b[:1], s), (a.T, b.T, c.T))
        for ops in bcast:
            k = posit_fma_round(*ops, fmt)
            p = posit_fma_round_torch(*(t.to(dev) for t in ops), fmt)
            torch.cuda.synchronize()
            if not bits_equal(k, p):
                raise AssertionError(f"posit_fma_round {dtype} broadcast "
                                     f"{[tuple(t.shape) for t in ops]}: "
                                     f"not bitwise")
            err = max(err, max_abs_err(k, p))
        log(f"  posit_fma_round {str(dtype)[6:]}: {len(cases)} views at "
            f"element offsets 0-{per - 1} and ragged lengths, "
            f"{len(bcast)} broadcasts (rows, columns, host 0-d, a "
            f"transposed view): bitwise")
    report["posit_fma_round"]["max_abs_err"] = err

    # decode-fused matmul: the quickstart's shape and the FFN width in
    # posit16 and posit8; a ragged shape; posit16 patterns in an int32
    # container
    err = 0.0
    cases = [(name, mkn, False) for name in ("posit16", "posit8")
             for mkn in ((128, 256, 256), FFN_SHAPE)]
    cases += [("posit16", (70, 333, 200), False),
              ("posit16", (64, 1000, 300), True)]
    for name, (M, K, N), widen in cases:
        fmt = get_format(name)
        a, b = matmul_case(gen, M, K, N, fmt, dev)
        if widen:
            a, b = a.to(torch.int32), b.to(torch.int32)
        k, p = posit_matmul(a, b, fmt), posit_matmul_torch(a, b, fmt)
        torch.cuda.synchronize()
        rel = rel_err(k, p)
        if not rel <= MATMUL_REL_TOL:
            raise AssertionError(f"posit_matmul {name} ({M}, {K}) x "
                                 f"({K}, {N}): {rel:.3g} of the largest "
                                 f"output from its plain version")
        err = max(err, max_abs_err(k, p))
        log(f"  posit_matmul {name} {str(a.dtype)[6:]} ({M}, {K}) x "
            f"({K}, {N}), plan (bn, splits, slabs per split, grid) "
            f"{matmul_plan(M, N, K, a.element_size(), fmt.n, sms)}: max "
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
        f"({100 * busy_s / wall:.2f}% of wall), "
        f"{sum(r[1] for r in rows)} device kernels, copies and fills")
    for us, count, key in sorted(rows, reverse=True)[:top]:
        log(f"    {us / 1e3:9.3f} ms {count:7d} calls  {key[:70]}")


def fleet_fft_route_ab(dev, forest, counters, card):
    """The fleet four times more, in turns: its FFT stages through the
    stage-range kernel, through the earlier route (``earlier_fft_stages``
    in its place), the earlier route, the kernel; windows/s of each (host
    clock)."""
    from repro_torch.apps import dsp
    kernel = dsp.posit_fft_stages
    rates = {"kernel": [], "earlier": []}
    try:
        for name in ("kernel", "earlier", "earlier", "kernel"):
            dsp.posit_fft_stages = (kernel if name == "kernel"
                                    else earlier_fft_stages)
            engine, _, _, wall, launches = run_main_path(dev, forest,
                                                         counters)
            del engine
            rates[name].append(N_PATIENTS * N_WINDOWS / wall)
    finally:
        dsp.posit_fft_stages = kernel
    log(f"  fleet windows/s, FFT stages by the stage-range kernel "
        f"{rates['kernel']} against the earlier route {rates['earlier']} "
        f"(runs in turns kernel, earlier, earlier, kernel) ({card})")


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
    the ledger summary, the wall time, the launch counts of the load (the
    engine's weight quantization and one prefill) and of the serve run,
    and one captured layer-0 KV-attention call (q, K/V bits, lengths)."""
    import gc
    import torch
    from repro_torch.models import attention as attn
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    for c in counters:
        c.launches = 0
    engine = serve_engine(model, params, dev)
    reqs = serve_requests(cfg)
    reqs[2]["eos_id"] = first_greedy_token(engine, reqs[2]["prompt"], dev)
    torch.cuda.synchronize()
    load = {c.__name__: c.launches for c in counters}
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
    return (model, params, reqs, subs, comps, summary, wall, load, launches,
            captured.get("args"), peak)


def check_serve(cfg, subs, comps, summary, load, launches):
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
    for name in ("posit_decode", "posit_kv_append", "posit_kv_attention"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the serve path")
    if load["posit_encode"] <= 0:
        raise AssertionError("posit_encode never launched at load")
    if launches["posit_encode"] != 0:
        raise AssertionError(f"posit_encode launched "
                             f"{launches['posit_encode']} times while "
                             f"serving: a KV write took the encode route")
    steps = p8["decode_steps"] + p16["decode_steps"]
    prefills = p8["requests"] + p16["requests"]
    if launches["posit_kv_append"] != cfg.n_layers * (steps + prefills):
        raise AssertionError(f"posit_kv_append launched "
                             f"{launches['posit_kv_append']} times for "
                             f"{steps} decode steps and {prefills} prefills "
                             f"of {cfg.n_layers} layers: not one launch a "
                             f"layer-step")
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
    a steady window of engine steps (all slots decoding), with the weight
    decode's device time per lane-step beside its byte bound (every
    decoded value read and written once)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core import quant
    engine = serve_engine(model, params, dev)
    subs = submit_all(engine, reqs)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    step, wall = 0, 0.0
    real = quant.posit_decode
    decoded = {"bytes": 0, "calls": 0}

    def counted(bits, fmt, out_dtype=torch.float32):
        decoded["bytes"] += bits.numel() * (
            bits.element_size() + (2 if out_dtype == torch.bfloat16 else 4))
        decoded["calls"] += 1
        return real(bits, fmt, out_dtype)

    def lane_steps():     # the lanes' rows, not the "fleet" row's sum
        return sum(r["decode_steps"] for lane, r in
                   engine.ledger.summary().items() if lane != "fleet")
    steps0 = n_lane = 0
    try:
        while not engine.scheduler.idle:
            if step == PROFILE_STEPS[0]:
                torch.cuda.synchronize()
                steps0 = lane_steps()
                quant.posit_decode = counted
                prof.start()
                t0 = time.perf_counter()
            engine.step()
            if step == PROFILE_STEPS[1] - 1:
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                prof.stop()
                quant.posit_decode = real
                n_lane = lane_steps() - steps0
            step += 1
    finally:
        quant.posit_decode = real
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
    on_card = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    if n_lane and on_card:
        n_dev = sum(e.count for e in on_card)
        n_app = sum(e.count for e in on_card
                    if "posit_kv_append_kernel" in e.key)
        log(f"  device kernels (kernels, copies, fills) per lane-step in "
            f"that window: {n_dev / n_lane:.1f}, of them "
            f"{n_app / n_lane:g} KV appends ({card})")
    else:
        log("  device kernels per lane-step: not measured (no lane-step or "
            "no device event recorded)")
    dec_us = sum(e.self_device_time_total for e in on_card
                 if "posit_decode_kernel" in e.key)
    if n_lane and dec_us:
        log(f"  weight decode in that window: {decoded['calls']} launches, "
            f"{dec_us / 1e3:.3f} ms on the device over {n_lane} lane-steps,"
            f" {dec_us / 1e3 / n_lane:.3f} ms per lane-step against a byte "
            f"bound of {decoded['bytes'] / n_lane / HBM_BYTES_PER_S * 1e3:.3f}"
            f" ms ({decoded['bytes'] / n_lane / 1e9:.2f} GB per lane-step) "
            f"({card})")
    else:
        log("  weight decode in that window: not measured (no lane-step or "
            "no device time recorded)")


def serve_kv_route_ab(dev, model, params, reqs, want, card):
    """The serve run four times more, in turns, with the KV write through
    the append kernel (``kernel``) and through the earlier route
    (``earlier``, ``earlier_kv_append``): ms per decode step of each, on
    one card in one call, and the greedy tokens of every run equal to the
    first engine's."""
    import torch
    from repro_torch.models import attention as attn
    real = attn.posit_kv_append
    ms = {"kernel": [], "earlier": []}
    try:
        for route in ("kernel", "earlier", "earlier", "kernel"):
            attn.posit_kv_append = (real if route == "kernel"
                                    else earlier_kv_append)
            engine = serve_engine(model, params, dev)
            subs = submit_all(engine, reqs)
            got = {c.rid: c.tokens for c in engine.run()}
            torch.cuda.synchronize()
            row = engine.ledger.summary()["fleet"]
            ms[route].append(row["decode_tokens"] * row["us_per_token"]
                             * 1e-3 / row["decode_steps"])
            for rid, (r, _) in subs.items():
                if r["temperature"] == 0 and not (
                        got[rid].shape == want[rid].tokens.shape
                        and (got[rid] == want[rid].tokens).all()):
                    raise AssertionError(f"greedy tokens of request {rid} "
                                         f"differ on the {route} KV route")
            del engine
    finally:
        attn.posit_kv_append = real
    log(f"  ms per decode step, KV write by the append kernel "
        f"{ms['kernel']} against the earlier route {ms['earlier']} (runs "
        f"in turns kernel, earlier, earlier, kernel; greedy tokens equal in "
        f"all four) ({card})")


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
    for name in ("posit_round", "posit_fft_stages", "posit_matmul_round"):
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
                                                 posit_round_torch)
    fmt = get_format("posit16")
    gen = torch.Generator().manual_seed(SEED + 1)

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

    # matmul: the main path's four products of that batch (mel, DCT,
    # centroid, votes), the split kernel and the combine kernel's device
    # time together, beside an empty kernel's device time
    from repro_torch.kernels import posit_round as pr
    lib = pr._kernels()
    stream = torch.cuda.current_stream(dev).cuda_stream
    floor_dev = device_ms(lambda: lib.posit_empty_launch(stream),
                          "empty_kernel")
    log(f"  an empty kernel's device time: {floor_dev:.4f} ms")
    rows = []
    for name, (a, b) in shapes.items():
        (M, K), N = a.shape, b.shape[1]
        nbytes = 4 * (M * K + K * N + M * N)
        flops = 2 * M * K * N
        by_bytes = nbytes / HBM_BYTES_PER_S >= flops / F32_FLOPS_PER_S
        row = dict(
            name="posit_matmul_round", shape=[M, K, N, name],
            ms=cuda_ms(lambda: posit_matmul_round(a, b, fmt)),
            device_ms=device_ms(lambda: posit_matmul_round(a, b, fmt),
                                ("posit_matmul_round_kernel",
                                 "posit_matmul_round_combine_kernel")),
            plain_ms=cuda_ms(lambda: posit_matmul_round_torch(a, b, fmt)),
            bound_ms=max(nbytes / HBM_BYTES_PER_S,
                         flops / F32_FLOPS_PER_S) * 1e3,
            bound_by="bytes" if by_bytes else "operations",
            library_ms=cuda_ms(lambda: posit_round_torch(torch.matmul(a, b),
                                                         fmt)),
            floor_device_ms=floor_dev)
        if name == "mel":
            report["posit_matmul_round"].update(row)
        else:
            rows.append(row)
    return rows


def time_fft_stages(dev, report):
    """The stage-range kernel at the cough path's shape (the rfft's middle
    stages 2..10 of a posit16 batch of 32 windows x 2 channels) beside the
    earlier route (``earlier_fft_stages``): per call (CUDA events), the
    kernel's device time by name, and the device time and kernels per call
    of every device event (``device_kernels``).  Returns the earlier
    route's row, logged beside the JSON line's."""
    import torch
    from repro_torch.apps.cough import FFT_N
    from repro_torch.apps.dsp import get_fft_plan
    from repro_torch.core.formats import get_format
    from repro_torch.kernels import build
    from repro_torch.kernels.posit_fft import (fft_pass_plan,
                                               posit_fft_stages,
                                               posit_fft_stages_torch)
    fmt = get_format("posit16")
    gen = torch.Generator().manual_seed(SEED + 9)
    levels = FFT_N.bit_length() - 1
    s0, s1 = 2, levels - 1
    plan = get_fft_plan(FFT_N, fmt.name, torch.float32, str(dev))
    z = fft_state(gen, fmt, FFT_N, s0, (MAX_BATCH, 2), torch.float32, dev)
    nbytes = 2 * z.numel() * 4 + plan.table.numel() * 4
    butterflies = z.numel() // 4 * (s1 - s0)   # half a plane a stage
    # floors from the SASS count: each thread issues a stage's body once a
    # stage (its butterfly body once per butterfly it takes)
    sms = build.sm_count(dev.index or 0)
    passes = fft_pass_plan(FFT_N, s0, s1, z.numel() // (2 * FFT_N),
                           z.dtype, sms)
    stage_ins, bfly_ins, stage_alu, bfly_alu = stage_loop_sass(
        build.library_path("posit_fft"))
    issued = alu = 0
    for p in passes:
        per_thread = -(-p.groups_per_block * p.group // 2 // p.threads)
        warp_stages = p.blocks * -(-p.threads // 32) * (p.s1 - p.s0)
        issued += warp_stages * (stage_ins + bfly_ins * (per_thread - 1))
        alu += warp_stages * (stage_alu + bfly_alu * (per_thread - 1))
    all_ms, kernels = device_kernels(
        lambda: posit_fft_stages(z, plan.table, s0, s1, fmt))
    report["posit_fft_stages"].update(
        ms=cuda_ms(lambda: posit_fft_stages(z, plan.table, s0, s1, fmt)),
        device_ms=device_ms(
            lambda: posit_fft_stages(z, plan.table, s0, s1, fmt),
            "posit_fft_stages_kernel"),
        device_kernels=kernels,
        plain_ms=cuda_ms(lambda: posit_fft_stages_torch(
            z, plan.table, s0, s1, fmt), reps=2, samples=5),
        bound_ms=max(nbytes / HBM_BYTES_PER_S,
                     10 * butterflies / F32_FLOPS_PER_S) * 1e3,
        bound_by="bytes", library_ms=None,
        sass_stage_instructions=stage_ins,
        sass_butterfly_instructions=bfly_ins,
        sass_stage_alu_instructions=stage_alu,
        issue_floor_ms=issued / (sms * WARP_ISSUE_PER_SM_CLOCK
                                 * SM_CLOCK_HZ) * 1e3,
        alu_floor_ms=alu / (sms * WARP_ALU_PER_SM_CLOCK * SM_CLOCK_HZ)
        * 1e3,
        shape=[*z.shape, f"stages {s0}..{s1 - 1}"])
    row = report["posit_fft_stages"]
    e_ms, e_kernels = device_kernels(
        lambda: earlier_fft_stages(z, plan.table, s0, s1, fmt))
    earlier = dict(
        name="earlier_fft_stages", shape=row["shape"],
        ms=cuda_ms(lambda: earlier_fft_stages(z, plan.table, s0, s1, fmt)),
        device_ms=e_ms, device_kernels=e_kernels, plain_ms=None,
        bound_ms=row["bound_ms"], bound_by="bytes", library_ms=None,
        butterfly_device_ms=device_ms(
            lambda: earlier_fft_stages(z, plan.table, s0, s1, fmt),
            "posit_butterfly_kernel"))
    log(f"  FFT stages {s0}..{s1 - 1} at {tuple(z.shape)} posit16: the "
        f"stage-range kernel {row['ms']:.4f} ms per call, "
        f"{row['device_ms']:.4f} ms on the device ({all_ms:.4f} ms and "
        f"{kernels:g} kernels of every device event per call), byte bound "
        f"{row['bound_ms']:.5f} ms; SASS: {stage_ins} instructions a "
        f"stage ({bfly_ins} of them the butterfly loop's, {stage_alu} on "
        f"the ALU pipe), floors at {SM_CLOCK_HZ / 1e9:g} GHz on {sms} SMs "
        f"{row['issue_floor_ms']:.4f} ms at one warp instruction a "
        f"scheduler a clock and {row['alu_floor_ms']:.4f} ms at the ALU "
        f"pipe's rate; the earlier route "
        f"{earlier['ms']:.4f} ms per call, {e_ms:.4f} ms and "
        f"{e_kernels:g} kernels on the device "
        f"({earlier['butterfly_device_ms']:.4f} ms of it in the "
        f"{s1 - s0} butterfly launches)")
    return [earlier]


def time_format_kernels(dev, report):
    """The multiply-add at the round kernel's main-path shape (32, 2, 4096)
    f32, all three operands full size; the decode-fused matmul at the FFN
    width in posit16, beside ``torch.matmul`` on the bf16 operands already
    decoded (the decode not counted) and beside the unfused route, the
    codec kernel's decode of both operands and then ``torch.matmul``."""
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
    rows = []
    # three full operands (the flat path), a row broadcast and a host 0-d
    # operand (the broadcast path, the scalar by value)
    row_b, host_c = b[:1, :1].contiguous(), torch.tensor(0.375)
    for ops, what in (((a, b, c), "three full"),
                      ((a, row_b, c), "b a (1, 1, 4096) row"),
                      ((a, b, host_c), "c a host 0-d")):
        nbytes = (sum(t.numel() for t in ops if t.dim()) + n) * 4
        row = dict(
            name="posit_fma_round", shape=[*a.shape, what],
            ms=cuda_ms(lambda: posit_fma_round(*ops, fmt)),
            device_ms=device_ms(lambda: posit_fma_round(*ops, fmt),
                                "posit_fma_round_"),
            plain_ms=cuda_ms(lambda: posit_fma_round_torch(*ops, fmt)),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None)
        if what == "three full":
            report["posit_fma_round"].update(row)
        else:
            rows.append(row)
    # host microseconds per call over 10^4 calls: the wrapper in each case
    # beside the steps it cannot skip
    from repro_torch.kernels import posit_round as pr
    lib = pr._kernels()
    fn, stream = pr._fma_fns[torch.float32], torch.cuda.current_stream(
        dev).cuda_stream
    out = torch.empty_like(a)
    ptrs = (a.data_ptr(), b.data_ptr(), c.data_ptr(), out.data_ptr())
    us = {
        "the wrapper, three full": lambda: posit_fma_round(a, b, c, fmt),
        "the wrapper, a row": lambda: posit_fma_round(a, row_b, c, fmt),
        "the wrapper, a host 0-d": lambda: posit_fma_round(a, b, host_c,
                                                           fmt),
        "torch.empty_like": lambda: torch.empty_like(a),
        "ctypes call (the launch)": lambda: fn(*ptrs[:3], 0.0, 0.0, 0.0,
                                               ptrs[3], n, None, fmt.n,
                                               fmt.es, stream),
        "bare launch of an empty kernel":
            lambda: lib.posit_empty_launch(stream),
    }
    log("  posit_fma_round (32, 2, 4096) f32, host us per call over 10^4 "
        "calls: " + "; ".join(f"{k} {host_us(f):.2f}" for k, f in us.items()))

    M, K, N = FFN_SHAPE
    ab, bb = matmul_case(gen, M, K, N, fmt, dev)
    nbytes = (ab.numel() + bb.numel()) * ab.element_size() + M * N * 4
    flops = 2 * M * K * N
    by_bytes = nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOPS_PER_S
    a16, b16 = posit_decode(ab, fmt, torch.bfloat16), posit_decode(
        bb, fmt, torch.bfloat16)

    def unfused():
        return torch.matmul(posit_decode(ab, fmt, torch.bfloat16),
                            posit_decode(bb, fmt, torch.bfloat16))
    report["posit_matmul"].update(
        ms=cuda_ms(lambda: posit_matmul(ab, bb, fmt)),
        device_ms=device_ms(lambda: posit_matmul(ab, bb, fmt),
                            ("posit_matmul_wgmma_kernel",
                             "posit_matmul_combine_kernel")),
        plain_ms=cuda_ms(lambda: posit_matmul_torch(ab, bb, fmt), reps=2,
                         samples=5),
        bound_ms=max(nbytes / HBM_BYTES_PER_S,
                     flops / BF16_FLOPS_PER_S) * 1e3,
        bound_by="bytes" if by_bytes else "operations",
        library_ms=cuda_ms(lambda: torch.matmul(a16, b16)),
        unfused_ms=cuda_ms(unfused), shape=[M, K, N, "posit16"])
    return rows


def earlier_posit_round(x, fmt):
    """The round wrapper as it stood before its host path was cut
    (``_check_cuda``, a ``getattr`` on the library and a
    ``torch.cuda.current_stream`` object each call), launching today's
    kernel: timed beside the wrapper, in one run, on one card."""
    import torch
    from repro_torch.kernels import posit_round as pr
    pr._check_cuda("posit_round", x)
    out = torch.empty_like(x)
    if x.numel():
        fn = getattr(pr._kernels(), f"posit_round_{pr._SUFFIX[x.dtype]}")
        pr._raise_on(fn(x.data_ptr(), out.data_ptr(), x.numel(), fmt.n,
                        fmt.es,
                        torch.cuda.current_stream(x.device).cuda_stream),
                     "posit_round")
    return out


def host_us(fn, calls: int = 10000) -> float:
    """Host microseconds per call over ``calls`` back-to-back calls, after
    warmup, the queue drained before and after."""
    import torch
    for _ in range(100):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def time_round_host(dev, report):
    """B1 at the fleet's shapes, (32, 2, 4096) and a 0-d f32 (the 2-means'
    scalars, the most launched), beside an empty kernel's bare launch: per
    call (CUDA events), on the device (profiler), and the host time of
    each step of the earlier wrapper (``earlier_posit_round``), 10^4
    calls each.  Returns the rows logged beside the JSON line's."""
    import torch
    from repro_torch.core.formats import get_format
    from repro_torch.kernels import posit_round as pr
    lib = pr._kernels()
    idx = torch.cuda.current_device()
    stream = torch.cuda.current_stream(dev).cuda_stream
    rows = []

    def empty():
        return lib.posit_empty_launch(stream)
    floor_ms = cuda_ms(empty)
    floor_dev = device_ms(empty, "empty_kernel")
    log(f"  bare launch of an empty kernel through ctypes: {floor_ms:.4f} ms"
        f" per call ({floor_dev:.4f} ms on the device)")
    gen = torch.Generator().manual_seed(SEED + 7)
    # the cough batch's ingest rounding (posit16), an ECG 2-means scalar
    for shape, fmt in (((MAX_BATCH, 2, 4096), get_format("posit16")),
                       ((), get_format("posit10"))):
        x = (torch.randn(shape, generator=gen) * 2.0 ** 17).to(dev)
        out = torch.empty_like(x)
        fn = lib.posit_round_f32
        xp, op, n = x.data_ptr(), out.data_ptr(), x.numel()
        steps = {
            "_check_cuda": lambda: pr._check_cuda("posit_round", x),
            "torch.empty_like": lambda: torch.empty_like(x),
            "torch.cuda.current_stream(...).cuda_stream":
                lambda: torch.cuda.current_stream(x.device).cuda_stream,
            "torch._C._cuda_getCurrentRawStream":
                lambda: torch._C._cuda_getCurrentRawStream(idx),
            "getattr on the library": lambda: getattr(lib,
                                                      "posit_round_f32"),
            "two data_ptr()": lambda: (x.data_ptr(), out.data_ptr()),
            "ctypes call (the launch)": lambda: fn(xp, op, n, fmt.n, fmt.es,
                                                   stream),
            "bare launch of an empty kernel": empty,
            "the earlier wrapper": lambda: earlier_posit_round(x, fmt),
            "the wrapper": lambda: pr.posit_round(x, fmt),
        }
        us = {k: host_us(f) for k, f in steps.items()}
        log(f"  posit_round {list(shape)} f32, host us per call over 10^4 "
            f"calls: " + "; ".join(f"{k} {v:.2f}" for k, v in us.items()))
        row = dict(
            name="posit_round", shape=list(shape),
            ms=cuda_ms(lambda: pr.posit_round(x, fmt)),
            device_ms=device_ms(lambda: pr.posit_round(x, fmt),
                                "posit_round_kernel"),
            plain_ms=cuda_ms(lambda: pr.posit_round_torch(x, fmt)),
            bound_ms=2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", library_ms=None,
            earlier_ms=cuda_ms(lambda: earlier_posit_round(x, fmt)),
            floor_ms=floor_ms)
        log(f"  posit_round {list(shape)}: {row['ms']:.4f} ms per call "
            f"({row['device_ms']:.4f} ms on the device), the earlier wrapper "
            f"{row['earlier_ms']:.4f} ms per call, bare launch "
            f"{floor_ms:.4f} ms")
        if shape:
            report["posit_round"].update(row)
        else:
            rows.append(row)
    return rows


def earlier_kv_append(k_new, v_new, k_bits, v_bits, length, fmt):
    """The KV write as it stood before the append kernel: for each of K
    and V a cast to f32, one launch of the encode kernel and the eager
    per-row scatter; timed beside the append kernel, in one run, on one
    card."""
    import torch
    from repro_torch.kernels.posit_codec import kv_scatter, posit_encode
    for new, bits in ((k_new, k_bits), (v_new, v_bits)):
        kv_scatter(bits, posit_encode(new.to(torch.float32).contiguous(),
                                      fmt), length)


def time_kv_append(dev, gen, report):
    """The KV append at one layer's decode write on the serve path (B = 4
    slots, KV = 8, D = 128, bf16 rows, per-row lengths, a 96-position
    cache), posit8 and posit16, beside the earlier route: per call (CUDA
    events), the append kernel's device time (``device_ms``), and the
    device time and kernels per call of every kernel of the call
    (``device_kernels``).  Returns the rows logged beside the JSON
    line's."""
    import torch
    from repro_torch.core.formats import get_format
    from repro_torch.kernels.posit_codec import (posit_kv_append,
                                                 posit_kv_append_torch)
    rows = []
    B, cap, KV, D = 4, 96, 8, 128
    length = torch.tensor([10, 50, 94, 95], dtype=torch.int32, device=dev)
    for name in ("posit8", "posit16"):
        fmt = get_format(name)
        k_bits, v_bits = (torch.zeros(B, cap, KV, D, dtype=fmt.storage_dtype,
                                      device=dev) for _ in range(2))
        k_new, v_new = (torch.randn(B, 1, KV, D, generator=gen)
                        .to(torch.bfloat16).to(dev) for _ in range(2))
        args = (k_new, v_new, k_bits, v_bits, length, fmt)
        nbytes = (2 * k_new.numel() * (2 + k_bits.element_size())
                  + length.numel() * 4)
        all_ms, kernels = device_kernels(lambda: posit_kv_append(*args))
        dev_ms = device_ms(lambda: posit_kv_append(*args),
                           "posit_kv_append_kernel")
        row = dict(
            name="posit_kv_append", shape=[B, 1, KV, D, f"bf16->{name}"],
            ms=cuda_ms(lambda: posit_kv_append(*args)), device_ms=dev_ms,
            device_kernels=kernels,
            plain_ms=cuda_ms(lambda: posit_kv_append_torch(*args)),
            bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
            library_ms=None)
        e_ms, e_kernels = device_kernels(lambda: earlier_kv_append(*args))
        earlier = dict(
            name="earlier_kv_append", shape=row["shape"],
            ms=cuda_ms(lambda: earlier_kv_append(*args)), device_ms=e_ms,
            device_kernels=e_kernels, plain_ms=None,
            bound_ms=row["bound_ms"], bound_by="bytes", library_ms=None)
        log(f"  KV write {name}: the append kernel {row['ms']:.4f} ms per "
            f"call, {dev_ms:.4f} ms on the device ({all_ms:.4f} ms and "
            f"{kernels:g} kernels of every device event per call); the "
            f"earlier route {earlier['ms']:.4f} ms per call, {e_ms:.4f} ms "
            f"and {e_kernels:g} kernels on the device")
        if name == "posit8":            # the posit8 lane's cache
            report["posit_kv_append"].update(row)
        else:
            rows.append(row)
        rows.append(earlier)
    return rows


def time_serve_kernels(dev, report):
    """The serve kernels at serve-path shapes: decode and encode of one
    (4096, 12288) FFN weight, the KV append of one layer, and the
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
    # the serve path's other weight shapes (q/o, k/v, FFN down, the
    # unembedding), and f32 out and posit8 bits at the FFN width
    for shape, fmt, out_dtype in (
            ((4096, 4096), p16, torch.bfloat16),
            ((4096, 1024), p16, torch.bfloat16),
            ((12288, 4096), p16, torch.bfloat16),
            ((152064, 4096), p16, torch.bfloat16),
            ((4096, 12288), p16, torch.float32),
            ((4096, 12288), get_format("posit8"), torch.bfloat16)):
        b = torch.randint(-(1 << (fmt.n - 1)), 1 << (fmt.n - 1), shape,
                          device=dev, dtype=torch.int32).to(
                              fmt.storage_dtype)
        out_size = 2 if out_dtype == torch.bfloat16 else 4
        rows.append(dict(
            name="posit_decode",
            shape=[*shape, f"{str(b.dtype)[6:]}->{str(out_dtype)[6:]}"],
            ms=cuda_ms(lambda: posit_decode(b, fmt, out_dtype)),
            device_ms=device_ms(lambda: posit_decode(b, fmt, out_dtype),
                                "posit_decode_kernel"),
            plain_ms=None,
            bound_ms=b.numel() * (b.element_size() + out_size)
            / HBM_BYTES_PER_S * 1e3, bound_by="bytes", library_ms=None))
        del b
    report["posit_encode"].update(
        ms=cuda_ms(lambda: posit_encode(w, p16)),
        device_ms=device_ms(lambda: posit_encode(w, p16),
                            "posit_encode_kernel"),
        plain_ms=cuda_ms(lambda: posit_encode_torch(w, p16), reps=2,
                         samples=5),
        bound_ms=n * (4 + 2) / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None, shape=[4096, 12288, "f32->int16"])
    rows += time_kv_append(dev, gen, report)

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
                ("posit_kv_attention_kernel", "posit_kv_combine_kernel")),
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
    from repro_torch.kernels.posit_codec import (posit_decode, posit_encode,
                                                 posit_kv_append)
    from repro_torch.kernels.posit_fft import posit_fft_stages
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
    for name in ("posit_codec", "posit_round", "posit_fft", "posit_matmul",
                 "posit_kv_attention"):
        text = build.BUILD_LOGS.get(name)
        if text is None:
            log(f"  nvcc -Xptxas -v {name}.cu: built before this run, no "
                f"compiler output")
            continue
        log(f"  nvcc -Xptxas -v {name}.cu (registers, spill stores/loads "
            f"bytes, stack bytes):")
        for entry, regs, st, ld, stack in ptxas_report(text):
            log(f"    {entry[:72]}: {regs} registers, spills {st}/{ld}, "
                f"stack {stack}")
    hgmma = sass_count(libs["posit_matmul"], "HGMMA")
    if not any("posit_matmul_wgmma_kernel" in fn for fn in hgmma):
        raise AssertionError("posit_matmul: no HGMMA (wgmma) instruction in "
                             "the decode-fused kernel's SASS")
    log(f"  cuobjdump -sass: HGMMA (wgmma.mma_async) instructions per "
        f"kernel: {hgmma}")

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
        "posit_fft_stages": dict(
            name="posit_fft_stages", route="cuda",
            source=f"{src}/csrc/posit_fft.cu",
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
        "posit_kv_append": dict(
            name="posit_kv_append", route="cuda",
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
    counters = (posit_round, posit_butterfly, posit_fft_stages,
                posit_matmul_round, posit_decode, posit_encode,
                posit_kv_append, posit_kv_attention, posit_fma_round,
                posit_matmul)
    stream_kernels = ("posit_round", "posit_fft_stages", "posit_matmul_round")
    phase("phase 2: kernels against their plain versions")
    shapes = check_kernels(dev, report)
    check_fft_stages(dev, report)
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
    if launches["posit_round"] != FLEET_ROUND_LAUNCHES:
        raise AssertionError(f"posit_round launched {launches['posit_round']}"
                             f" times on the fleet, not the reference "
                             f"design's {FLEET_ROUND_LAUNCHES}")
    if launches["posit_matmul_round"] != FLEET_MATMUL_ROUND_CALLS:
        raise AssertionError(f"posit_matmul_round launched "
                             f"{launches['posit_matmul_round']} times on the"
                             f" fleet, not {FLEET_MATMUL_ROUND_CALLS}")
    if launches["posit_fft_stages"] != FLEET_FFT_STAGE_LAUNCHES:
        raise AssertionError(f"posit_fft_stages launched "
                             f"{launches['posit_fft_stages']} times on the "
                             f"fleet, not {FLEET_FFT_STAGE_LAUNCHES}")
    if launches["posit_butterfly"] != 0:
        raise AssertionError(f"posit_butterfly launched "
                             f"{launches['posit_butterfly']} times on the "
                             f"fleet: the FFT stages take the stage-range "
                             f"kernel")
    # posit_butterfly is off the path now: its count, 0, is reported
    for name in (*stream_kernels, "posit_butterfly"):
        report[name]["launches"] = launches[name]
    del engine
    profile_main_path(dev, forest, counters)
    fleet_fft_route_ab(dev, forest, counters, card)

    phase("phase 4: times (median ms per call, CUDA events)")
    extra = time_kernels(dev, shapes, report)
    extra += time_fft_stages(dev, report)
    extra += time_round_host(dev, report)
    extra += time_format_kernels(dev, report)
    extra += time_serve_kernels(dev, report)
    for r in [*report.values(), *extra]:
        lib = ("-" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        plain = "-" if r["plain_ms"] is None else f"{r['plain_ms']:.4f}"
        unfused = (f", decode + torch.matmul {r['unfused_ms']:.4f} ms"
                   if "unfused_ms" in r else "")
        if "device_kernels" in r:
            unfused += f", {r['device_kernels']:g} device kernels per call"
        if "floor_device_ms" in r:
            unfused += (f", an empty kernel {r['floor_device_ms']:.4f} ms on "
                        f"the device")
        log(f"  {r['name']} {r['shape']}: {r['ms']:.4f} ms per call "
            f"({r['device_ms']:.4f} ms of it on the device), bound "
            f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
            f"{plain} ms, library {lib}{unfused}")
    torch.cuda.empty_cache()

    phase(f"phase 5: serve path, {SERVE_ARCH} at full width, "
          f"{2 * SERVE_PROMPTS} requests on two lanes")
    from repro_torch.configs import CONFIGS
    cfg = CONFIGS[SERVE_ARCH]
    (model, params, reqs, subs, comps, summary, wall, load, launches,
     captured, peak) = run_serve(dev, cfg, counters)
    by_rid = check_serve(cfg, subs, comps, summary, load, launches)
    for name in ("posit_decode", "posit_kv_append", "posit_kv_attention"):
        report[name]["launches"] = launches[name]
    # the weights are encoded at load, never while serving
    report["posit_encode"]["launches"] = load["posit_encode"]
    log(f"  launches at load (the weights' posit16 quantization, one "
        f"prefill): {load}")
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
    serve_kv_route_ab(dev, model, params, reqs, by_rid, card)
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
    print(json.dumps({"kernels_at_other_shapes": [
        {k: r.get(k) for k in ("name", "shape", "ms", "device_ms",
                               "device_kernels", "plain_ms", "bound_ms",
                               "bound_by", "library_ms")}
        for r in extra]}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in report.values()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
