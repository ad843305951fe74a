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
     the rounded matmul bitwise (its plain version sums in the kernel's
     order) and the same bits on a second call (the main path's four
     shapes, ragged ones, f64), a slab of 1, 2, 4 or 6 rows bitwise the
     same rows of 64 at the four shapes, the
     posit-KV attention within rtol = atol = 2e-5; the round and the
     decode also on views at every element offset within 16 bytes and
     ragged lengths (every decode container, both output types), the
     decode tables built on the card against their plain version, the
     KV-attention at 48 query rows per KV head; the FFT stage-range
     kernel bitwise at the cough rfft's middle stages (batch 32), whole
     FFTs of 4096 and 256 points in posit10 and posit8 (two passes, odd
     batches) and in f64, and equal to the earlier route it replaced; the
     multiply-add at every element offset within 16 bytes and under row,
     column and host 0-d broadcasts, in f32 and f64; the R-peak tracker's
     2-means (``posit_kmeans_1d``, one launch a call) bitwise its plain
     version, the per-op path, on full 500-score reservoirs in posit10 and
     posit16, cold and warm started;
  3. the stream path: a 64-patient fleet (32 cough patients at posit16
     with every fourth pinned to fp16, 32 ECG patients at posit10 with
     every fourth pinned to posit8)
     streamed in ragged chunks through ``StreamEngine``, with every window
     scored exactly once, every stream kernel's launch count above zero
     (the round's equal to the window cores' 285, the rounded matmul's
     to its 12 calls, the FFT stage range's to 3, one per posit16 cough
     batch, the trackers' 2-means's to 128, one per tracked ECG window,
     and no butterfly launch),
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
     shapes beside an empty kernel's device time and beside the same
     kernel on the M-dependent plan it replaced (``earlier_matmul_round``);
     the KV append at the
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
     weights are encoded at load), the engine's ``/metrics`` series
     reconciling with its ``TokenLedger``, greedy tokens reproduced by a
     second engine with eight of its steps under ``torch.profiler`` (the device's
     busy share and kernels per lane-step, the weight decode's device time
     per lane-step beside its byte bound), the serve run twice more with
     the KV write through the append kernel and through the earlier route
     (ms per decode step of each), the KV-attention kernel
     held against its plain version on the live cache, and the reduced
     config's logits on the card against the same weights on the CPU;
  5b. the MoE serve path: granite-moe-3b-a800m at full width (32 layers,
     40 experts top-8, random weights from a seeded generator on the
     card) behind ``ServingEngine`` with phase 5's two lanes and 12
     requests: every request completed once, 32 KV-attention launches per
     decode step, one KV append per layer and decode step or prefill, no
     encode while serving, the weight decodes per lane-step and prefill
     the number predicted from the quant policy, no plain version called
     on a CUDA tensor, ``/metrics`` reconciling, greedy tokens reproduced
     by a second engine under ``torch.profiler`` (busy share, kernels per
     lane-step, the weight decode's device time), the expert-stack
     decode's device time per lane-step beside its byte bound; then one
     2048-position prefill without lengths (``chunked_attention``: finite
     logits, layer 0 within 1e-2 of ``plain_attention`` on the card), and
     the reduced config's logits on the card against the CPU's;
  5c. the vlm family through the model API (``ServingEngine`` refuses it,
     as the reference's does): internvl2-2b at full width (24 layers,
     random weights from a seeded generator on the card, posit16), 4 rows
     of 256 seeded f32 patch rows and 64 tokens, prefill and 16 greedy
     decode steps on a posit8 and a posit16 KV lane: the launches of the
     prefill and of every decode step as ``api_launches`` predicts, no
     plain version called on a CUDA tensor, the greedy tokens reproduced
     by a second run with 8 of its steps under ``torch.profiler`` (busy
     share, device kernels per lane-step), ms per prefill and decode step
     (host clock), tokens/s, card memory, and the reduced config's logits
     on the card against the CPU's;
  5d. the encdec family the same way: seamless-m4t-large-v2 at full width
     (24 encoder and 24 decoder layers), 4 rows of 2048 seeded f32 frames
     (the encoder through ``chunked_attention``, non-causal) and 16 BOS
     tokens; with the cross K/V decode's device ms per step (in the
     profiled window) and the prefill's cross K/V encodes beside their
     byte bounds, and a decode step's whole cross-attention read of the
     posit cross K/V on the device;
  5e. the ssm family the same way, on one lane (it has no KV cache):
     xlstm-1.3b at full width (6 groups of 7 mLSTM + 1 sLSTM blocks), 4
     rows of 512 tokens (two mLSTM chunks), 272 weight decodes a prefill
     and a decode step (``w_h`` once a pass), every posit decode's device
     ms per lane-step beside its byte bound, and one sLSTM block's
     per-token loop at prefill (host clock, device time and kernels); the
     reduced config at 512 tokens over four seeds, the card's and the
     CPU's logits each held against a witness on the CPU whose every sum
     is taken in f64 (``reduced_against_witness``);
  5f. the hybrid family the same way: zamba2-7b at full width (13 groups
     of 6 Mamba2 layers, each followed by the shared attention + MLP
     block, then a 3-layer tail; shared attention 32 heads of 112), 4
     rows of 512 tokens (two SSD chunks), 255 weight decodes, 13 KV
     appends and (decode steps) 13 KV-attention launches a pass, and the
     shared block's weight decodes (the same seven weights at each of its
     13 calls) beside their byte bound;
  6. the format study: R-peak F1 over nine formats and cough AUC over
     three on the card, the paper's orderings asserted, three formats'
     F1 card against CPU; the quickstart (one decode-fused matmul launch);
     ``Arith.fma`` (one multiply-add launch per call);
  7. the ingest fleet: 64 patients (2 windows each, duplicated and
     deferred frames, ``ecg-031`` silent after its first frame) in process
     on one ``StreamEngine``, then over localhost TCP through
     ``IngestServer`` and ``SessionManager`` on a fresh engine with a
     ``Supervisor``, the ``/metrics`` scrape plane and a ``Tracer``: every
     delivered window bitwise equal to the in-process run, ``ecg-031``
     evicted with exactly its delivered prefix, no window dropped, the
     round, FFT stage-range and rounded-matmul kernels launched and no
     plain version called on a CUDA tensor, the page scraped over HTTP
     reconciling exactly with the ledger and the telemetry, a valid Chrome
     trace; windows/s in process and over TCP, latency percentiles and
     the longest dispatch logged (the stall timeout is 5x that, at least
     1 s);
  8. the ingest worker pool on the card, two spawned workers each with
     its own CUDA context: the reference suite's chaos acceptance run (64
     ECG patients, worker 0 SIGKILLed 0.4 s after its ready, one patient
     partitioned, one corrupted, auth and spill armed) with every
     patient's digest equal to the in-process card run and the restart's
     recovery time; then phase 7's mixed fleet, fault-free, its ledger
     windows and nJ and every digest equal to the in-process run, each
     worker's launches of the round, the FFT stage range and the rounded
     matmul above zero and no plain version called on a CUDA tensor
     there; windows/s of the pool and in process, and the card memory
     each worker holds; then (8c) the same fleet through workers whose
     dispatch is sharded over 2 data slabs of the card (``devices=2``),
     ledger and digests equal to the in-process run;
  9. distributed and durability: (a) phase 3's fleet at cap 30 on one
     card engine and on one sharded over 4 data slabs of the card
     (``split_mesh_info``), every output and peak bitwise equal, the
     ledger's windows and nJ exact, the stream launches as predicted, no
     plain version on a CUDA tensor, windows/s of each; (b) qwen3-8b's
     layer-0 weights at full width (0.77 GB f32 on the card), an int32
     step and a 1-D leaf saved async twice by a posit16
     ``CheckpointManager`` (``keep=1``) and restored on the card: every
     2-D leaf bitwise B5's decode(encode(x)), 7 encodes a save and 7
     decodes a restore, the times beside their byte bounds; (c) the same
     leaves through ``posit_all_reduce`` and ``posit_all_reduce_ef`` at
     world size 1 on NCCL (an in-process ``HashStore``): bitwise
     decode(encode(x)), the EF residual exact, 2 encodes and 2 decodes a
     call (3 and 3 with EF);
  10. training on the card: (a) gemma2-2b at full width and depth (26
     layers, d_model 2304, vocab 256000, 2.614 G parameters, seeded
     random weights) with posit16 QAT weights, 4 rows of 512
     ``TokenPipeline`` tokens, through ``make_train_step`` (remat, AdamW,
     the WSD schedule): one warm-up step (lr 0: the weights stay), then 4
     timed steps with exactly 12 B1 launches each (one per rounded leaf),
     the weights moving, finite losses and moments, no plain version on a
     CUDA tensor (``PlainCalls(TRAIN_PLAIN)``); ms per step and tokens/s
     (host clock, to the loss's host copy), AdamW's span per step (CUDA
     events) beside 28 B a parameter, one step under ``torch.profiler``
     (busy share, device kernels, B1's device ms beside its byte bound)
     and one under a profiler of CUDA activity alone (busy share), B1
     alone at the 12 leaves (its device kernels counted), the peak
     memory; (b) every reduced config's loss and gradients on the card
     against the CPU from the same weights within 2e-2 (MoE routes held
     to the card's; xlstm on four seeds in f32 within 2e-2, and in bf16
     from an exact-sum witness within 1.5 times the CPU's own spread
     under one-ulp moves of its weights), three posit16 QAT
     steps of reduced gemma2-2b (36 B1 launches) near the CPU's, reduced
     qwen3-8b through ``launch/train.py`` resumed from a checkpoint within
     rtol 1e-4, and the pod-compressed branch at world size 1 on NCCL
     (2 encodes and 2 decodes a gradient leaf, bitwise the plain codec);
  11. the planner against the card: phase 10's gemma2-2b cell planned by
     ``launch.dryrun.plan_cell`` on a 1 × 1 mesh of the card (traced on
     ``meta``): (a) its argument bytes equal the state and batch held on
     the card, exactly; (b) ``roofline.analysis.analyze_step`` of one real
     step on the card counts the FLOPs and bytes of the ``meta`` trace,
     exactly, with 12 B1 launches; (c) the planned peak beside
     ``max_memory_allocated``; (d) the roofline terms beside phase 10's
     ms per step.

Phase 2 also holds the round bitwise at a phase 10 QAT leaf's shape,
(26, 2304, 1024) f32 posit16, and the multiply-add bitwise and the
decode-fused matmul
within 1e-5 of its largest output against their plain versions (at the
quickstart's shape, the FFN width in posit16 and posit8, a ragged shape
and an int32 container), the IEEE rounding on the card bitwise against the
CPU's, and quire-mode dot and matmul on the card against the exact oracle;
the KV-attention is held at S = 96 (one split) and S = 32768 (many).
Phase 2 also holds, at granite-moe-3b-a800m's shapes, the KV-attention
at D = 64, G = 3 (posit8 and posit16) within 2e-5, the expert stacks'
decode bitwise, and one MoE layer's output the same bits on a second call.
Phase 2 holds, at phases 5c's, 5d's and 5f's shapes, the KV-attention at
G = 2, D = 128, at G = 1, D = 64 and at G = 1, D = 112 (KV = 32) within
2e-5, the KV append at KV = 16, D = 64 and KV = 32, D = 112 in its three
modes and the encode and f32 decode at the cross K/V shape (4, 2048, 16,
64) bitwise; phase 4 times them (and the KV-attention beside
``scaled_dot_product_attention``), and the weight decode at every weight
shape of phases 5e and 5f.
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
import math
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
L2_BYTES = 50 * 2 ** 20        # H100 SXM L2 cache
COLD_BYTES = 4 * L2_BYTES      # distinct input bytes a timed call reads, so
                               # that it reads them from device memory
F32_FLOPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
FLEET_ROUND_LAUNCHES = 285     # the 64-patient fleet's posit_round launches
                               # (its window cores; the trackers' 2-means
                               # round inside posit_kmeans_1d)
FLEET_KMEANS_LAUNCHES = 128    # ... and its posit_kmeans_1d launches (one
                               # per tracked ECG window, 32 patients x 4)
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
LEAD_PAUSE_S = 0.1             # a profile window's host pause, then
LEAD_SPINS = 256               # its spin kernels (``window_events``),
LEAD_CYCLES = 20_000           # ~10 us each
SERVE_ARCH = "qwen3-8b"
MOE_ARCH = "granite-moe-3b-a800m"   # phase 5b
LONG_PREFILL = 2048            # phase 5b: a prefill without lengths
CHUNKED_TOL = dict(rtol=1e-2, atol=1e-2)   # chunked vs plain, bf16 outputs
VLM_ARCH = "internvl2-2b"      # phase 5c
ENCDEC_ARCH = "seamless-m4t-large-v2"   # phase 5d
SSM_ARCH = "xlstm-1.3b"        # phase 5e
HYBRID_ARCH = "zamba2-7b"      # phase 5f
RECURRENT_PROMPT = 512         # phases 5e, 5f: prompt tokens (two chunks
                               # of the scans' 256)
API_BATCH = 4                  # phases 5c-5f: rows of the batch
VLM_PROMPT = 64                # phase 5c: tokens after the 256 patch rows
ENCDEC_SRC = 2048              # phase 5d: source frames (the encoder
                               # attends through chunked_attention)
ENCDEC_BOS = 16                # phase 5d: BOS tokens primed at prefill
API_STEPS = 16                 # phases 5c-5f: greedy decode steps a lane
API_PROFILE = (4, 12)          # decode steps profiled in the second run
POOL_WORKERS = 2               # phase 8
POOL_SLABS = 2                 # phase 8c: data slabs of the card a worker
SHARD_SLABS = 4                # phase 9a: data slabs of the card
SHARD_MAX_BATCH = 30           # phase 9a: fleet_pad(30, 4) = 32 rows
# phase 9a: the fleet's stream launches on one card engine at cap 30
# (cough posit16 96 windows and ECG posit10 96 in 3 batches of 30 and one
# of 6 each, ECG posit8 32 in 30 + 2; fp16 launches none), from phase 3's
# counts: the window functions round 404 times over the fleet's 10 posit
# batches at cap 30 and 285 over its 7 at cap 32, the trackers' 2-means
# launch 128 times at either cap (a CPU rehearsal under the kernel
# backend, counting the round's calls with phase 2's plan caches built);
# the sharded engine runs each batch's window functions once a slab, and a
# slab's 16 FFTs take the stage range in two passes where a batch's 60
# take one (fft_pass_plan cuts a pass that would leave SMs idle)
SHARD_BATCH_ROUNDS = 404
SHARD_PLAIN_LAUNCHES = {
    "posit_round": SHARD_BATCH_ROUNDS, "posit_fft_stages": 4,
    "posit_matmul_round": 16, "posit_kmeans_1d": FLEET_KMEANS_LAUNCHES}
SHARD_LAUNCHES = {
    "posit_round": SHARD_SLABS * SHARD_BATCH_ROUNDS,
    "posit_fft_stages": SHARD_SLABS * 4 * 2,
    "posit_matmul_round": SHARD_SLABS * 16,
    "posit_kmeans_1d": FLEET_KMEANS_LAUNCHES}
# phase 9b: qwen3-8b's layer-0 weights at full width, f32 on the card
CKPT_LEAVES = (("wq", (4096, 4096)), ("wk", (4096, 1024)),
               ("wv", (4096, 1024)), ("wo", (4096, 4096)),
               ("w_gate", (4096, 12288)), ("w_up", (4096, 12288)),
               ("w_down", (12288, 4096)))
POOL_REALTIME = 8.0            # phase 8a: the drive lasts 0.5 s, so the kill
                               # 0.4 s after the worker's ready lands in it
POOL_STALL_S = 10.0            # phase 8: no patient stalls; the timeout only
                               # outlasts a fresh worker's first dispatches
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
RECURRENT_SEEDS = (0, 1, 2, 3)  # phases 5e, 5f: the reduced configs' seeds
WITNESS_FACTOR = 1.5           # phases 5e, 5f: the card's largest distance
                               # from the exact-sum witness over the seeds,
                               # over the CPU's (both in LOGIT_TOL tiers)
TRAIN_ARCH = "gemma2-2b"        # phase 10: trained at full width
TRAIN_BATCH, TRAIN_SEQ = 4, 512
TRAIN_STEPS = 4                # timed steps after one warm-up step
TRAIN_ROUNDS = 12              # B1 launches a step: the rounded leaves
QAT_ROUNDS = 5                 # QAT rounds in phase 10's profile window
TRAIN_LEAF = (26, 2304, 1024)  # phase 2: B1 at gemma2-2b's stacked wk
TRAIN_TOL = 2e-2               # phase 10b: the loss (absolute)
TRAIN_GRAD_TOL = 2e-2          # ... a gradient leaf (relative L2)
ULP_MOVES = 4                  # ... xlstm's bf16 spread: one-ulp moves
RESUME_RTOL = 1e-4             # phase 10b: the reference's resume bound
INGEST_WINDOWS = 2             # phase 7: windows per patient
INGEST_MAX_BATCH = 16
INGEST_STALLED = "ecg-031"     # silent after its first frame, evicted


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


def per_launch_ms(events, kernels, launches):
    """(device ms, launches recorded) of ``launches`` launches of the
    kernels whose names contain one of ``kernels`` (a name or a tuple of
    names), from a profile's ``key_averages``: the mean device time of the
    launches it recorded, times ``launches`` (the profiler may drop some of
    a window's events, which would make a plain sum short); NaN if it
    recorded none."""
    from torch.autograd import DeviceType
    names = (kernels,) if isinstance(kernels, str) else tuple(kernels)
    hits = [e for e in events if e.device_type == DeviceType.CUDA
            and any(k in e.key for k in names)]
    n = sum(e.count for e in hits)
    us = sum(getattr(e, "self_device_time_total", 0) for e in hits)
    return (us / n * launches / 1e3 if n and us else float("nan")), n


def device_ms(fn, kernels, reps: int = 50, launches=None) -> float:
    """Mean device time per call of ``fn``: the device time of every kernel
    whose name contains one of ``kernels`` (a name or a tuple of names: a
    combine or reduction kernel the call launches is counted), from
    ``torch.profiler`` over ``reps`` calls (no host time), divided by the
    number of calls.  With ``launches``, the launches of ``kernels`` a call
    makes, the time is ``per_launch_ms``'s, which a dropped event does not
    make short.  A profile that recorded none of them (the profiler drops a
    window's events now and then) is taken again, up to ``PROFILE_TRIES``
    profiles; NaN if none recorded any."""
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
        events = prof.key_averages()
        if launches is not None:
            ms, n = per_launch_ms(events, names, launches * reps)
            if n:
                return ms / reps
            continue
        hits = [e for e in events if any(k in e.key for k in names)]
        us = sum(getattr(e, "self_device_time_total", 0) for e in hits)
        if us:
            return us / reps / 1e3
    return float("nan")


def window_events(fn, reps: int = 50):
    """(the device rows, spins recorded) of one ``torch.profiler`` window
    of ``reps`` calls of ``fn``: every kernel, copy and fill it records on
    the card (``key_averages`` rows), but for the ``LEAD_SPINS`` spin
    kernels (``torch.cuda._sleep``) that open the window after a host
    pause of ``LEAD_PAUSE_S``.  The profiler drops the first events of a
    window now and then (late in a long run, most of a QAT round's 60), and
    a drop that ends among the spins has taken none of ``fn``'s: a window
    that recorded a spin holds every event of its calls.  A window that
    recorded none is taken again, up to ``PROFILE_TRIES`` windows; the
    last one's rows, with 0 spins, if none did."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(LEAD_PAUSE_S)
            for _ in range(LEAD_SPINS):
                torch.cuda._sleep(LEAD_CYCLES)
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [e for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count > 0]
        spins = sum(e.count for e in rows if "spin_kernel" in e.key)
        rows = [e for e in rows if "spin_kernel" not in e.key]
        if spins:
            break
    return rows, spins


def device_kernels(fn, reps: int = 50):
    """(device ms per call, device kernels per call) of ``fn``: every
    kernel, copy and fill of a ``window_events`` window, over ``reps``;
    NaN where no window recorded a spin (its count may be short)."""
    rows, spins = window_events(fn, reps)
    if not spins:
        return float("nan"), float("nan")
    return (sum(e.self_device_time_total for e in rows) / reps / 1e3,
            sum(e.count for e in rows) / reps)


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
    # a training leaf (phase 10's QAT round): gemma2-2b's stacked wk, drawn
    # as its init draws it
    fmt = get_format("posit16")
    x = torch.randn(TRAIN_LEAF, generator=gen).to(dev) / math.sqrt(
        TRAIN_LEAF[-2])
    k, p = posit_round(x, fmt), posit_round_torch(x, fmt)
    torch.cuda.synchronize()
    if not bits_equal(k, p):
        raise AssertionError(f"posit_round at the training leaf {TRAIN_LEAF}"
                             f": not bitwise equal to its plain version")
    err = max(err, max_abs_err(k, p))
    log(f"  posit_round posit16 float32 {TRAIN_LEAF} (a QAT leaf of phase "
        f"10): bitwise")
    del x, k, p
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

    # posit_matmul_round: the main path's shapes, bitwise (its plain
    # version sums in the kernel's order), and a slab's rows equal to the
    # same rows of the whole batch
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
    err = 0.0
    for name, (a, b) in cases:
        k = posit_matmul_round(a, b, fmt)
        again = posit_matmul_round(a, b, fmt)
        p = posit_matmul_round_torch(a, b, fmt)
        torch.cuda.synchronize()
        if not bits_equal(k, p):
            raise AssertionError(f"posit_matmul_round {name}: not bitwise "
                                 f"equal to its plain version (at most "
                                 f"{int(ulp_distance(k, p, fmt).max())} "
                                 f"ulp apart)")
        if not bits_equal(k, again):
            raise AssertionError(f"posit_matmul_round {name}: two calls "
                                 f"gave different bits")
        err = max(err, max_abs_err(k, p))
        (M, K), N = a.shape, b.shape[1]
        log(f"  posit_matmul_round {name} {str(a.dtype)[6:]} ({M}, {K})x"
            f"({K}, {N}), plan (tm, tn, splits, k per split) "
            f"{round_matmul_plan(K, N)}: bitwise, the same bits on a "
            f"second call")
    for name, (a, b) in shapes.items():
        a = torch.cat([a, a])[:rows] if a.shape[0] < rows else a
        whole = posit_matmul_round(a, b, fmt)
        for m in (1, 2, 4, 6):
            if not bits_equal(posit_matmul_round(a[:m].contiguous(), b, fmt),
                              whole[:m]):
                raise AssertionError(f"posit_matmul_round {name}: a slab of "
                                     f"{m} rows differs from the same rows "
                                     f"of {rows}")
    log(f"  posit_matmul_round: slabs of 1, 2, 4, 6 rows bitwise equal to "
        f"the same rows of {rows} at mel, DCT, centroid and votes")
    report["posit_matmul_round"]["max_abs_err"] = err
    return shapes


def earlier_matmul_round(a, b, fmt):
    """``posit_matmul_round`` as it ran before its split over K became a
    function of K and N alone: the same kernel, launched with the earlier
    plan, which counted the output tiles of all M rows against the card's
    SMs (so a row's sum order, and its bits, followed M).  Timed beside
    the kernel's plan, in one run, on one card."""
    import torch
    from repro_torch.kernels import build
    from repro_torch.kernels import posit_matmul as pm
    (M, K), N = a.shape, b.shape[1]
    tn = min(8, 1 << max(0, N - 1).bit_length())
    tiles = -(-M // (pm.ROUND_ACC // tn)) * -(-N // tn)
    chunks = max(1, -(-K // pm.ROUND_THREADS))
    want = max(1, min(-(-build.sm_count(a.device.index) // tiles), chunks,
                      16))
    per = -(-chunks // want) * pm.ROUND_THREADS
    splits = max(1, -(-K // per))
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    part = (torch.empty((splits, M, N), dtype=a.dtype, device=a.device)
            if splits > 1 else None)
    rc = pm._kernels().posit_matmul_round_f32(
        a.data_ptr(), b.data_ptr(), out.data_ptr(),
        part.data_ptr() if part is not None else None, M, K, N, tn, splits,
        per, fmt.n, fmt.es, torch.cuda.current_stream(a.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"earlier_matmul_round: cudaError {rc}")
    return out


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
    from repro_torch.kernels.posit_kv_attention import (kv_split_plan,
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
            lengths = [0, 1, 777, S]
            e = check_kv_attention(gen, fmt, S, 8, 4, 128, lengths, dev)
            err = max(err, e)
            log(f"  posit_kv_attention {name} (4, {S}, 8, 128) lengths "
                f"{lengths}, plan (bs, key blocks, blocks per split, splits) "
                f"{kv_split_plan(S, 512, 32, sms)}: within 2e-5, max abs "
                f"err {e:.3g}")
        # granite-20b's 48 query rows over one KV head, D = 128
        for S in (96, 4096):
            e = check_kv_attention(gen, fmt, S, 1, 48, 128,
                                   [1, S // 3, S - 1, S], dev)
            err = max(err, e)
            log(f"  posit_kv_attention {name} q (4, 1, 48, 128), K/V (4, "
                f"{S}, 1, 128), query groups (rows, groups) "
                f"{query_groups(48, 128)}, splits "
                f"{kv_split_plan(S, 512, 4, sms)[3]}: within 2e-5, max abs "
                f"err {e:.3g}")
    report["posit_kv_attention"]["max_abs_err"] = err


def check_kv_attention(gen, fmt, S, KV, G, D, lengths, dev):
    """The KV-attention within ``KV_TOL`` of its plain version on random q
    (4, KV, G, D) and posit K/V (4, S, KV, D) with per-row ``lengths``, a
    row of length 0 all zeros; returns the max abs err."""
    import torch
    from repro_torch.kernels.posit_kv_attention import (
        posit_kv_attention, posit_kv_attention_torch)
    q, kb, vb = kv_case(gen, 4, S, KV, G, D, fmt, dev)
    lengths = torch.tensor(lengths, dtype=torch.int32, device=dev)
    k = posit_kv_attention(q, kb, vb, lengths, fmt)
    p = posit_kv_attention_torch(q, kb, vb, lengths, fmt)
    torch.cuda.synchronize()
    err = max_abs_err(k, p)
    if not torch.allclose(k, p, **KV_TOL):
        raise AssertionError(f"posit_kv_attention {fmt.name} KV={KV} G={G} "
                             f"D={D} S={S}: {err} from its plain version")
    if not torch.all(k[lengths == 0] == 0):
        raise AssertionError("posit_kv_attention: a length 0 row is not "
                             "zero")
    return err


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


def check_kv_append(dev, gen, report, KV=8, D=128):
    """The KV append bitwise against its plain version at a serve shape
    (B = 4, cap = 96, ``KV`` heads of ``D``: its thread -> element map
    follows the row width) in its three modes, posit8 and posit16, bf16
    and f32 rows, and at a row width of 12 (one value a thread); one launch
    a call; the other layer and a dropped row untouched."""
    import torch
    from repro_torch.core.formats import get_format
    from repro_torch.kernels.posit_codec import (posit_kv_append,
                                                 posit_kv_append_torch)
    B, cap = 4, 96
    modes = {"per-row decode": (1, KV, D, [0, cap - 1, cap, 17]),
             "per-row prefill": (37, KV, D, [0, 0, 0, 0]),
             "scalar length": (5, KV, D, 40),
             "scalar length, clamped": (9, KV, D, cap - 3),
             "per-row decode, row width 12": (1, 3, 4, [3, 0, cap, 95])}
    n = 0
    for name in ("posit8", "posit16"):
        fmt = get_format(name)
        for in_dtype in (torch.bfloat16, torch.float32):
            for mode, (s_new, kv, d, length) in modes.items():
                store, (k_new, v_new) = kv_append_case(
                    gen, fmt, in_dtype, B, cap, kv, d, s_new, dev)
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
    log(f"  posit_kv_append (4, 96, {KV}, {D}) posit8/posit16, bf16/f32 "
        f"rows, {', '.join(modes)}: {n} cases bitwise equal to the plain "
        f"version, one launch each, unwritten positions untouched")
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


def run_main_path(dev, forest, counters, **engine_kw):
    """The fleet through one ``StreamEngine`` (``engine_kw`` beside the
    default ``max_batch=MAX_BATCH``); the counters set to 0 just before."""
    import numpy as np
    from repro_torch.stream import StreamEngine, cough_pipeline, rpeak_pipeline
    rng = np.random.default_rng(SEED)
    queues, pins, records = build_fleet(rng)
    engine = StreamEngine({"cough": cough_pipeline(forest),
                           "rpeak": rpeak_pipeline()},
                          **{"max_batch": MAX_BATCH, "device": dev,
                             **engine_kw})
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


def report_busy(events, wall: float, what: str, top: int) -> None:
    """Log the device's busy share of ``wall`` seconds and its top kernels,
    from the device-side (kernel and memcpy) events of a profile: an
    operator's own row carries the device time of the kernels it launched,
    so summing every row would count that time twice."""
    from torch.autograd import DeviceType
    rows = [(e.self_device_time_total, e.count, e.key)
            for e in events
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
    report_busy(prof.key_averages(), wall, "under the profiler", 6)


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
    from repro_torch.obs import MetricsRegistry
    from repro_torch.serve import ServeConfig, ServingEngine
    return ServingEngine(model, params, ServeConfig(
        batch_size=SERVE_BATCH, max_prompt=SERVE_MAX_PROMPT,
        max_new_tokens=SERVE_NEW_TOKENS, seed=SEED), device=dev,
        metrics=MetricsRegistry())


def check_serve_metrics(engine, comps):
    """The serve engine's rendered page reconciles exactly with its
    ``TokenLedger`` summary (as tests/test_obs.py's serve test holds it),
    and counts every completion once."""
    from repro_torch.obs import parse_prometheus
    got = parse_prometheus(engine.metrics.render_prometheus())
    n = 0
    for lane, row in engine.ledger.summary().items():
        for k, v in row.items():
            if got[(f"serve_{k}", (("lane", lane),))] != float(v):
                raise AssertionError(f"/metrics serve_{k}{{{lane}}} differs "
                                     f"from the TokenLedger")
            n += 1
    done = engine.metrics.counter("serve_completions_total").total()
    if done != len(comps):
        raise AssertionError(f"serve_completions_total {done}, "
                             f"{len(comps)} completions")
    log(f"  serve /metrics: {n} ledger series reconcile with the "
        f"TokenLedger; {int(done)} completions counted")


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
    the fresh bf16 K/V), right-padded to its bucket as the engine pads it
    (a MoE layer's capacity counts the pad positions)."""
    import numpy as np
    import torch
    from repro_torch.serve import AGGRESSIVE_SERVE
    from repro_torch.stream.engine import bucket_size
    lane = engine._lane(AGGRESSIVE_SERVE)
    toks = np.zeros((1, bucket_size(len(prompt), engine.cfg.max_prompt)),
                    np.int64)
    toks[0, :len(prompt)] = prompt
    logits, _ = lane.model.prefill(
        lane.params, {"tokens": torch.from_numpy(toks).to(dev),
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
    check_serve_metrics(engine, comps)
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


def reduced_batch(cfg, seed=SEED):
    """Four prompts of the reduced config from a numpy seed: ragged, with
    their lengths, where the family is served by ``ServingEngine``; of 16
    tokens after 8 f32 patch rows (vlm) or 12 f32 source frames (encdec);
    of ``RECURRENT_PROMPT`` tokens (two chunks of the scans, so the carry
    across chunks runs) where the prefill takes no lengths (ssm, hybrid)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    if cfg.family in ("ssm", "hybrid"):
        return {"tokens": rng.integers(1, cfg.vocab, (4, RECURRENT_PROMPT))}
    if cfg.family == "vlm":
        return {"tokens": rng.integers(1, cfg.vocab, (4, 16)),
                "frontend": rng.normal(size=(4, cfg.frontend_len,
                                             cfg.d_model))
                .astype(np.float32)}
    if cfg.family == "encdec":
        return {"tokens": rng.integers(1, cfg.vocab, (4, 16)),
                "frames": rng.normal(size=(4, 12, cfg.d_model))
                .astype(np.float32)}
    lens = np.array([5, 3, 9, 16], np.int32)
    toks = np.zeros((4, 16), np.int64)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, cfg.vocab, n)
    return {"tokens": toks, "lengths": lens}


def exact_sums():
    """A ``TorchFunctionMode`` under which every sum a model computes (the
    products of ``matmul``, ``@`` and ``einsum``, ``sum``, ``mean``,
    ``cumsum``, ``softmax``) is carried out in f64 and rounded once to its
    operands' dtype: the model's own roundings of every value it keeps,
    without the accumulation-order error of either device.  The witness
    the card's and the CPU's logits are both held against."""
    import torch
    from torch.overrides import TorchFunctionMode
    sums = {torch.matmul, torch.Tensor.__matmul__, torch.einsum, torch.sum,
            torch.Tensor.sum, torch.mean, torch.Tensor.mean, torch.cumsum,
            torch.Tensor.cumsum, torch.softmax, torch.Tensor.softmax}

    def up(a):
        if isinstance(a, torch.Tensor) and a.is_floating_point():
            return a.double()
        return a

    class ExactSums(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            floats = [a for a in args if isinstance(a, torch.Tensor)
                      and a.is_floating_point()]
            if func not in sums or not floats:
                return func(*args, **kwargs)
            return func(*map(up, args), **kwargs).to(floats[0].dtype)
    return ExactSums()


def reduced_run(cfg, raw, batch, d, fed=None, exact=False):
    """The reduced config on device ``d`` with posit16 weights from ``raw``
    (numpy leaves): prefill of ``batch`` into a cache of 8 positions more
    than its tokens, then four decode steps, each fed the greedy token of
    ``fed``'s logits at that step (its own, without ``fed``); under
    ``exact_sums`` with ``exact``.  Returns the five steps' last-position
    logits, f32 on the CPU."""
    import contextlib
    import torch
    from repro_torch.core.formats import get_format
    from repro_torch.core.policy import AGGRESSIVE_POLICY
    from repro_torch.core.quant import quantize_params
    from repro_torch.models import build_model
    from repro_torch.models.convert import params_from_jax
    model = build_model(cfg, AGGRESSIVE_POLICY, device=d)
    params = quantize_params(params_from_jax(raw, d), get_format("posit16"),
                             cast_rest=torch.bfloat16)
    with exact_sums() if exact else contextlib.nullcontext():
        logits, caches = model.prefill(
            params, {k: torch.from_numpy(v).to(d) for k, v in batch.items()},
            batch["tokens"].shape[1] + 8)
        steps = [logits[:, -1].float().cpu()]
        for s in range(4):
            nxt = (steps[-1] if fed is None else fed[s])[:, :cfg.vocab]
            logits, caches = model.decode_step(
                params, nxt.argmax(-1)[:, None].to(d), caches)
            steps.append(logits[:, -1].float().cpu())
    return steps


def tier_ratio(a, b):
    """The largest |a - b| over the ``LOGIT_TOL`` tier at b (``allclose``
    holds where it is at most 1)."""
    tol = LOGIT_TOL["atol"] + LOGIT_TOL["rtol"] * b.abs()
    return float(((a - b).abs() / tol).max())


def greedy_held(a, ref):
    """(equal, clear, held): ``a``'s greedy tokens against ``ref``'s, held
    equal where ``ref``'s top-2 margin exceeds 4e-2, as in
    tests/test_torch_serve.py (a closer pair may swap under bf16 rounding
    differences of either device)."""
    import torch
    same = a.argmax(-1) == ref.argmax(-1)
    top2 = ref.topk(2, dim=-1).values
    clear = (top2[:, 0] - top2[:, 1]) > 4e-2
    return int(same.sum()), int(clear.sum()), bool(torch.all(same[clear]))


def reduced_against_witness(dev, arch):
    """The recurrent families' reduced check: for each seed of
    ``RECURRENT_SEEDS``, the two-chunk prompt on the card and on the CPU
    (the card fed the CPU's greedy tokens) and under ``exact_sums`` on the
    CPU (the witness, fed the same).  Over that prompt the model carries
    either device's order of summation past the 2e-2 tier between the two,
    and the CPU's own logits can lie beyond the tier from the witness; so
    the card's logits are held to the witness: the card's largest distance
    over the seeds (in tiers of ``LOGIT_TOL``) within ``WITNESS_FACTOR``
    times the CPU's (or of the tier, where the CPU stays within it), and
    each device's greedy tokens equal to the witness's where its top-2
    margin exceeds 4e-2.  Every seed is logged before a failure raises."""
    import torch
    from repro_torch.configs import CONFIGS, reduced
    from repro_torch.core.policy import AGGRESSIVE_POLICY
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    cfg = reduced(CONFIGS[arch])
    r_card, r_cpu, swapped = [], [], []
    for seed in RECURRENT_SEEDS:
        raw = tree_map(lambda t: t.numpy(),
                       build_model(cfg, AGGRESSIVE_POLICY, device="cpu")
                       .init(torch.Generator().manual_seed(seed)))
        batch = reduced_batch(cfg, seed)
        cpu = reduced_run(cfg, raw, batch, "cpu")
        card = reduced_run(cfg, raw, batch, dev, fed=cpu)
        ref = reduced_run(cfg, raw, batch, "cpu", fed=cpu, exact=True)
        r_card.append(max(tier_ratio(a, w) for a, w in zip(card, ref)))
        r_cpu.append(max(tier_ratio(b, w) for b, w in zip(cpu, ref)))
        held = {"card": [0, 0], "CPU": [0, 0]}
        for a, b, w in zip(card, cpu, ref):
            for got, who in ((a, "card"), (b, "CPU")):
                e, c, ok = greedy_held(got[:, :cfg.vocab], w[:, :cfg.vocab])
                held[who][0] += e
                held[who][1] += c
                if not ok:
                    swapped.append(f"seed {seed} {who}")
        log(f"  reduced {arch} seed {seed}, prefill of "
            f"{tuple(batch['tokens'].shape)} + 4 decode steps, from the "
            f"exact-sum witness: card "
            f"{max(max_abs_err(a, w) for a, w in zip(card, ref)):.4g} "
            f"({r_card[-1]:.3f} tiers), CPU "
            f"{max(max_abs_err(b, w) for b, w in zip(cpu, ref)):.4g} "
            f"({r_cpu[-1]:.3f} tiers); card from CPU "
            f"{max(max_abs_err(a, b) for a, b in zip(card, cpu)):.4g}; "
            f"greedy tokens equal to the witness's in {held['card'][0]} "
            f"(card) and {held['CPU'][0]} (CPU) of {5 * len(batch['tokens'])}"
            f", {held['CPU'][1]} with a top-2 margin above 4e-2")
    if swapped:
        raise AssertionError(f"reduced {arch}: a greedy token with a clear "
                             f"margin differs from the witness's: {swapped}")
    bound = WITNESS_FACTOR * max(1.0, max(r_cpu))
    if max(r_card) > bound:
        raise AssertionError(f"reduced {arch}: card logits {max(r_card):.3g}"
                             f" tiers from the exact-sum witness, over "
                             f"{bound:.3g} (the CPU's {max(r_cpu):.3g})")
    log(f"  reduced {arch} over seeds {RECURRENT_SEEDS}: the card at most "
        f"{max(r_card):.3f} tiers from the witness, the CPU {max(r_cpu):.3f}"
        f" (bound {bound:.3g}); every clear greedy token equal")


def serve_reduced_on_card_and_cpu(dev, arch=SERVE_ARCH):
    """The reduced config, run by the port on the card (the kernel route)
    and on the CPU (the plain route) with the same weights: prefill
    (``reduced_batch``) and four decode steps fed the CPU's greedy tokens;
    logits within 2e-2 and the same greedy tokens wherever the top-2
    margin exceeds 4e-2.  The recurrent families (ssm, hybrid) are held
    against a witness instead (``reduced_against_witness``)."""
    import torch
    from repro_torch.configs import CONFIGS, reduced
    from repro_torch.core.policy import AGGRESSIVE_POLICY
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    cfg = reduced(CONFIGS[arch])
    if cfg.family in ("ssm", "hybrid"):
        reduced_against_witness(dev, arch)
        return
    raw = tree_map(lambda t: t.numpy(),
                   build_model(cfg, AGGRESSIVE_POLICY, device="cpu")
                   .init(torch.Generator().manual_seed(SEED)))
    batch = reduced_batch(cfg)
    cpu = reduced_run(cfg, raw, batch, "cpu")
    card = reduced_run(cfg, raw, batch, dev, fed=cpu)
    worst, n_equal, n_clear = 0.0, 0, 0
    for s, (a, b) in enumerate(zip(card, cpu)):
        if not torch.allclose(a, b, **LOGIT_TOL):
            raise AssertionError(f"reduced {arch} step {s}: card "
                                 f"logits {max_abs_err(a, b):.3g} from "
                                 f"the CPU's")
        a, b = a[:, :cfg.vocab], b[:, :cfg.vocab]
        e, c, ok = greedy_held(a, b)
        if not ok:
            raise AssertionError(f"reduced {arch} step {s}: greedy "
                                 f"tokens differ between card and CPU")
        worst = max(worst, max_abs_err(a, b))
        n_equal += e
        n_clear += c
    log(f"  reduced {arch} on the card vs the CPU: prefill + 4 decode "
        f"steps, logits within {worst:.3g}; greedy tokens equal in "
        f"{n_equal} of {5 * len(batch['tokens'])} ({n_clear} with a top-2 "
        f"margin above 4e-2, all equal)")


class DecodeTally:
    """``quant.posit_decode`` (the route of every posit decode of a model
    pass) wrapped, between ``start`` and ``stop``, to count its calls and
    the bytes they read and write (every pattern read and every value
    written once)."""

    def __init__(self):
        self.calls = self.bytes = 0
        self._real = None

    def start(self):
        from repro_torch.core import quant
        self._real = quant.posit_decode
        quant.posit_decode = self._counted

    def stop(self):
        from repro_torch.core import quant
        if self._real is not None:
            quant.posit_decode, self._real = self._real, None

    def _counted(self, bits, fmt, out_dtype=None):
        import torch
        out_dtype = torch.float32 if out_dtype is None else out_dtype
        self.bytes += bits.numel() * (bits.element_size()
                                      + torch.finfo(out_dtype).bits // 8)
        self.calls += 1
        return self._real(bits, fmt, out_dtype)


def log_decode_window(events, tally, lane_steps, card):
    """Every posit decode of a profiled window of ``lane_steps`` lane-steps
    (``tally``: its launches and the bytes they read and write) beside its
    byte bound, the device time from ``per_launch_ms``."""
    ms, n = per_launch_ms(events, "posit_decode_kernel", tally.calls)
    if not (lane_steps and n and tally.calls) or math.isnan(ms):
        log("  every posit decode in that window: not measured (no "
            "lane-step or no device time recorded)")
        return
    ms /= lane_steps
    per_step = tally.bytes / lane_steps
    bound = per_step / HBM_BYTES_PER_S * 1e3
    log(f"  every posit decode in that window: {tally.calls / lane_steps:g}"
        f" launches a lane-step ({n} of {tally.calls} recorded), "
        f"{ms:.3f} ms on the device per lane-step against a byte bound of "
        f"{bound:.3f} ms ({per_step / 1e9:.2f} GB read and written; "
        f"{ms / bound * 100:.1f} % of it) ({card})")


def profile_serve(dev, model, params, reqs, want, card):
    """A second engine with the same seed and requests: every greedy token
    reproduced, and the device's busy share under ``torch.profiler`` over
    a steady window of engine steps (all slots decoding), with every posit
    decode's device time per lane-step beside its byte bound
    (``log_decode_window``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    engine = serve_engine(model, params, dev)
    subs = submit_all(engine, reqs)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    step, wall = 0, 0.0
    tally = DecodeTally()

    def lane_steps():     # the lanes' rows, not the "fleet" row's sum
        return sum(r["decode_steps"] for lane, r in
                   engine.ledger.summary().items() if lane != "fleet")
    steps0 = n_lane = 0
    try:
        while not engine.scheduler.idle:
            if step == PROFILE_STEPS[0]:
                torch.cuda.synchronize()
                steps0 = lane_steps()
                tally.start()
                prof.start()
                t0 = time.perf_counter()
            engine.step()
            if step == PROFILE_STEPS[1] - 1:
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                prof.stop()
                tally.stop()
                n_lane = lane_steps() - steps0
            step += 1
    finally:
        tally.stop()
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
    events = prof.key_averages()
    report_busy(events, wall, f"under the profiler, engine steps "
                f"{PROFILE_STEPS[0]}-{PROFILE_STEPS[1] - 1} (both lanes "
                f"decoding) ({card})", 8)
    on_card = [e for e in events if e.device_type == DeviceType.CUDA]
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
    log_decode_window(events, tally, n_lane, card)


def serve_kv_route_ab(dev, model, params, reqs, want, card):
    """The serve run twice more, with the KV write through the append
    kernel (``kernel``) and through the earlier route (``earlier``,
    ``earlier_kv_append``): ms per decode step of each, on one card in one
    call, and the greedy tokens of every run equal to the first
    engine's."""
    import torch
    from repro_torch.models import attention as attn
    real = attn.posit_kv_append
    ms = {"kernel": [], "earlier": []}
    try:
        for route in ("kernel", "earlier"):
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
        f"{ms['kernel']} against the earlier route {ms['earlier']} (greedy "
        f"tokens equal in both) ({card})")


# ---------------------------------------------------------------------------
# Phase 5b: the moe family at full width behind ServingEngine
# ---------------------------------------------------------------------------

def moe_layer(cfg, gen, dev):
    """One MoE layer of ``cfg`` at full width on ``dev``: an f32 router and
    the expert stacks as posit16 bits, from ``gen``."""
    import torch
    from repro_torch.core.formats import get_format
    from repro_torch.core.quant import quantize_params
    from repro_torch.models.common import materialize
    from repro_torch.models.moe import init_moe
    raw = materialize(init_moe(cfg), gen, dev)
    return quantize_params({"moe": raw}, get_format("posit16"))["moe"]


def check_moe_kernels(dev, report):
    """Phase 2 at the MoE path's geometry (``MOE_ARCH``): the KV-attention
    at D = 64, G = 3 in posit8 and posit16 within 2e-5 of its plain version,
    the KV append at KV = 8, D = 64 and the decode of the expert stacks
    bitwise, the encode of a stacked expert weight at its load shape
    bitwise, and one MoE layer's output and aux loss the same bits on a
    second call (the combine adds in a fixed order, without atomics)."""
    import torch
    from repro_torch.configs import CONFIGS
    from repro_torch.core.formats import get_format
    from repro_torch.kernels.posit_codec import (posit_decode,
                                                 posit_decode_torch,
                                                 posit_encode,
                                                 posit_encode_torch)
    from repro_torch.kernels.posit_kv_attention import query_groups
    from repro_torch.models.common import materialize
    from repro_torch.models.moe import init_moe, moe_ffn
    cfg = CONFIGS[MOE_ARCH]
    KV, D = cfg.n_kv_heads, cfg.resolved_head_dim
    G = cfg.n_heads // KV
    gen = torch.Generator().manual_seed(SEED + 7)
    err = report["posit_kv_attention"].get("max_abs_err") or 0.0
    for name in ("posit8", "posit16"):
        fmt = get_format(name)
        for S in (96, LONG_PREFILL):
            e = check_kv_attention(gen, fmt, S, KV, G, D,
                                   [1, S // 3, S - 1, S], dev)
            err = max(err, e)
            log(f"  posit_kv_attention {name} q (4, {KV}, {G}, {D}), K/V "
                f"(4, {S}, {KV}, {D}) ({MOE_ARCH}), query groups "
                f"{query_groups(G, D)}: within 2e-5, max abs err {e:.3g}")
    report["posit_kv_attention"]["max_abs_err"] = err
    check_kv_append(dev, gen, report, KV, D)
    p16 = get_format("posit16")
    E, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    for shape in ((E, d, f), (E, f, d)):
        bits = torch.randint(-2 ** 15, 2 ** 15, shape, generator=gen,
                             dtype=torch.int16).to(dev)
        k = posit_decode(bits, p16, torch.bfloat16)
        p = posit_decode_torch(bits, p16, torch.bfloat16)
        torch.cuda.synchronize()
        if not nan_aware_equal(k, p):
            raise AssertionError(f"posit_decode expert stack {shape}: not "
                                 f"bitwise equal to its plain version")
        log(f"  posit_decode expert stack {shape} int16 -> bf16: bitwise")
    # the encode at load takes each stacked expert weight whole: w_gate's
    # (L, E, d, f) f32, drawn as the load draws it; the plain version is
    # elementwise, so it is taken a layer at a time
    card_gen = torch.Generator(device=dev).manual_seed(SEED)
    w = materialize({"w": init_moe(cfg)["w_gate"]}, card_gen, dev,
                    layers=cfg.n_layers)["w"]
    k = posit_encode(w, p16)
    for i in range(cfg.n_layers):
        if not torch.equal(k[i], posit_encode_torch(w[i], p16)):
            raise AssertionError(f"posit_encode of the stacked expert "
                                 f"weight {tuple(w.shape)}, layer {i}: not "
                                 f"bitwise equal to its plain version")
    log(f"  posit_encode stacked expert weight {tuple(w.shape)} f32 -> "
        f"posit16 ({w.numel()} values, one launch): bitwise")
    del w, k
    torch.cuda.empty_cache()
    layer = moe_layer(cfg, card_gen.manual_seed(SEED), dev)
    for B, S in ((1, 64), (4, 1), (1, LONG_PREFILL)):
        x = (torch.randn(B, S, d, generator=gen)).to(torch.bfloat16).to(dev)
        out1, aux1 = moe_ffn(layer, x, cfg)
        out2, aux2 = moe_ffn(layer, x, cfg)
        torch.cuda.synchronize()
        if not (torch.equal(out1.view(torch.int16), out2.view(torch.int16))
                and torch.equal(aux1.view(torch.int32),
                                aux2.view(torch.int32))):
            raise AssertionError(f"moe_ffn ({B}, {S}, {d}): a second call "
                                 f"on the card gave other bits")
        if not bool(torch.isfinite(out1.float()).all()):
            raise AssertionError(f"moe_ffn ({B}, {S}, {d}): not finite")
        log(f"  moe_ffn ({B}, {S}, {d}) {E} experts top-{cfg.top_k}: the "
            f"same bits on a second call (output and aux loss "
            f"{float(aux1):.6f})")


def moe_decodes_per_pass(cfg):
    """The weight decodes one forward pass (a lane-step or a prefill) makes
    under the posit16 weights policy, predicted from the quant policy: the
    posit leaves per layer are wq, wk, wv, wo and the three expert stacks
    (the router stays bf16: its name is not a weight leaf's), plus the
    embedding's gathered rows and the unembedding."""
    return cfg.n_layers * (4 + 3) + 2


def log_serve_ledger(summary, card):
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


def check_live_kv(captured):
    """The KV-attention kernel against its plain version on a live cache
    captured from the serve run."""
    import torch
    from repro_torch.kernels.posit_kv_attention import (
        posit_kv_attention, posit_kv_attention_torch)
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


def expert_decode_per_lane_step(cfg, params, card):
    """The device time of one lane-step's expert-stack decodes: the real
    per-layer stacks (three a layer, the reference's whole-weight decode)
    decoded back to back in the serve path's order, each from its own
    buffer and none kept, beside their byte bound (every pattern read and
    every bf16 value written once).  Returns the row logged beside the
    JSON line's, per stack."""
    import torch
    from repro_torch.kernels.posit_codec import posit_decode_torch
    from repro_torch.models.common import wval
    moe = params["layers"]["moe"]
    leaves = [moe[name][i] for i in range(cfg.n_layers)
              for name in ("w_gate", "w_up", "w_down")]

    def lane_step():
        for leaf in leaves:
            wval(leaf)
    n = len(leaves)
    ms = cuda_ms(lane_step, reps=1, samples=11)
    dev_ms = device_ms(lane_step, "posit_decode_kernel", reps=10,
                       launches=n)
    nbytes = sum(leaf.bits.numel() * (leaf.bits.element_size() + 2)
                 for leaf in leaves)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  expert-stack decode per lane-step: {n} launches back to back "
        f"(each stack its own buffer, none kept), {ms:.3f} ms per "
        f"lane-step, {dev_ms:.3f} ms of it on the device, against a byte "
        f"bound of {bound:.3f} ms ({nbytes / 1e9:.2f} GB read and written; "
        f"{dev_ms / bound * 100:.1f} % of it) ({card})")
    one = leaves[0]
    return dict(
        name="posit_decode",
        shape=[n, "stacks", *one.bits.shape, "int16->bf16", "back to back"],
        ms=ms / n, device_ms=dev_ms / n,
        plain_ms=cuda_ms(lambda: posit_decode_torch(one.bits, one.fmt,
                                                    torch.bfloat16),
                         reps=2, samples=5),
        bound_ms=bound / n, bound_by="bytes", library_ms=None)


def long_prefill(dev, model, qparams, card):
    """One prefill of ``LONG_PREFILL`` positions without lengths (the
    chunked attention's path): finite logits, and layer 0's chunked
    attention within ``CHUNKED_TOL`` of ``plain_attention`` on the same
    q, k, v on the card."""
    import numpy as np
    import torch
    from repro_torch.models import attention as attn
    toks = np.random.default_rng(SEED).integers(
        1, model.cfg.vocab, (1, LONG_PREFILL))
    captured = []
    real = attn.chunked_attention

    def capture(q, k, v, **kw):
        if not captured:
            captured.append((q, k, v, kw))
        return real(q, k, v, **kw)
    attn.chunked_attention = capture
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, caches = model.prefill(
            qparams, {"tokens": torch.from_numpy(toks).to(dev)})
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        attn.chunked_attention = real
    if len(captured) != 1 or not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{LONG_PREFILL}-position prefill: "
                             f"{len(captured)} chunked calls captured, "
                             f"finite logits {torch.isfinite(logits).all()}")
    q, k, v, kw = captured[0]
    got = real(q, k, v, **kw)
    want = attn.plain_attention(q, k, v, causal=kw["causal"],
                                window=kw["window"], cap=kw["cap"])
    torch.cuda.synchronize()
    if not torch.allclose(got.float(), want.float(), **CHUNKED_TOL):
        raise AssertionError(f"chunked_attention layer 0: "
                             f"{max_abs_err(got, want):.3g} from "
                             f"plain_attention")
    log(f"  prefill of {LONG_PREFILL} positions without lengths in "
        f"{wall * 1e3:.1f} ms (host clock): logits finite, caches at "
        f"{caches.length.unique().tolist()}; layer 0's chunked_attention "
        f"q {tuple(q.shape)} within rtol = atol = 1e-2 of plain_attention "
        f"(max abs err {max_abs_err(got, want):.3g}) ({card})")


def time_moe_kernels(dev):
    """The KV-attention at the MoE path's geometry (D = 64, G = 3) over the
    lanes' cache (S = 96), logged beside the JSON line.  The expert
    stacks' decode is timed on the serve run's weights
    (``expert_decode_per_lane_step``)."""
    import torch
    from repro_torch.configs import CONFIGS
    from repro_torch.core.formats import get_format
    cfg = CONFIGS[MOE_ARCH]
    gen = torch.Generator().manual_seed(SEED + 8)
    KV, D = cfg.n_kv_heads, cfg.resolved_head_dim
    return [kv_attention_row(gen, get_format(name), 96, KV,
                             cfg.n_heads // KV, D, dev)
            for name in ("posit8", "posit16")]


def run_moe_serve(dev, counters, card):
    """Phase 5b: ``MOE_ARCH`` at full width behind ``ServingEngine`` with
    phase 5's serve setup; returns the timed row of the expert stacks'
    decode."""
    import gc
    import torch
    from repro_torch.configs import CONFIGS
    from repro_torch.core.formats import get_format
    from repro_torch.core.quant import quantize_params
    from repro_torch.kernels.counts import SERVE_PLAIN, PlainCalls
    cfg = CONFIGS[MOE_ARCH]
    per_pass = moe_decodes_per_pass(cfg)
    log(f"  predicted weight decodes: {per_pass} a lane-step or prefill "
        f"({cfg.n_layers} layers x (wq, wk, wv, wo + 3 expert stacks) + "
        f"the embedding rows + the unembedding)")
    torch.cuda.reset_peak_memory_stats()
    with PlainCalls(SERVE_PLAIN) as plain:
        (model, params, reqs, subs, comps, summary, wall, load, launches,
         captured, peak) = run_serve(dev, cfg, counters)
    by_rid = check_serve(cfg, subs, comps, summary, load, launches)
    for name, n in plain.calls.items():
        if n:
            raise AssertionError(f"{name} ran {n} times on CUDA tensors "
                                 f"while serving {MOE_ARCH}")
    lanes = [r for lane, r in summary.items() if lane != "fleet"]
    passes = sum(r["decode_steps"] + r["requests"] for r in lanes)
    if launches["posit_decode"] != per_pass * passes:
        raise AssertionError(f"posit_decode launched "
                             f"{launches['posit_decode']} times for "
                             f"{passes} lane-steps and prefills, not "
                             f"{per_pass} each")
    log(f"  launches at load (the weights' posit16 quantization, one "
        f"prefill): {load}")
    log(f"  {len(comps)} requests completed once each in {wall:.3f} s "
        f"(host clock), peak {peak:.1f} GiB allocated; launches on the "
        f"serve path: {launches}; weight decodes {per_pass} per lane-step "
        f"and prefill, as predicted; plain versions on CUDA tensors: 0")
    log_serve_ledger(summary, card)
    check_live_kv(captured)
    profile_serve(dev, model, params, reqs, by_rid, card)
    qparams = quantize_params(params, get_format("posit16"),
                              cast_rest=torch.bfloat16)
    row = expert_decode_per_lane_step(cfg, qparams, card)
    long_prefill(dev, model, qparams, card)
    del model, params, qparams
    gc.collect()
    torch.cuda.empty_cache()
    serve_reduced_on_card_and_cpu(dev, MOE_ARCH)
    return row


# ---------------------------------------------------------------------------
# Phases 5c-5f: the vlm, encdec, ssm and hybrid families at full width
# through the model API (prefill, then decode_step; ServingEngine refuses
# all four)
# ---------------------------------------------------------------------------

def api_launches(cfg):
    """(prefill, decode step): the serve wrappers' launches one prefill and
    one decode step of ``cfg`` make under posit16 weights and a posit KV
    cache, predicted from the model code.  A decoder pass decodes every
    posit weight it uses once, plus the embedding's gathered rows and the
    unembedding; an encdec prefill also runs the encoder, projects and
    encodes every decoder layer's cross K/V, dequantizes them in the BOS
    pass, and reads its self-attention cache whole there (S_new > 1 takes
    the plain route); each of its decode steps dequantizes the cross K/V
    again.  An ssm (xLSTM) pass decodes the six projections of every mLSTM
    block and the three weights of every sLSTM block (``w_h`` once a
    pass, not once a position) and has no KV cache; a hybrid (zamba) pass
    decodes in_proj and out_proj of every mamba layer and the shared
    block's seven weights at each of its calls, one a group, each of which
    appends to its group's KV cache and, in a decode step, attends through
    the KV-attention kernel."""
    L = cfg.n_layers
    if cfg.family == "ssm":
        per_pass = L // 8 * (7 * 6 + 3) + 2
        both = dict(posit_decode=per_pass, posit_encode=0,
                    posit_kv_append=0, posit_kv_attention=0)
        return both, dict(both)
    if cfg.family == "hybrid":
        groups = L // cfg.shared_attn_every
        per_pass = L * 2 + groups * 7 + 2
        return (dict(posit_decode=per_pass, posit_encode=0,
                     posit_kv_append=groups, posit_kv_attention=0),
                dict(posit_decode=per_pass, posit_encode=0,
                     posit_kv_append=groups, posit_kv_attention=groups))
    if cfg.family == "vlm":
        per_pass = L * 7 + 2      # wq, wk, wv, wo, w_gate, w_up, w_down
        return (dict(posit_decode=per_pass, posit_encode=0,
                     posit_kv_append=L, posit_kv_attention=0),
                dict(posit_decode=per_pass, posit_encode=0,
                     posit_kv_append=L, posit_kv_attention=L))
    dec = L * 8 + 2     # self wq, wk, wv, wo; cross wq, wo; w_up, w_down
    enc = cfg.enc_layers * 6      # wq, wk, wv, wo, w_up, w_down
    cross = 2 * L                 # the cross K and V of every layer
    return (dict(posit_decode=enc + cross + dec + cross + 2 * L,
                 posit_encode=cross, posit_kv_append=L,
                 posit_kv_attention=0),
            dict(posit_decode=dec + cross, posit_encode=0,
                 posit_kv_append=L, posit_kv_attention=L))


def api_batch(cfg, dev):
    """Phase 5c's, 5d's, 5e's or 5f's batch, from seeded generators (the
    frames and patch rows on the card), and the capacity given to
    prefill."""
    import numpy as np
    import torch
    rng = np.random.default_rng(SEED)
    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    if cfg.family in ("ssm", "hybrid"):
        toks = rng.integers(1, cfg.vocab, (API_BATCH, RECURRENT_PROMPT))
        return ({"tokens": torch.from_numpy(toks).to(dev)},
                RECURRENT_PROMPT + API_STEPS)
    if cfg.family == "vlm":
        toks = rng.integers(1, cfg.vocab, (API_BATCH, VLM_PROMPT))
        rows = ("frontend", (API_BATCH, cfg.frontend_len, cfg.d_model))
        capacity = VLM_PROMPT + API_STEPS     # prefill adds the patch rows
    else:
        toks = rng.integers(1, cfg.vocab, (API_BATCH, ENCDEC_BOS))
        rows = ("frames", (API_BATCH, ENCDEC_SRC, cfg.d_model))
        capacity = ENCDEC_BOS + API_STEPS
    return {"tokens": torch.from_numpy(toks).to(dev),
            rows[0]: torch.randn(rows[1], generator=gen, device=dev)}, \
        capacity


def api_generate(model, params, batch, capacity, counters, prof=None):
    """Greedy generation through the model API: one prefill, then
    ``API_STEPS`` decode steps, each fed the last step's argmax and ending
    on the host copy of its tokens (host clock).  With ``prof``, decode
    steps ``API_PROFILE`` run under the profiler, with the posit decodes
    they make and the bytes those read and write counted (``decoded``).
    Returns the tokens (B, steps + 1), the prefill's and each step's
    seconds, the launches of the prefill and of the decode steps, the
    profiled window's wall and decodes, and the final decode state."""
    import torch
    vocab = model.cfg.vocab
    tally = DecodeTally()

    def counts():
        return {c.__name__: c.launches for c in counters}
    torch.cuda.synchronize()
    for c in counters:
        c.launches = 0
    t0 = time.perf_counter()
    logits, state = model.prefill(params, batch, capacity)
    tok = logits[:, -1, :vocab].argmax(-1)
    toks = [tok.cpu()]
    out = dict(prefill_s=time.perf_counter() - t0, prefill=counts(),
               step_s=[], window_s=0.0)
    for c in counters:
        c.launches = 0
    try:
        for s in range(API_STEPS):
            if prof is not None and s == API_PROFILE[0]:
                tally.start()
                prof.start()
                tw = time.perf_counter()
            t0 = time.perf_counter()
            logits, state = model.decode_step(params, tok[:, None], state)
            tok = logits[:, -1, :vocab].argmax(-1)
            toks.append(tok.cpu())
            out["step_s"].append(time.perf_counter() - t0)
            if prof is not None and s == API_PROFILE[1] - 1:
                out["window_s"] = time.perf_counter() - tw
                prof.stop()
                tally.stop()
    finally:
        tally.stop()
    out.update(tokens=torch.stack(toks, 1), decode=counts(), state=state,
               decoded=tally)
    return out


def check_api_launches(got, want, what):
    for name, n in want.items():
        if got[name] != n:
            raise AssertionError(f"{what}: {name} launched {got[name]} "
                                 f"times, predicted {n}")
    other = {k: v for k, v in got.items() if k not in want and v}
    if other:
        raise AssertionError(f"{what}: other kernels launched: {other}")


def decode_ms_by_output(events, steps):
    """Device ms per step of the decode kernel's f32-output launches (in a
    decode step, the cross K/V's: the weights decode to bf16), from the
    ``key_averages`` of a profile of ``steps`` decode steps.  Raises if the profile holds none:
    the encdec lane launches 48 a step, so a miss means the kernel's
    name or template signature changed under this parse."""
    from torch.autograd import DeviceType
    us = [e.self_device_time_total for e in events
          if e.device_type == DeviceType.CUDA
          and "posit_decode_kernel<" in e.key
          and e.key.split("posit_decode_kernel<")[1].split(",")[1]
          .strip() == "float"]
    if not us:
        raise AssertionError("no f32-output posit_decode_kernel in the "
                             "profiled decode steps")
    return sum(us) / 1e3 / steps


def cross_kv_codec(cfg, cross, card):
    """The encdec lane's cross K/V on the card outside a step: the
    prefill's encodes of every layer's cross K and V (f32 in, as
    ``quantize`` gives them; here the stored values decoded back, whose
    encode does the same work), back to back, beside their byte bound
    (every value read and every pattern written once); and the device
    time and kernels of a decode step's whole cross-attention read of the
    posit cross K/V (dequantize, cast to bf16, ``plain_attention`` of one
    query row a layer), the work a kernel reading the posit bits would
    replace."""
    import torch
    from repro_torch.kernels.posit_codec import posit_encode
    from repro_torch.models import attention as attn
    fmt = cross[0][0].fmt
    q = torch.randn(API_BATCH, 1, cfg.n_heads, cfg.resolved_head_dim,
                    device=cross[0][0].bits.device).to(torch.bfloat16)

    def attend():
        for ck, cv in cross:
            attn.plain_attention(
                q, ck.dequant(torch.float32).to(q.dtype),
                cv.dequant(torch.float32).to(q.dtype), causal=False,
                window=attn.BIG_WINDOW, cap=0.0)
    read_ms, read_kernels = device_kernels(attend, reps=5)
    xs = [t.dequant(torch.float32) for pair in cross for t in pair]

    def encode_all():
        for x in xs:
            posit_encode(x, fmt)
    enc_ms = device_ms(encode_all, "posit_encode_kernel", reps=5)
    nbytes = sum(x.numel() * (4 + cross[0][0].bits.element_size())
                 for x in xs)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  cross K/V {fmt.name}: the prefill's {len(xs)} encodes of "
        f"{tuple(xs[0].shape)} {enc_ms:.3f} ms on the device against a "
        f"byte bound of {bound:.3f} ms ({nbytes / 1e9:.2f} GB; "
        f"{enc_ms / bound * 100:.1f} % of it); a decode step's whole "
        f"cross-attention read (dequantize, cast, plain_attention) "
        f"{read_ms:.3f} ms on the device in {read_kernels:g} kernels "
        f"({card})")


def run_model_api(dev, arch, counters, card):
    """Phase 5c, 5d, 5e or 5f: ``arch`` at full width on seeded weights
    (f32 init, then ``quantize_params`` to posit16), through prefill and
    ``API_STEPS`` greedy decode steps on two KV lanes (posit8, posit16;
    the ssm family has no KV cache, so one lane): the launches of the
    prefill and of every decode step as predicted (``api_launches``), no
    plain version called on a CUDA tensor, the greedy tokens reproduced by
    a second run (decode steps ``API_PROFILE`` of it under the profiler:
    the device's busy share and kernels per lane-step, every posit
    decode's device ms per lane-step beside its byte bound, and for encdec
    the cross K/V decode's device ms per step), host-clock ms per prefill
    and per decode step, tokens/s and card memory; for encdec the cross
    K/V codec timed beside its byte bound, for ssm the sLSTM's per-token
    loop at prefill, for hybrid the shared block's weight decodes; then
    the reduced config on the card against the CPU."""
    import gc
    import statistics as st
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.configs import CONFIGS
    from repro_torch.core.formats import get_format
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.core.quant import quantize_params
    from repro_torch.kernels.counts import SERVE_PLAIN, PlainCalls
    from repro_torch.models import build_model
    cfg = CONFIGS[arch]
    pre, step = api_launches(cfg)
    log(f"  predicted launches: prefill {pre}; each decode step {step}")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    raw = build_model(cfg, device=dev).init(
        torch.Generator(device=dev).manual_seed(SEED))
    for c in counters:
        c.launches = 0
    params = quantize_params(raw, get_format("posit16"),
                             cast_rest=torch.bfloat16)
    torch.cuda.synchronize()
    load = {c.__name__: c.launches for c in counters if c.launches}
    del raw
    gc.collect()
    torch.cuda.empty_cache()
    batch, capacity = api_batch(cfg, dev)
    log(f"  {cfg.name}: {cfg.n_layers} layers (+ {cfg.enc_layers} encoder"
        f"), d_model {cfg.d_model}, {cfg.n_heads} heads / {cfg.n_kv_heads} "
        f"KV of {cfg.resolved_head_dim}, vocab {cfg.padded_vocab}; f32 init"
        f" + posit16 quantization in {time.perf_counter() - t0:.1f} s "
        f"({load}), {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
        f"allocated; batch {({k: tuple(v.shape) for k, v in batch.items()})}"
        f", capacity {capacity}")
    n_prof = API_PROFILE[1] - API_PROFILE[0]
    lanes = (None,) if cfg.family == "ssm" else ("posit8", "posit16")
    for kv in lanes:
        model = build_model(cfg, QuantPolicy(weights="posit16",
                                             kv_cache=kv), device=dev)
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        with PlainCalls(SERVE_PLAIN) as plain:
            run = api_generate(model, params, batch, capacity, counters)
            del run["state"]
            again = api_generate(model, params, batch, capacity, counters,
                                 prof)
        for name, n in plain.calls.items():
            if n:
                raise AssertionError(f"{name} ran {n} times on CUDA tensors "
                                     f"in {arch} kv={kv}")
        for r in (run, again):
            check_api_launches(r["prefill"], pre, f"{arch} kv={kv} prefill")
            check_api_launches(r["decode"], {k: v * API_STEPS
                                             for k, v in step.items()},
                               f"{arch} kv={kv} {API_STEPS} decode steps")
        if not torch.equal(run["tokens"], again["tokens"]):
            raise AssertionError(f"{arch} kv={kv}: a second run gave other "
                                 f"greedy tokens")
        ms = [s * 1e3 for s in run["step_s"]]
        log(f"  {arch} kv={kv}: prefill {run['prefill_s'] * 1e3:.2f} ms "
            f"(second run {again['prefill_s'] * 1e3:.2f}); decode step "
            f"median {st.median(ms):.2f} ms (min {min(ms):.2f}, max "
            f"{max(ms):.2f}); {API_BATCH * API_STEPS / sum(run['step_s']):.1f}"
            f" tokens/s; launches as predicted in both runs; greedy tokens "
            f"{tuple(run['tokens'].shape)} reproduced by the second run; "
            f"plain versions on CUDA tensors: 0 ({card})")
        events = prof.key_averages()
        report_busy(events, again["window_s"], f"{arch} kv={kv}, decode "
                    f"steps {API_PROFILE[0]}-{API_PROFILE[1] - 1} of the "
                    f"second run under the profiler ({card})", 6)
        on_card = [e for e in events if e.device_type == DeviceType.CUDA]
        if on_card:
            log(f"  device kernels (kernels, copies, fills) per lane-step: "
                f"{sum(e.count for e in on_card) / n_prof:.1f} ({card})")
        log_decode_window(events, again["decoded"], n_prof, card)
        if cfg.family == "encdec":
            leaves = [t for pair in again["state"][1] for t in pair]
            nbytes = sum(t.bits.numel() * (t.bits.element_size() + 4)
                         for t in leaves)
            bound = nbytes / HBM_BYTES_PER_S * 1e3
            dec = decode_ms_by_output(events, n_prof)
            log(f"  cross K/V decode in that window: {dec:.3f} ms on the "
                f"device per step ({len(leaves)} launches of "
                f"{tuple(leaves[0].bits.shape)}, f32 out) against a byte "
                f"bound of {bound:.3f} ms ({nbytes / 1e9:.2f} GB; "
                f"{dec / bound * 100:.1f} % of it) ({card})")
            cross_kv_codec(cfg, again["state"][1], card)
        del run, again, prof, events, on_card
        gc.collect()
    if cfg.family == "ssm":
        slstm_prefill_loop(cfg, params, dev, card)
    if cfg.family == "hybrid":
        shared_block_decode(cfg, params, card)
    log(f"  card memory: peak {torch.cuda.max_memory_allocated() / 2 ** 30:.2f}"
        f" GiB allocated, {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB "
        f"held by the posit16 weights and batch ({card})")
    del params, batch
    gc.collect()
    torch.cuda.empty_cache()
    serve_reduced_on_card_and_cpu(dev, arch)


def slstm_prefill_loop(cfg, params, dev, card):
    """The sLSTM's per-token loop at a phase 5e prefill: one sLSTM block
    (group 0's posit16 weights) over ``API_BATCH`` rows of
    ``RECURRENT_PROMPT`` seeded bf16 positions, host clock (median of 3,
    each ending on a synchronize) and its device time and kernels per
    call, beside the block's share of a prefill (one block a group)."""
    import statistics as st
    import torch
    from repro_torch.models.common import tree_map
    from repro_torch.models.xlstm import slstm_forward
    cell = tree_map(lambda t: t[0], params["groups"]["slstm"]["cell"])
    gen = torch.Generator(device=dev).manual_seed(SEED + 11)
    x = torch.randn(API_BATCH, RECURRENT_PROMPT, cfg.d_model,
                    generator=gen, device=dev).to(torch.bfloat16)

    def once():
        slstm_forward(cell, x, cfg)
    once()
    walls = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        once()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    dev_ms, kernels = device_kernels(once, reps=1)
    log(f"  sLSTM block at prefill, {RECURRENT_PROMPT} positions one at a "
        f"time (the reference's lax.scan over time): "
        f"{st.median(walls):.2f} ms host clock (min {min(walls):.2f}), "
        f"{dev_ms:.3f} ms on the device in {kernels:g} kernels "
        f"({kernels / RECURRENT_PROMPT:.1f} a position); "
        f"{cfg.n_layers // 8} such blocks a prefill ({card})")


def shared_block_decode(cfg, params, card):
    """The hybrid's shared block decodes its seven posit16 weights at each
    of its calls, one a group: the time of one call's decodes (CUDA events
    around ten calls back to back, none kept; and its device time,
    ``device_ms`` with the call's launches), and of a pass's,
    beside their byte bound (every pattern read and every bf16 value
    written once); all but one call's are the same values decoded
    again."""
    from repro_torch.models.common import wval
    leaves = [p["w"] for p in (*params["shared"]["attn"].values(),
                               *params["shared"]["ffn"].values())
              if isinstance(p, dict)]

    def block():
        for leaf in leaves:
            wval(leaf)
    groups = cfg.n_layers // cfg.shared_attn_every
    ms = cuda_ms(block, reps=10, samples=5)
    dev_ms = device_ms(block, "posit_decode_kernel", reps=10,
                       launches=len(leaves))
    nbytes = sum(leaf.bits.numel() * (leaf.bits.element_size() + 2)
                 for leaf in leaves)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  shared block's weight decode: {len(leaves)} launches a call, "
        f"{ms:.3f} ms a call (CUDA events), {dev_ms:.3f} ms of it on the "
        f"device, against a byte bound of {bound:.3f} ms "
        f"({nbytes / 1e9:.2f} GB); {groups} calls a pass: {groups * ms:.3f} ms a lane-step, "
        f"{(groups - 1) * ms:.3f} ms of it decoding the same values again "
        f"({card})")


def check_api_kernels(dev, report):
    """Phase 2 at the vlm, encdec and hybrid paths' geometry: the
    KV-attention at internvl2-2b's heads (KV 8, G 2, D 128),
    seamless-m4t-large-v2's (KV 16, G 1, D 64) and zamba2-7b's shared
    attention (KV 32, G 1, D 112: lanes 28-31 of a warp hold no element of
    a row), posit8 and posit16, within 2e-5; the KV append at KV 16, D 64
    and at KV 32, D 112 in its three modes, bitwise; the encode and the
    f32 decode at the cross K/V shape (4, 2048, 16, 64), bitwise, on the
    values the path encodes (bf16 projections) and on random f32 with
    specials."""
    import torch
    from repro_torch.configs import CONFIGS
    from repro_torch.core.formats import get_format
    from repro_torch.kernels.posit_codec import (posit_decode,
                                                 posit_decode_torch,
                                                 posit_encode,
                                                 posit_encode_torch)
    from repro_torch.kernels.posit_kv_attention import query_groups
    gen = torch.Generator().manual_seed(SEED + 9)
    err = report["posit_kv_attention"].get("max_abs_err") or 0.0
    vlm, encdec = CONFIGS[VLM_ARCH], CONFIGS[ENCDEC_ARCH]
    hybrid = CONFIGS[HYBRID_ARCH]
    for cfg, sizes in (
            (vlm, (vlm.frontend_len + VLM_PROMPT + API_STEPS, 4096)),
            (encdec, (ENCDEC_BOS + API_STEPS, ENCDEC_SRC)),
            (hybrid, (RECURRENT_PROMPT + API_STEPS, 4096))):
        KV, D = cfg.n_kv_heads, cfg.resolved_head_dim
        G = cfg.n_heads // KV
        for name in ("posit8", "posit16"):
            for S in sizes:
                e = check_kv_attention(gen, get_format(name), S, KV, G, D,
                                       [1, S // 3, S - 1, S], dev)
                err = max(err, e)
                log(f"  posit_kv_attention {name} q (4, {KV}, {G}, {D}), K/V"
                    f" (4, {S}, {KV}, {D}) ({cfg.name}), query groups "
                    f"{query_groups(G, D)}: within 2e-5, max abs err "
                    f"{e:.3g}")
    report["posit_kv_attention"]["max_abs_err"] = err
    check_kv_append(dev, gen, report, hybrid.n_kv_heads,
                    hybrid.resolved_head_dim)
    KV, D = encdec.n_kv_heads, encdec.resolved_head_dim
    check_kv_append(dev, gen, report, KV, D)
    shape = (API_BATCH, ENCDEC_SRC, KV, D)
    n = API_BATCH * ENCDEC_SRC * KV * D
    for what, x in (
            ("bf16 projections",
             torch.randn(shape, generator=gen).to(torch.bfloat16).float()
             .to(dev)),
            ("random f32 with specials",
             random_f32(gen, n - 10, dev).reshape(shape))):
        for name in ("posit8", "posit16"):
            fmt = get_format(name)
            k = posit_encode(x, fmt)
            if not torch.equal(k, posit_encode_torch(x, fmt)):
                raise AssertionError(f"posit_encode cross K/V {shape} "
                                     f"{what} {name}: not bitwise")
            if not nan_aware_equal(posit_decode(k, fmt),
                                   posit_decode_torch(k, fmt)):
                raise AssertionError(f"posit_decode cross K/V {shape} "
                                     f"{what} {name} -> f32: not bitwise")
        log(f"  posit_encode and posit_decode (f32 out) at the cross K/V "
            f"shape {shape}, {what}, posit8 and posit16: bitwise")


def time_api_kernels(dev):
    """Phase 4 at the vlm, encdec, ssm and hybrid paths' geometry: the
    KV-attention over each path's full cache (internvl2-2b: 336 positions,
    KV 8, G 2, D 128; seamless: 32, KV 16, G 1, D 64; zamba2-7b: 528, KV
    32, G 1, D 112), the KV append of one decode step (seamless: KV 16, D
    64; zamba2-7b: KV 32, D 112; scalar lengths), the cross K/V codec at
    (4, 2048, 16, 64): the decode to f32 and the encode from f32, posit8
    and posit16; and the weight decode at zamba2-7b's and xlstm-1.3b's
    weight shapes (``recurrent_decode_rows``).  Returns the rows logged
    beside the JSON line's."""
    import torch
    from repro_torch.configs import CONFIGS
    from repro_torch.core.formats import get_format
    from repro_torch.kernels.posit_codec import (posit_decode,
                                                 posit_decode_torch,
                                                 posit_encode,
                                                 posit_encode_torch)
    gen = torch.Generator().manual_seed(SEED + 10)
    vlm, encdec = CONFIGS[VLM_ARCH], CONFIGS[ENCDEC_ARCH]
    hybrid = CONFIGS[HYBRID_ARCH]
    rows = []
    for cfg, S in ((vlm, vlm.frontend_len + VLM_PROMPT + API_STEPS),
                   (encdec, ENCDEC_BOS + API_STEPS),
                   (hybrid, RECURRENT_PROMPT + API_STEPS)):
        KV, D = cfg.n_kv_heads, cfg.resolved_head_dim
        for name in ("posit8", "posit16"):
            rows.append(kv_attention_row(gen, get_format(name), S, KV,
                                         cfg.n_heads // KV, D, dev))
    for name in ("posit8", "posit16"):
        rows.append(kv_append_row(
            dev, gen, get_format(name), RECURRENT_PROMPT + API_STEPS,
            hybrid.n_kv_heads, hybrid.resolved_head_dim,
            torch.tensor(RECURRENT_PROMPT + 8, dtype=torch.int32,
                         device=dev))[0])
    rows += recurrent_decode_rows(dev)
    KV, D = encdec.n_kv_heads, encdec.resolved_head_dim
    shape = (API_BATCH, ENCDEC_SRC, KV, D)
    x = torch.randn(shape, generator=gen).to(torch.bfloat16).float().to(dev)
    for name in ("posit8", "posit16"):
        fmt = get_format(name)
        rows.append(kv_append_row(
            dev, gen, fmt, ENCDEC_BOS + API_STEPS, KV, D,
            torch.tensor(20, dtype=torch.int32, device=dev))[0])
        bits = posit_encode(x, fmt)
        e = bits.element_size()
        rows.append(dict(
            name="posit_decode", shape=[*shape, f"{name}->f32", "cross K/V"],
            ms=cuda_ms(lambda: posit_decode(bits, fmt)),
            device_ms=device_ms(lambda: posit_decode(bits, fmt),
                                "posit_decode_kernel"),
            plain_ms=cuda_ms(lambda: posit_decode_torch(bits, fmt), reps=2,
                             samples=5),
            bound_ms=x.numel() * (e + 4) / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", library_ms=None))
        rows.append(dict(
            name="posit_encode", shape=[*shape, f"f32->{name}", "cross K/V"],
            ms=cuda_ms(lambda: posit_encode(x, fmt)),
            device_ms=device_ms(lambda: posit_encode(x, fmt),
                                "posit_encode_kernel"),
            plain_ms=cuda_ms(lambda: posit_encode_torch(x, fmt), reps=2,
                             samples=5),
            bound_ms=x.numel() * (4 + e) / HBM_BYTES_PER_S * 1e3,
            bound_by="bytes", library_ms=None))
    return rows


def recurrent_decode_rows(dev):
    """The weight decode (posit16 bits to bf16; ``w_h`` to f32, as the
    sLSTM reads it) at each weight shape of zamba2-7b (in_proj, out_proj,
    the shared block's three shapes, the unembedding) and xlstm-1.3b (the
    mLSTM's four shapes, the sLSTM's ``w_x``, ``w_h`` and ``w_out``, the
    unembedding), on random patterns; the plain version timed at the
    largest layer weight of each.  As on the path, where every weight is
    read from device memory, each shape is decoded from distinct buffers
    back to back, none kept, enough of them that their bits fill
    ``COLD_BYTES`` (a small weight would otherwise be read from the L2)."""
    import torch
    from repro_torch.core.formats import get_format
    from repro_torch.kernels.posit_codec import (posit_decode,
                                                 posit_decode_torch)
    fmt = get_format("posit16")
    bf16, f32 = torch.bfloat16, torch.float32
    rows = []
    for arch, shape, out_dtype, plain in (
            (HYBRID_ARCH, (3584, 14576), bf16, True),
            (HYBRID_ARCH, (7168, 3584), bf16, False),
            (HYBRID_ARCH, (3584, 3584), bf16, False),
            (HYBRID_ARCH, (3584, 14336), bf16, False),
            (HYBRID_ARCH, (14336, 3584), bf16, False),
            (HYBRID_ARCH, (32000, 3584), bf16, False),
            (SSM_ARCH, (2048, 4096), bf16, False),
            (SSM_ARCH, (4096, 4096), bf16, True),
            (SSM_ARCH, (4096, 2048), bf16, False),
            (SSM_ARCH, (2048, 8192), bf16, False),
            (SSM_ARCH, (4, 512, 2048), f32, False),
            (SSM_ARCH, (2048, 2048), bf16, False),
            (SSM_ARCH, (50304, 2048), bf16, False)):
        n = -(-COLD_BYTES // (2 * math.prod(shape)))
        bufs = [torch.randint(-(1 << 15), 1 << 15, shape, device=dev,
                              dtype=torch.int32).to(torch.int16)
                for _ in range(n)]
        out_size = 2 if out_dtype == bf16 else 4

        def cold():
            for b in bufs:
                posit_decode(b, fmt, out_dtype)
        plain_ms = None
        if plain:
            plain_ms = cuda_ms(
                lambda: posit_decode_torch(bufs[0], fmt, out_dtype),
                reps=2, samples=5)
        rows.append(dict(
            name="posit_decode",
            shape=[*shape, f"int16->{str(out_dtype)[6:]}", arch,
                   f"{n} buffers"],
            ms=cuda_ms(cold, reps=max(1, 10 // n)) / n,
            device_ms=device_ms(cold, "posit_decode_kernel",
                                reps=max(2, 50 // n), launches=n) / n,
            plain_ms=plain_ms,
            bound_ms=bufs[0].numel() * (2 + out_size) / HBM_BYTES_PER_S
            * 1e3,
            bound_by="bytes", library_ms=None))
        del bufs
    return rows


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
            floor_device_ms=floor_dev,
            earlier_plan_ms=cuda_ms(lambda: earlier_matmul_round(a, b,
                                                                 fmt)),
            earlier_plan_device_ms=device_ms(
                lambda: earlier_matmul_round(a, b, fmt),
                ("posit_matmul_round_kernel",
                 "posit_matmul_round_combine_kernel")))
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


def check_kmeans(dev, reservoirs: int = 16):
    """The tracker's 2-means at the main path's shape (``reservoirs``
    seeded reservoirs of 500 of the tracker's scores, posit10 and posit16,
    cold and warm started, 12 iterations): ``kmeans_1d``'s one
    ``posit_kmeans_1d`` launch bitwise its plain version, the per-op path
    (fused off), on the same card tensor; fails on any differing bit."""
    import numpy as np
    import torch
    from repro_torch.apps.bayeslope import KMEANS_ITERS, RESERVOIR_SIZE
    from repro_torch.apps.kmeans import kmeans_1d
    from repro_torch.core.arith import Arith, backend_overrides
    from repro_torch.kernels.counts import launch_counts
    rng = np.random.default_rng(SEED + 12)
    calls = parted = 0
    before = launch_counts()["posit_kmeans_1d"]
    for name in ("posit10", "posit16"):
        ar = Arith.make(name)
        for r in range(reservoirs):
            res = rng.uniform(0.2689, 1.0, RESERVOIR_SIZE)
            res[rng.random(RESERVOIR_SIZE) < 0.1] = 0.0
            x = torch.from_numpy(res.astype(np.float32)).to(dev)
            for init in (None, np.sort(rng.uniform(0.2689, 1.0, 2))
                         .astype(np.float32)):
                got = kmeans_1d(ar, x, iters=KMEANS_ITERS, init=init)
                with backend_overrides(fused="off"):
                    want = kmeans_1d(ar, x, iters=KMEANS_ITERS, init=init)
                g = got.cpu().view(torch.int32)
                w = want.cpu().view(torch.int32)
                calls += 1
                parted += int((g != w).sum())
    launches = launch_counts()["posit_kmeans_1d"] - before
    log(f"  posit_kmeans_1d: {calls} 2-means of {RESERVOIR_SIZE} scores "
        f"(posit10, posit16; cold, warm; {KMEANS_ITERS} iterations) in "
        f"{launches} launches, {parted} centroids differ from the per-op "
        f"path")
    if launches != calls:
        raise AssertionError(f"posit_kmeans_1d: {launches} launches for "
                             f"{calls} calls")
    if parted:
        raise AssertionError(f"posit_kmeans_1d: {parted} centroids not "
                             f"bitwise the per-op path's")


def time_kmeans(dev, updates: int = 2000):
    """The R-peak tracker's 2-means at a full reservoir (500 posit10
    scores, warm-started) through ``kmeans_1d``: its one ``posit_kmeans_1d``
    launch beside the per-op path (fused off), each per call (CUDA events,
    the reservoir on the card), on the device (every kernel, copy and fill
    of a profiled window) with device kernels and wrapper launches a call,
    and a whole tracker update (``threshold_update``: the reservoir's copy
    in, the 2-means, the centroids' copy out) on the host clock over
    ``updates`` calls.  Returns the kernel's row, its plain version the
    per-op path, logged beside the JSON line's."""
    import numpy as np
    import torch
    from repro_torch.apps.bayeslope import RESERVOIR_SIZE, threshold_update
    from repro_torch.apps.kmeans import kmeans_1d
    from repro_torch.core.arith import Arith, backend_overrides
    from repro_torch.kernels.counts import launch_counts
    ar = Arith.make("posit10")
    rng = np.random.default_rng(SEED + 11)
    res = rng.uniform(0.2689, 1.0, RESERVOIR_SIZE).astype(np.float32)
    init = np.array([0.35, 0.9], np.float32)
    x = torch.from_numpy(res).to(dev)
    arms = {}
    for arm, fused in (("kernel", "on"), ("per-op", "off")):
        with backend_overrides(fused=fused):
            def fn():
                return kmeans_1d(ar, x, init=init)
            fn()
            torch.cuda.synchronize()
            before = launch_counts()
            fn()
            after = launch_counts()
            dev_ms, kernels = device_kernels(fn)
            for _ in range(20):
                threshold_update(ar, res, init=init, device=dev)
            t0 = time.perf_counter()
            for _ in range(updates):
                threshold_update(ar, res, init=init, device=dev)
            arms[arm] = dict(
                ms=cuda_ms(fn), device_ms=dev_ms, device_kernels=kernels,
                launches={k: after[k] - before[k] for k in after
                          if after[k] != before[k]},
                update_ms=(time.perf_counter() - t0) / updates * 1e3)
        log(f"  kmeans_1d {arm} [{RESERVOIR_SIZE}, posit10, warm]: "
            f"{arms[arm]['ms']:.4f} ms per call, {dev_ms:.4f} ms and "
            f"{kernels:g} device kernels (copies and fills included) on the "
            f"device, launches {arms[arm]['launches']}; a tracker update "
            f"{arms[arm]['update_ms']:.4f} ms on the host clock")
    row = dict(
        name="posit_kmeans_1d", shape=[RESERVOIR_SIZE, "posit10", "warm"],
        ms=arms["kernel"]["ms"],
        device_ms=device_ms(lambda: kmeans_1d(ar, x, init=init),
                            "posit_kmeans_1d_kernel"),
        device_kernels=arms["kernel"]["device_kernels"],
        plain_ms=arms["per-op"]["ms"],
        bound_ms=(RESERVOIR_SIZE + 2) * 4 / HBM_BYTES_PER_S * 1e3,
        bound_by="bytes", library_ms=None, arms=arms)
    return row


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


def kv_append_row(dev, gen, fmt, cap, KV, D, length):
    """One timed row of the KV append, and the call's arguments: one
    decode step's write of B = 4 bf16 rows of (``KV``, ``D``) into a
    ``cap``-position posit cache at ``length`` (per-row or scalar): per
    call (CUDA events), the append kernel's device time, and the device
    time and kernels per call of every kernel of the call (``all_ms``,
    ``device_kernels``)."""
    import torch
    from repro_torch.kernels.posit_codec import (posit_kv_append,
                                                 posit_kv_append_torch)
    B = 4
    k_bits, v_bits = (torch.zeros(B, cap, KV, D, dtype=fmt.storage_dtype,
                                  device=dev) for _ in range(2))
    k_new, v_new = (torch.randn(B, 1, KV, D, generator=gen)
                    .to(torch.bfloat16).to(dev) for _ in range(2))
    args = (k_new, v_new, k_bits, v_bits, length, fmt)
    nbytes = (2 * k_new.numel() * (2 + k_bits.element_size())
              + length.numel() * 4)
    all_ms, kernels = device_kernels(lambda: posit_kv_append(*args))
    return dict(
        name="posit_kv_append", shape=[B, 1, KV, D, f"bf16->{fmt.name}"],
        ms=cuda_ms(lambda: posit_kv_append(*args)),
        device_ms=device_ms(lambda: posit_kv_append(*args),
                            "posit_kv_append_kernel"),
        all_ms=all_ms, device_kernels=kernels,
        plain_ms=cuda_ms(lambda: posit_kv_append_torch(*args)),
        bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
        library_ms=None), args


def time_kv_append(dev, gen, report):
    """The KV append at one layer's decode write on the serve path (B = 4
    slots, KV = 8, D = 128, bf16 rows, per-row lengths, a 96-position
    cache), posit8 and posit16, beside the earlier route, each with its
    device kernels per call (``kv_append_row``).  Returns the rows logged
    beside the JSON line's."""
    import torch
    from repro_torch.core.formats import get_format
    rows = []
    length = torch.tensor([10, 50, 94, 95], dtype=torch.int32, device=dev)
    for name in ("posit8", "posit16"):
        row, args = kv_append_row(dev, gen, get_format(name), 96, 8, 128,
                                  length)
        e_ms, e_kernels = device_kernels(lambda: earlier_kv_append(*args))
        earlier = dict(
            name="earlier_kv_append", shape=row["shape"],
            ms=cuda_ms(lambda: earlier_kv_append(*args)), device_ms=e_ms,
            device_kernels=e_kernels, plain_ms=None,
            bound_ms=row["bound_ms"], bound_by="bytes", library_ms=None)
        log(f"  KV write {name}: the append kernel {row['ms']:.4f} ms per "
            f"call, {row['device_ms']:.4f} ms on the device "
            f"({row['all_ms']:.4f} ms and {row['device_kernels']:g} "
            f"kernels of every device event per call); the earlier route "
            f"{earlier['ms']:.4f} ms per call, {e_ms:.4f} ms and "
            f"{e_kernels:g} kernels on the device")
        if name == "posit8":            # the posit8 lane's cache
            report["posit_kv_append"].update(row)
        else:
            rows.append(row)
        rows.append(earlier)
    return rows


def time_serve_kernels(dev, report):
    """The serve kernels at serve-path shapes: decode and encode of one
    (4096, 12288) FFN weight, the KV append of one layer, and the
    KV-attention at the lanes' cache (S = 96) and at S = 32768.  Returns
    the rows that are logged beside the JSON line's."""
    import torch
    from repro_torch.core.formats import get_format
    from repro_torch.kernels.posit_codec import (posit_decode,
                                                 posit_decode_torch,
                                                 posit_encode,
                                                 posit_encode_torch)
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
        row = kv_attention_row(gen, get_format(name), S, 8, 4, 128, dev)
        if (name, S) == ("posit8", 96):     # the posit8 lane's cache
            report["posit_kv_attention"].update(row)
        else:
            rows.append(row)
    return rows


def kv_attention_row(gen, fmt, S, KV, G, D, dev):
    """One timed row of the KV-attention: q (4, KV, G, D), posit K/V (4, S,
    KV, D) at full length.  Its library time is
    ``scaled_dot_product_attention`` on K/V already decoded to f32 (the
    decode not counted)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.posit_codec import posit_decode
    from repro_torch.kernels.posit_kv_attention import (
        posit_kv_attention, posit_kv_attention_torch)
    q, kb, vb = kv_case(gen, 4, S, KV, G, D, fmt, dev)
    B = q.shape[0]
    lengths = torch.full((B,), S, dtype=torch.int32, device=dev)
    nbytes = (2 * q.numel() * 4 + 2 * kb.numel() * kb.element_size()
              + lengths.numel() * 4)
    flops = 4 * B * KV * G * S * D
    kf = posit_decode(kb, fmt).transpose(1, 2)      # (B, KV, S, D)
    vf = posit_decode(vb, fmt).transpose(1, 2)
    mask = (torch.arange(S, device=dev)[None, :]
            < lengths[:, None])[:, None, None, :]
    slow = dict(reps=2, samples=5) if S > 1024 else {}
    return dict(
        name="posit_kv_attention", shape=[B, S, KV, D, G, fmt.name],
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


# ---------------------------------------------------------------------------
# Phase 7: the ingest fleet over TCP and the observability plane
# ---------------------------------------------------------------------------

def ingest_fleet():
    """The reference suite's TCP acceptance fleet
    (tests/test_ingest.py:327-339):
    64 patients, 2 windows each, duplicated and deferred frames, and
    ``INGEST_STALLED`` silent after its first frame."""
    from repro_torch.ingest import FleetSimulator
    return FleetSimulator(n_patients=N_PATIENTS, windows=INGEST_WINDOWS,
                          seed=SEED, mixed=True, dup_rate=0.05,
                          defer_rate=0.05, stall_after={INGEST_STALLED: 1})


def timed_dispatch(engine):
    """Record the host wall of each of ``engine``'s batch dispatches (each
    ends on its outputs' host copy)."""
    walls = []
    real = engine._dispatch

    def dispatch(*a, **kw):
        t0 = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            walls.append(time.perf_counter() - t0)
    engine._dispatch = dispatch
    return walls


def ingest_engine(pipelines, dev, **kw):
    from repro_torch.stream import StreamEngine
    return StreamEngine(pipelines, max_batch=INGEST_MAX_BATCH,
                        pad_policy="max", result_capacity=None, device=dev,
                        **kw)


async def serve_fleet_tcp(engine, sim, sup, stall_timeout_s):
    """Serve ``sim`` over localhost TCP until every session is closed (BYE
    or stall eviction), the supervisor draining beside it; then scrape
    ``/metrics`` and ``/telemetry`` over HTTP.  Returns the scraped page,
    the telemetry document and the host-clock times at which the clients
    finished sending, every live session closed and every session
    closed."""
    import asyncio
    import json as _json
    from repro_torch.ingest import IngestServer, SessionManager
    from repro_torch.obs import http_get
    sm = SessionManager(engine, stall_timeout_s=stall_timeout_s)
    sim.pin_all(engine)
    marks = {"start": time.perf_counter()}
    async with IngestServer(sm, host="127.0.0.1", port=0, supervisor=sup,
                            scrape_port=0) as srv:
        done = [False]
        pump = asyncio.ensure_future(sup.run_async(0.005,
                                                   stop=lambda: done[0]))
        await sim.run_tcp("127.0.0.1", srv.port)
        marks["sent"] = time.perf_counter()
        deadline = time.perf_counter() + 120.0
        while not sm.all_closed():
            if "live_closed" not in marks and all(
                    s.closed for s in sm.sessions.values()
                    if s.patient != INGEST_STALLED):
                marks["live_closed"] = time.perf_counter()
            if time.perf_counter() > deadline:
                raise AssertionError(f"ingest sessions never closed: "
                                     f"{sm.open_sessions()}")
            await asyncio.sleep(0.01)
        marks["closed"] = time.perf_counter()
        marks.setdefault("live_closed", marks["closed"])
        done[0] = True
        await pump
        page = await http_get("127.0.0.1", srv.scrape_port, "/metrics")
        tele = _json.loads(await http_get("127.0.0.1", srv.scrape_port,
                                          "/telemetry"))
    return page, tele, marks


def run_ingest(dev, forest, counters):
    """Phase 7: the fleet in process on one engine, then over TCP on a
    fresh engine with a supervisor, the scrape plane and a tracer.  The
    launch counts are read over the TCP run alone."""
    import asyncio
    from repro_torch.ingest import Supervisor
    from repro_torch.kernels.counts import PlainCalls
    from repro_torch.obs import MetricsRegistry, Tracer
    from repro_torch.stream import cough_pipeline, rpeak_pipeline
    pipelines = {"cough": cough_pipeline(forest), "rpeak": rpeak_pipeline()}
    out = {}
    with PlainCalls() as plain:
        ref = ingest_engine(pipelines, dev)
        walls = timed_dispatch(ref)
        t0 = time.perf_counter()
        ingest_fleet().run_inproc(ref)
        out["inproc_s"] = time.perf_counter() - t0
        out["longest_dispatch_s"] = max(walls)
        out["stall_timeout_s"] = max(1.0, 5.0 * max(walls))
        out["plain_inproc"] = dict(plain.calls)
        for k in plain.calls:
            plain.calls[k] = 0
        tracer = Tracer(capacity=1 << 20)
        eng = ingest_engine(pipelines, dev, metrics=MetricsRegistry(),
                            tracer=tracer)
        sup = Supervisor(eng, capacity=8192)
        sim = ingest_fleet()
        for c in counters:
            c.launches = 0
        page, tele, marks = asyncio.run(serve_fleet_tcp(
            eng, sim, sup, out["stall_timeout_s"]))
        out["launches"] = {c.__name__: c.launches for c in counters}
        out["plain_tcp"] = dict(plain.calls)
    out.update(ref=ref, eng=eng, sup=sup, sim=sim, page=page, tele=tele,
               marks=marks, tracer=tracer)
    return out


def check_ingest(run, dev, card):
    """Phase 7's asserts: the TCP run bitwise equal to the in-process run
    for every delivered window, the stalled patient evicted with exactly
    its delivered prefix, no window dropped, the stream kernels launched
    and no plain version called on the card, the scraped page reconciling
    exactly with the ledger, the transport column and the supervisor's
    telemetry, a valid Chrome trace; then the rates and latencies."""
    import numpy as np
    from repro_torch.apps.bayeslope import detect_rpeaks
    from repro_torch.core.arith import Arith
    from repro_torch.data.biosignals import ECG_FS
    from repro_torch.obs import parse_prometheus, validate_chrome_trace
    from repro_torch.stream.pipelines import RPEAK_WINDOW_S
    ref, eng, sup, sim = run["ref"], run["eng"], run["sup"], run["sim"]
    if eng.drain() != 0:
        raise AssertionError("windows were still pending after every "
                             "ingest session closed")
    sup.poll()
    ts = eng.ledger.transport_summary()
    fleet = ts["fleet"]
    if not (fleet["dup_frames"] > 0 and fleet["reordered_frames"] > 0):
        raise AssertionError(f"no fault reached the sessions: {fleet}")
    if fleet["evictions"] != 1 or ts[INGEST_STALLED]["evictions"] != 1:
        raise AssertionError(f"evictions {fleet['evictions']} (want 1, "
                             f"{INGEST_STALLED})")
    if fleet["windows_dropped"] != 0:
        raise AssertionError(f"{fleet['windows_dropped']} windows dropped "
                             f"at a close: a dispatch failed")
    for name, n in {**run["plain_inproc"], **run["plain_tcp"]}.items():
        if n:
            raise AssertionError(f"{name} ran {n} times on CUDA tensors")
    launches = run["launches"]
    for name in ("posit_round", "posit_fft_stages", "posit_matmul_round",
                 "posit_kmeans_1d"):
        if launches[name] <= 0:
            raise AssertionError(f"{name} never launched on the TCP run")
    if launches["posit_butterfly"] != 0:
        raise AssertionError(f"posit_butterfly launched "
                             f"{launches['posit_butterfly']} times on the "
                             f"TCP run")
    # the page was scraped once every session had closed and the
    # supervisor had drained: nothing has moved since
    got = parse_prometheus(run["page"])
    for group, row in eng.ledger.summary().items():
        for k, v in row.items():
            if got[(f"stream_{k}", (("group", group),))] != float(v):
                raise AssertionError(f"/metrics stream_{k}{{{group}}} "
                                     f"differs from the ledger")
    for patient, cols in ts.items():
        for field, v in cols.items():
            key = ("ingest_transport", (("counter", field),
                                        ("patient", patient)))
            if got[key] != float(v):
                raise AssertionError(f"/metrics ingest_transport "
                                     f"{patient}/{field} differs")
    tele = sup.telemetry()
    windows = {dict(labels)["patient"]: v for (name, labels), v in got.items()
               if name == "stream_windows_total"}
    if not (got[("result_queue_depth", ())] == tele["queue"]["depth"]
            and sum(windows.values()) == tele["queue"]["total_windows"]
            == run["tele"]["queue"]["total_windows"]
            and all(row["windows"] == windows[pid]
                    for pid, row in tele["patients"].items())):
        raise AssertionError("/metrics does not reconcile with the "
                             "supervisor's telemetry")
    ref_rows = {(r.patient, r.task, r.widx): r for r in ref.pop_results()}
    n_checked = n_stalled = 0
    for r in sup.pop():
        want = ref_rows[(r.patient, r.task, r.widx)]
        if r.fmt != want.fmt or set(r.outputs) != set(want.outputs):
            raise AssertionError(f"{r.patient} w{r.widx}: {r.fmt} "
                                 f"{sorted(r.outputs)} over TCP, "
                                 f"{want.fmt} {sorted(want.outputs)} in "
                                 f"process")
        for k, v in r.outputs.items():
            if not np.array_equal(np.asarray(v), np.asarray(want.outputs[k]),
                                  equal_nan=True):
                raise AssertionError(f"{r.patient} w{r.widx} {k}: TCP "
                                     f"differs from the in-process run")
        n_checked += 1
        n_stalled += r.patient == INGEST_STALLED
    plan = next(p for p in sim.plans if p.patient == INGEST_STALLED)
    prefix = np.concatenate([c[0] for c in plan.chunks["ecg"][:1]])
    w = int(round(RPEAK_WINDOW_S * ECG_FS))     # samples per R-peak window
    if n_stalled != len(prefix) // w or \
            n_checked != (N_PATIENTS - 1) * INGEST_WINDOWS + n_stalled \
            or n_checked != tele["queue"]["total_windows"]:
        raise AssertionError(f"{n_checked} windows over TCP, {n_stalled} of "
                             f"{INGEST_STALLED}'s; its delivered prefix "
                             f"holds {len(prefix) // w}")
    for p in sim.plans:
        if p.task == "rpeak" and p.patient != INGEST_STALLED:
            if eng.tracker_for(p.patient, "rpeak").peaks != \
                    ref.tracker_for(p.patient, "rpeak").peaks:
                raise AssertionError(f"{p.patient}: R-peaks over TCP differ")
    tr31 = eng.tracker_for(INGEST_STALLED, "rpeak")
    got31 = tr31.peaks if tr31 is not None else []
    n = (len(prefix) // w) * w
    want31 = (detect_rpeaks(Arith.make(sim.pins.get(INGEST_STALLED,
                                                    "posit10")),
                            prefix[:n], device=dev) if n else [])
    if got31 != want31:
        raise AssertionError(f"{INGEST_STALLED}'s evicted prefix: peaks "
                             f"{got31}, offline {want31}")

    events = validate_chrome_trace(run["tracer"].chrome_trace())
    cats = {e["cat"] for e in events}
    if not {"frame", "session", "stage", "dispatch", "drain"} <= cats:
        raise AssertionError(f"trace categories {sorted(cats)}")

    marks = run["marks"]
    live_s = marks["live_closed"] - marks["start"]
    log(f"  fleet in process: {N_PATIENTS * INGEST_WINDOWS} windows in "
        f"{ref.ledger.summary()['fleet']['batches']} batches, "
        f"{run['inproc_s']:.3f} s "
        f"({N_PATIENTS * INGEST_WINDOWS / run['inproc_s']:.1f} windows/s, "
        f"host clock); longest dispatch {run['longest_dispatch_s']:.4f} s, "
        f"stall timeout {run['stall_timeout_s']:.3f} s ({card})")
    log(f"  fleet over TCP: {n_checked} windows in "
        f"{eng.ledger.summary()['fleet']['batches']} batches; every live "
        f"session closed "
        f"{live_s:.3f} s after the start ({n_checked / live_s:.1f} "
        f"windows/s, host clock), the stalled one evicted at "
        f"{marks['closed'] - marks['start']:.3f} s; e2e latency ms "
        f"{tele['latency_ms']} ({card})")
    log(f"  transport: {fleet}")
    stream = {k: launches[k] for k in ("posit_round", "posit_fft_stages",
                                       "posit_matmul_round",
                                       "posit_kmeans_1d",
                                       "posit_butterfly")}
    log(f"  launches on the TCP run: {stream}; plain versions on CUDA "
        f"tensors: 0; /metrics "
        f"{len(got)} series reconcile; trace {len(events)} events, "
        f"{run['tracer'].dropped} dropped, categories {sorted(cats)}")
    return run["launches"]


# ---------------------------------------------------------------------------
# Phase 8: the ingest worker pool on the card
# ---------------------------------------------------------------------------

def pool_reference(sim, pipelines, dev):
    """``sim`` in process on one engine on the card, as the pool's workers
    build theirs (``max_batch`` 16, ``pad_policy="max"``): (ledger
    summary, per-patient digests, seconds of host clock)."""
    from repro_torch.ingest import Supervisor
    from repro_torch.ingest.workers import _result_digests
    eng = ingest_engine(pipelines, dev)
    t0 = time.perf_counter()
    sim.run_inproc(eng)
    wall = time.perf_counter() - t0
    sup = Supervisor(eng, capacity=1 << 16)
    sup.poll()
    return eng.ledger.summary(), _result_digests(sup), wall


class CardMemory:
    """Samples, while entered, the card's used memory as this process's
    context sees it (``torch.cuda.mem_get_info``) every 0.2 s; the rise to
    its peak is the workers' (this process allocates nothing meanwhile).
    ``nvidia-smi`` cannot split it by process here: in this container it
    lists every process under one pid."""

    def __init__(self):
        import threading
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self.base = self.peak = 0

    def _used(self):
        import torch
        free, total = torch.cuda.mem_get_info()
        return total - free

    def _run(self):
        while not self._stop.wait(0.2):
            self.peak = max(self.peak, self._used())

    def __enter__(self):
        self.base = self.peak = self._used()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(timeout=30)

    def describe(self, n_workers):
        per = (self.peak - self.base) / n_workers / 2 ** 20
        return (f"the card's used memory rose by {per:.0f} MiB per worker "
                f"at its peak (its CUDA context, libraries, decode tables "
                f"and tensors)")


def check_pool_kernel_calls(doc, kernels, what):
    """Each worker's launch counts show ``kernels`` launched and the
    butterfly not.  (A worker that calls a stream kernel's plain version on
    a CUDA tensor fails there: ``refuse_plain_on_card``.)"""
    for w in doc["workers"]:
        calls = w["kernel_calls"]
        for name in kernels:
            if calls[name] <= 0:
                raise AssertionError(f"{what}: worker {w['worker_id']} never "
                                     f"launched {name}")
        if calls["posit_butterfly"] != 0:
            raise AssertionError(f"{what}: worker {w['worker_id']} launched "
                                 f"the butterfly")


def run_pool(dev, forest, card):
    """Phase 8: (a) the reference suite's chaos acceptance run
    (tests/test_chaos.py:339-368) on the card, every digest equal to the
    in-process card run; (b) phase 7's mixed 64-patient fleet, fault-free,
    through the pool, its ledger and digests equal to the in-process run."""
    import shutil
    from repro_torch.distributed import RestartPolicy
    from repro_torch.ingest import ChaosPlan, FleetSimulator, run_worker_fleet
    from repro_torch.stream import cough_pipeline, rpeak_pipeline

    # (a) 64 ECG patients, worker 0 SIGKILLed, one partitioned, one corrupt
    sim = FleetSimulator(n_patients=N_PATIENTS, windows=INGEST_WINDOWS,
                         seed=SEED, mixed=False, n_cough=0)
    _, want, _ = pool_reference(sim, {"rpeak": rpeak_pipeline()}, dev)
    spill = ROOT / "build" / "pool_spill"
    shutil.rmtree(spill, ignore_errors=True)
    spill.mkdir(parents=True)
    ecg = [p.patient for p in sim.plans]
    with CardMemory() as mem:
        doc = run_worker_fleet(
            sim, POOL_WORKERS, max_batch=INGEST_MAX_BATCH,
            realtime_factor=POOL_REALTIME, stall_timeout_s=POOL_STALL_S,
            auth_secret="s3cret", spill_dir=str(spill),
            chaos=ChaosPlan(kill_worker=0, kill_after_s=0.4,
                            partition_patients=(ecg[-1],),
                            partition_after_frames=2,
                            corrupt_patients=(ecg[-2],), corrupt_at_frame=1),
            restart_policy=RestartPolicy(max_restarts=3, backoff_s=0.05))
    rec = doc["recovery"]
    if doc["failed_workers"] or doc["windows"] != sim.expected_windows() \
            or rec["worker_restarts"] < 1 or not rec["recovery_s"] \
            or rec["client"]["partitions"] < 1 \
            or rec["client"]["corrupted_frames"] < 1:
        raise AssertionError(f"chaos pool: failed {doc['failed_workers']}, "
                             f"{doc['windows']} windows, recovery {rec}")
    bad = [p for p, d in want.items() if doc["digests"].get(p) != d]
    if bad or set(doc["digests"]) != set(want):
        raise AssertionError(f"chaos pool: digests differ from the "
                             f"in-process card run for {bad}")
    check_pool_kernel_calls(doc, ("posit_round", "posit_kmeans_1d"),
                            "chaos pool")
    log(f"  chaos pool: {doc['windows']} windows through {POOL_WORKERS} "
        f"workers on the card, worker 0 SIGKILLed 0.4 s after its ready, "
        f"{ecg[-1]} partitioned, {ecg[-2]} corrupted: every digest equal "
        f"to the in-process card run; {rec['worker_restarts']} restart(s), "
        f"recovery {[round(x, 3) for x in rec['recovery_s']]} s, replayed "
        f"frames {doc['transport']['fleet'].get('replayed_frames', 0)}, "
        f"client {rec['client']}; wall {doc['wall_s']:.3f} s ({card})")
    log(f"  chaos pool memory: {mem.describe(POOL_WORKERS)} ({card})")
    shutil.rmtree(spill, ignore_errors=True)

    # (b) the mixed fleet, fault-free; (c) the same through workers whose
    # dispatch is sharded over POOL_SLABS data slabs of the card
    sim = FleetSimulator(n_patients=N_PATIENTS, windows=INGEST_WINDOWS,
                         seed=SEED, mixed=True)
    summary, want, wall_in = pool_reference(
        sim, {"cough": cough_pipeline(forest), "rpeak": rpeak_pipeline()},
        dev)
    for devices, what in ((0, "mixed pool"),
                          (POOL_SLABS, f"mixed pool, devices={POOL_SLABS}")):
        with CardMemory() as mem:
            doc = run_worker_fleet(sim, POOL_WORKERS,
                                   max_batch=INGEST_MAX_BATCH,
                                   stall_timeout_s=POOL_STALL_S,
                                   devices=devices)
        check_pool_fleet(doc, summary, want, what)
        slabs = [w["devices"] for w in doc["workers"]]
        if slabs != [max(devices, 1)] * POOL_WORKERS:
            raise AssertionError(f"{what}: workers report {slabs} data "
                                 f"slabs")
        n = summary["fleet"]["windows"]
        log(f"  {what}: {n} windows through {POOL_WORKERS} workers "
            f"({slabs} data slabs each), every digest and the ledger's "
            f"windows and total nJ ({summary['fleet']['total_nj']!r}) equal "
            f"to the in-process card run; {n / doc['wall_s']:.1f} windows/s "
            f"over the pool ({doc['wall_s']:.3f} s from every worker's "
            f"ready), {n / wall_in:.1f} windows/s in process "
            f"({wall_in:.3f} s) (host clock, {card})")
        for w in doc["workers"]:
            stream = {k: w["kernel_calls"][k]
                      for k in ("posit_round", "posit_fft_stages",
                                "posit_matmul_round", "posit_kmeans_1d",
                                "posit_butterfly")}
            log(f"  worker {w['worker_id']}: {w['windows']} windows, "
                f"launches {stream}, no plain version on a CUDA tensor "
                f"(refused there)")
        log(f"  {what} memory: {mem.describe(POOL_WORKERS)} ({card})")


def check_pool_fleet(doc, summary, want, what):
    """A fault-free pool run against the in-process card run: no failed
    worker, the ledger's windows and nJ per group, every digest, and each
    worker's stream launches."""
    if doc["failed_workers"]:
        raise AssertionError(f"{what}: {doc['failed_workers']}")
    groups = doc["groups"]
    if set(groups) != set(summary):
        raise AssertionError(f"{what} groups {sorted(groups)}, in process "
                             f"{sorted(summary)}")
    for key, row in summary.items():
        g = groups[key]
        if g["windows"] != row["windows"] or \
                abs(g["total_nj"] - row["total_nj"]) > 1e-12 * abs(
                    row["total_nj"]):
            raise AssertionError(f"{what} {key}: {g['windows']} windows "
                                 f"{g['total_nj']!r} nJ, in process "
                                 f"{row['windows']} {row['total_nj']!r}")
    bad = [p for p, d in want.items() if doc["digests"].get(p) != d]
    if bad or set(doc["digests"]) != set(want):
        raise AssertionError(f"{what}: digests differ from the in-process "
                             f"card run for {bad}")
    check_pool_kernel_calls(doc, ("posit_round", "posit_fft_stages",
                                  "posit_matmul_round", "posit_kmeans_1d"),
                            what)


# ---------------------------------------------------------------------------
# Phase 9: distributed and durability
# ---------------------------------------------------------------------------

def run_sharded_fleet(dev, forest, counters, card):
    """(a) Phase 3's fleet at cap 30, ``pad_policy="max"``, on one card
    engine and on one sharded over ``SHARD_SLABS`` data slabs of the card
    (``split_mesh_info``): every window's outputs and peaks bitwise equal,
    the ledger's windows and nJ exact, ``padded_windows`` only growing,
    the stream launches as predicted, no plain version on a CUDA tensor."""
    import numpy as np
    from repro_torch.kernels.counts import PlainCalls
    from repro_torch.launch.mesh import split_mesh_info
    names = ("posit_round", "posit_fft_stages", "posit_matmul_round",
             "posit_kmeans_1d")
    runs = {}
    for name, kw in (("plain", {}), ("sharded", {
            "mesh_info": split_mesh_info(dev, SHARD_SLABS)})):
        with PlainCalls() as plain:
            engine, _, _, wall, launches = run_main_path(
                dev, forest, counters, max_batch=SHARD_MAX_BATCH,
                pad_policy="max", **kw)
        if any(plain.calls.values()):
            raise AssertionError(f"{name} fleet: plain versions called on "
                                 f"the card: {plain.calls}")
        launches = {k: launches[k] for k in names}
        want = SHARD_PLAIN_LAUNCHES if name == "plain" else SHARD_LAUNCHES
        if launches != want:
            raise AssertionError(f"{name} fleet launched {launches}, "
                                 f"predicted {want}")
        runs[name] = (engine, wall, launches)
    (pe, pw, pl), (se, sw, sl) = runs["plain"], runs["sharded"]
    if se.dp_size != SHARD_SLABS:
        raise AssertionError(f"sharded engine has {se.dp_size} slabs")
    key = lambda r: (r.patient, r.task, r.widx)  # noqa: E731
    rp = sorted(pe.pop_results(), key=key)
    rs = sorted(se.pop_results(), key=key)
    ids = [(r.patient, r.task, r.widx, r.fmt) for r in rp]
    if len(rp) != N_PATIENTS * N_WINDOWS or ids != [
            (r.patient, r.task, r.widx, r.fmt) for r in rs]:
        raise AssertionError("sharded fleet: windows or formats differ")
    for a, b in zip(rp, rs):
        for k in set(a.outputs) | set(b.outputs):
            x, y = np.asarray(a.outputs.get(k)), np.asarray(b.outputs.get(k))
            if x.dtype != y.dtype or x.shape != y.shape or \
                    x.tobytes() != y.tobytes():
                raise AssertionError(f"sharded fleet: {a.patient} window "
                                     f"{a.widx} {k} not bitwise equal")
    for pid, task in pe._trackers:
        if pe.tracker_for(pid, task).peaks != se.tracker_for(pid,
                                                             task).peaks:
            raise AssertionError(f"sharded fleet: {pid}'s peaks differ")
    sp, ss = pe.ledger.summary(), se.ledger.summary()
    if set(sp) != set(ss) or any(
            sp[k]["windows"] != ss[k]["windows"]
            or sp[k]["total_nj"] != ss[k]["total_nj"] for k in sp):
        raise AssertionError("sharded fleet: ledger windows or nJ differ")
    pad = {f"{t}/{f}": (g.padded_windows,
                        se.ledger.stats[(t, f)].padded_windows)
           for (t, f), g in pe.ledger.stats.items()}
    if any(b < a for a, b in pad.values()):
        raise AssertionError(f"sharded fleet padded fewer rows: {pad}")
    n = len(rp)
    log(f"  sharded fleet: {n} windows over {SHARD_SLABS} data slabs of the "
        f"card at cap {SHARD_MAX_BATCH} (pad_policy max, 32 rows a batch), "
        f"every output and peak bitwise equal to one card engine's, ledger "
        f"windows and nJ ({sp['fleet']['total_nj']!r}) exact, padded "
        f"windows (plain, sharded) {pad}; no plain version on the card")
    log(f"  launches: one engine {pl}, sharded {sl} (as predicted); "
        f"{n / pw:.1f} windows/s on one engine ({pw:.3f} s), "
        f"{n / sw:.1f} sharded ({sw:.3f} s) (host clock, {card})")


def codec_launches(counters):
    return {c.__name__: c.launches for c in counters
            if c.__name__ in ("posit_encode", "posit_decode")}


def run_checkpoint(dev, counters, card):
    """(b) qwen3-8b's layer-0 weights at full width (f32 on the card), an
    int32 step and a 1-D f32 leaf, saved async twice by a posit16
    ``CheckpointManager`` with ``keep=1``, then restored on the card:
    every 2-D leaf bitwise B5's decode(encode(x)), the others equal, one
    encode a 2-D leaf a save and one decode a restore.  Returns the
    state."""
    import os
    import shutil
    import tempfile
    import torch
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.formats import get_format
    from repro_torch.kernels import ops
    from repro_torch.kernels.counts import SERVE_PLAIN, PlainCalls
    fmt = get_format("posit16")
    gen = torch.Generator(device=dev).manual_seed(SEED + 9)
    state = {name: torch.randn(shape, generator=gen, device=dev) * 0.02
             for name, shape in CKPT_LEAVES}
    n_vals = sum(v.numel() for v in state.values())
    state["norm"] = torch.randn(4096, generator=gen, device=dev)
    state["step"] = torch.tensor(7, dtype=torch.int32, device=dev)
    n2d = len(CKPT_LEAVES)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt-")
    try:
        mgr = CheckpointManager(tmp, keep=1, quantize_fmt="posit16",
                                async_save=True)
        torch.cuda.synchronize()
        for c in counters:
            c.launches = 0
        with PlainCalls(SERVE_PLAIN) as plain:
            saves = []
            for step in (1, 2):
                t0 = time.perf_counter()
                mgr.save(step, state)
                t1 = time.perf_counter()
                mgr.wait()
                saves.append((t1 - t0, time.perf_counter() - t1))
            saved = codec_launches(counters)
            for c in counters:
                c.launches = 0
            t0 = time.perf_counter()
            restored, step = mgr.restore(state)
            torch.cuda.synchronize()
            t_restore = time.perf_counter() - t0
            loaded = codec_launches(counters)
        if any(plain.calls.values()):
            raise AssertionError(f"checkpoint: plain codec on the card: "
                                 f"{plain.calls}")
        if saved != {"posit_encode": 2 * n2d, "posit_decode": 0} or \
                loaded != {"posit_encode": 0, "posit_decode": n2d}:
            raise AssertionError(f"checkpoint launches: saves {saved}, "
                                 f"restore {loaded}; predicted "
                                 f"{2 * n2d} encodes, {n2d} decodes")
        if step != 2 or mgr.all_steps() != [2]:
            raise AssertionError(f"checkpoint: restored step {step}, kept "
                                 f"{mgr.all_steps()}")
        disk = os.path.getsize(os.path.join(tmp, "step-000000002",
                                            "state.npz"))
        for k, v in state.items():
            want = ops.decode(ops.encode(v, fmt), fmt) if v.dim() >= 2 else v
            got = restored[k]
            same = (bits_equal(got, want) if v.dtype == torch.float32
                    else torch.equal(got, want))
            if got.device != v.device or got.dtype != v.dtype or not same:
                raise AssertionError(f"checkpoint: leaf {k} not restored "
                                     f"bitwise")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    # on the card: 4 bytes read and 2 written a value by the encode, the
    # reverse by the decode; the bits cross to and from the host once
    dev_bound = 6 * n_vals / HBM_BYTES_PER_S * 1e3
    log(f"  checkpoint: {n_vals} values (7 weights, {4 * n_vals / 1e9:.3f} "
        f"GB f32) + step + norm, saved async twice with keep=1 "
        f"({disk / 1e9:.3f} GB on disk), restored on the card: every 2-D "
        f"leaf bitwise decode(encode(x)), the others equal; launches a "
        f"save {saved['posit_encode'] // 2} encodes, a restore "
        f"{loaded['posit_decode']} decodes (as predicted)")
    log(f"  checkpoint times (host clock): save() returned in "
        f"{[round(a * 1e3, 1) for a, _ in saves]} ms (encode on the card "
        f"and the copy of {2 * n_vals / 1e9:.3f} GB of bits to the host; "
        f"device byte bound of the encodes {dev_bound:.3f} ms), the writes "
        f"{[round(b * 1e3, 1) for _, b in saves]} ms more, restore "
        f"{t_restore * 1e3:.1f} ms (read, copy to the card, decode; device "
        f"byte bound {dev_bound:.3f} ms) ({card})")
    return state


def run_all_reduce(dev, state, counters, card):
    """(c) Phase 9b's f32 leaves as gradients through ``posit_all_reduce``
    and ``posit_all_reduce_ef`` at world size 1 on NCCL (an in-process
    ``HashStore``, no network): outputs bitwise decode(encode(x)), the EF
    residual exactly x − q, 2 encodes and 2 decodes a call (3 and 3 for
    EF)."""
    import torch
    import torch.distributed as dist
    from repro_torch.core.formats import get_format
    from repro_torch.distributed.collectives import (posit_all_reduce,
                                                     posit_all_reduce_ef)
    from repro_torch.kernels import ops
    from repro_torch.kernels.counts import SERVE_PLAIN, PlainCalls
    fmt = get_format("posit16")
    grads = [v for v in state.values() if v.dtype == torch.float32]
    n_vals = sum(g.numel() for g in grads)
    torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        qs = [ops.decode(ops.encode(g, fmt), fmt) for g in grads]
        posit_all_reduce(grads[-1], fmt)            # the communicator's init
        torch.cuda.synchronize()
        got = {}
        with PlainCalls(SERVE_PLAIN) as plain:
            for name in ("all-reduce", "EF all-reduce"):
                for c in counters:
                    c.launches = 0
                t0 = time.perf_counter()
                outs = ([posit_all_reduce(g, fmt) for g in grads]
                        if name == "all-reduce" else
                        [posit_all_reduce_ef(g, None, fmt) for g in grads])
                torch.cuda.synchronize()
                got[name] = (outs, time.perf_counter() - t0,
                             codec_launches(counters))
        if any(plain.calls.values()):
            raise AssertionError(f"all-reduce: plain codec on the card: "
                                 f"{plain.calls}")
    finally:
        dist.destroy_process_group()
    n = len(grads)
    for name, per in (("all-reduce", 2), ("EF all-reduce", 3)):
        outs, wall, launches = got[name]
        if launches != {"posit_encode": per * n, "posit_decode": per * n}:
            raise AssertionError(f"{name}: launches {launches}, predicted "
                                 f"{per * n} of each")
        for g, q, o in zip(grads, qs, outs):
            out, res = o if isinstance(o, tuple) else (o, None)
            if not bits_equal(out, q):
                raise AssertionError(f"{name}: not decode(encode(x))")
            if res is not None and not bits_equal(res, g - q):
                raise AssertionError(f"{name}: residual is not x - q")
        exact = ", residual x - q exact" if per == 3 else ""
        log(f"  {name}, world size 1 on NCCL: {n} leaves ({n_vals} values), "
            f"bitwise decode(encode(x)){exact}, "
            f"{per} encodes and {per} decodes a leaf (as predicted), "
            f"{2 * 2 * n_vals / 1e9:.3f} GB of posit16 bytes handed to the "
            f"two collectives; {wall * 1e3:.1f} ms for the tree (host clock, "
            f"{card})")


# ---------------------------------------------------------------------------
# Phase 10: training on the card
# ---------------------------------------------------------------------------

class AdamWSpans:
    """While entered, each ``adamw_update`` of the train step runs between
    two CUDA events: ``ms()`` gives each call's span on the device (its
    first kernel's start to its last's end, gaps included)."""

    def __enter__(self):
        import torch
        from repro_torch.train import step as train_step
        self.mod, self.real, self.spans = train_step, \
            train_step.adamw_update, []

        def timed(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = self.real(*a, **kw)
            ev[1].record()
            self.spans.append(ev)
            return out
        self.mod.adamw_update = timed
        return self

    def __exit__(self, *exc):
        self.mod.adamw_update = self.real

    def ms(self):
        import torch
        torch.cuda.synchronize()
        return [a.elapsed_time(b) for a, b in self.spans]


def finite_tree(tree) -> bool:
    import torch
    from repro_torch.checkpoint import flatten_state
    return all(bool(torch.isfinite(t).all())
               for t in flatten_state(tree)[0])


def run_train_full(dev, counters, card, arch=TRAIN_ARCH, batch=TRAIN_BATCH,
                   seq=TRAIN_SEQ):
    """(a) ``arch`` at full width and depth, trained on the card with
    posit16 QAT weights from ``TokenPipeline`` batches through
    ``make_train_step``: one warm-up step (lr 0: the weights stay), then
    ``TRAIN_STEPS`` timed steps, each ending on the loss's host copy, with
    exactly ``TRAIN_ROUNDS`` B1 launches (one per rounded leaf, counted
    from the tree before the first call), the weights moving, finite
    losses and moments (a non-finite gradient makes its clip scale and so
    every moment NaN), no plain round on a CUDA tensor; each step's AdamW
    span (CUDA events) beside its byte bound; one more step under
    ``torch.profiler`` (busy share, kernels, B1's device ms beside its
    bound), and one under a profiler of CUDA activity alone (the busy
    share of a step it stretches less); the peak memory.  Returns B1's
    row at the training leaves and the run's numbers, with the cell still
    on the card under ``held`` (phase 11 plans and counts it)."""
    import torch
    from repro_torch.checkpoint import flatten_state
    from repro_torch.configs import CONFIGS
    from repro_torch.core.formats import get_format
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.kernels.counts import TRAIN_PLAIN, PlainCalls
    from repro_torch.kernels.posit_round import posit_round, posit_round_torch
    from repro_torch.launch.mesh import make_debug_mesh_info
    from repro_torch.models import build_model
    from repro_torch.train.step import init_train_state, make_train_step
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    cfg = CONFIGS[arch]
    policy = QuantPolicy(weights="posit16")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t_init = time.perf_counter()
    model = build_model(cfg, policy, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(SEED))
    leaves = flatten_state(params)[0]
    n_params = sum(t.numel() for t in leaves)
    rounded = [t for t in leaves if t.dim() >= 2]
    n_rounded = sum(t.numel() for t in rounded)
    if len(rounded) != TRAIN_ROUNDS:
        raise AssertionError(f"{arch}: {len(rounded)} leaves to round, "
                             f"predicted {TRAIN_ROUNDS}")
    state = init_train_state(params)
    step = make_train_step(model, make_debug_mesh_info(device=dev), policy)
    pipe = TokenPipeline(TokenPipelineConfig(vocab=cfg.vocab, seq_len=seq,
                                             global_batch=batch))
    probe = params["layers"]["attn"]["wq"]["w"][:, :64, :64]
    torch.cuda.synchronize()
    log(f"  {arch}: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab}, {n_params} parameters ({4 * n_params / 1e9:.2f} GB "
        f"f32; with the AdamW moments {12 * n_params / 1e9:.2f} GB), "
        f"posit16 QAT ({len(rounded)} leaves, {n_rounded} values), B = "
        f"{batch}, S = {seq}; initialized in "
        f"{time.perf_counter() - t_init:.1f} s")

    def one(s):
        b = pipe.batch_at(s)
        before = probe.clone()
        for c in counters:
            c.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, met = step(state, b)
        loss = float(met["loss"])          # the host copy ends the step
        dt = time.perf_counter() - t0
        launches = {c.__name__: c.launches for c in counters if c.launches}
        if launches != {"posit_round": TRAIN_ROUNDS}:
            raise AssertionError(f"{arch} step {s}: launches {launches}, "
                                 f"predicted {TRAIN_ROUNDS} posit_round")
        if not math.isfinite(loss) or not finite_tree(st["opt"]):
            raise AssertionError(f"{arch} step {s}: loss {loss} or a "
                                 f"moment not finite")
        moved = not torch.equal(probe, before)
        if moved != (s > 0):
            raise AssertionError(f"{arch} step {s} (lr "
                                 f"{float(met['lr'])}): the weights "
                                 f"{'moved' if moved else 'stayed'}")
        return st, loss, dt, float(met["lr"])

    state, loss0, dt0, _ = one(0)
    log(f"  warm-up step 0: loss {loss0:.4f}, {dt0 * 1e3:.1f} ms (lr 0: the "
        f"weights stayed)")
    losses, times, lrs = [], [], []
    with PlainCalls(TRAIN_PLAIN) as plain, AdamWSpans() as spans:
        for s in range(1, TRAIN_STEPS + 1):
            state, loss, dt, lr = one(s)
            losses.append(loss)
            times.append(dt)
            lrs.append(lr)
    if any(plain.calls.values()):
        raise AssertionError(f"{arch}: a plain version on a CUDA tensor: "
                             f"{plain.calls}")
    adamw = spans.ms()
    tokens = batch * seq
    adamw_bound = 28 * n_params / HBM_BYTES_PER_S * 1e3
    round_bound = 8 * n_rounded / HBM_BYTES_PER_S * 1e3
    log(f"  steps 1-{TRAIN_STEPS}: losses {[round(x, 4) for x in losses]}, "
        f"lr {lrs}; ms per step (host clock, to the loss's host copy) "
        f"{[round(t * 1e3, 1) for t in times]}, tokens/s "
        f"{[round(tokens / t, 1) for t in times]}; {TRAIN_ROUNDS} "
        f"posit_round launches a step (as predicted), no plain version on "
        f"a CUDA tensor, the weights moved and every moment finite at each "
        f"step ({card})")
    log(f"  AdamW a step (CUDA events around adamw_update): "
        f"{[round(x, 3) for x in adamw]} ms; bound {adamw_bound:.3f} ms "
        f"(28 B a parameter: p, g, m, v read, p, m, v written, over "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s) ({card})")
    b = pipe.batch_at(TRAIN_STEPS + 1)
    lead = torch.zeros(1, device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        # the profiler may miss a window's first events, and the step
        # launches B1 first: a few fills lead
        for _ in range(20):
            lead.fill_(1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, b)
        float(met["loss"])
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    report_busy(events, wall, "a profiled step (with 20 leading fills of "
                "one value)", 8)
    # the device's share of a step that the profiler stretches less:
    # CUDA activity only, no host operator events
    b = pipe.batch_at(TRAIN_STEPS + 2)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof_dev:
        for _ in range(20):
            lead.fill_(1.0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, met = step(state, b)
        float(met["loss"])
        wall_dev = time.perf_counter() - t0
    report_busy(prof_dev.key_averages(), wall_dev, "a step profiled for "
                "CUDA activity only (with 20 leading fills)", 0)
    round_dev, n = per_launch_ms(events, "posit_round_kernel", TRAIN_ROUNDS)
    log(f"  B1 (posit_round) in the profiled step: {round_dev:.3f} ms on the "
        f"device for its {TRAIN_ROUNDS} launches ({n} recorded), bound "
        f"{round_bound:.3f} ms (8 B a value, {n_rounded} values) ({card})")
    peak_bytes = torch.cuda.max_memory_allocated()
    peak = peak_bytes / 2 ** 30
    log(f"  peak memory allocated {peak:.2f} GiB "
        f"({peak_bytes / 1e9:.2f} GB) ({card})")
    if not finite_tree(state["params"]):
        raise AssertionError(f"{arch}: a weight is not finite")
    fmt = get_format("posit16")

    def qat_round():
        return [posit_round(t, fmt) for t in rounded]
    posit_round.launches = 0
    qat_round()
    launched = posit_round.launches
    if launched != TRAIN_ROUNDS:
        raise AssertionError(f"{arch}'s QAT round: {launched} launches, "
                             f"predicted {TRAIN_ROUNDS}")
    ms = cuda_ms(qat_round, reps=1, samples=5)
    # every kernel, copy and fill of QAT_ROUNDS rounds in one profile
    # window: exactly TRAIN_ROUNDS a round, each a posit_round kernel.
    # Not ``device_ms``'s mean recorded launch times 12: the leaves run
    # from 59904 to 589.8 M values, and a profile that dropped some big
    # ones read below the byte bound.  Not measured only where the
    # profiler recorded nothing (it has missed whole windows after the
    # profiled steps); a window that recorded part of the rounds and no
    # lead spin fails the count
    rows, spins = window_events(qat_round, reps=QAT_ROUNDS)
    kernels = sum(e.count for e in rows) / QAT_ROUNDS
    rounds = sum(e.count for e in rows if "posit_round_kernel" in e.key)
    all_ms = sum(e.self_device_time_total for e in rows) / QAT_ROUNDS / 1e3
    if not rows and not spins:
        all_ms = kernels = float("nan")
    elif rounds != TRAIN_ROUNDS * QAT_ROUNDS or \
            kernels != TRAIN_ROUNDS:
        raise AssertionError(
            f"{arch}'s QAT round: {kernels:g} device kernels a round, "
            f"{rounds} posit_round kernels in {QAT_ROUNDS} rounds "
            f"({spins} of the window's {LEAD_SPINS} lead spins recorded), "
            f"predicted {TRAIN_ROUNDS} and {TRAIN_ROUNDS * QAT_ROUNDS}")
    log(f"  the QAT round alone: {launched} launches, "
        + ("device kernels not measured (the profiler recorded none)"
           if math.isnan(kernels) else f"{kernels:g} device kernels, all "
           f"posit_round ({rounds} in {QAT_ROUNDS} rounds, {spins} of "
           f"{LEAD_SPINS} lead spins recorded), {all_ms:.3f} ms on the "
           f"device") + f" a round ({card})")
    row = dict(name="posit_round",
               shape=f"{arch}'s {TRAIN_ROUNDS} QAT leaves, a step "
                     f"({n_rounded} f32 values)",
               ms=ms,
               device_ms=None if math.isnan(all_ms) else all_ms,
               device_kernels=None if math.isnan(kernels) else kernels,
               plain_ms=cuda_ms(lambda: [posit_round_torch(t, fmt)
                                         for t in rounded], reps=1,
                                samples=3),
               bound_ms=round_bound, bound_by="bytes", library_ms=None)
    held = {"cfg": cfg, "policy": policy, "model": model, "step": step,
            "state": state, "pipe": pipe}
    del state, params, leaves, rounded, probe, step, model
    torch.cuda.empty_cache()
    return row, {"ms_per_step": times, "tokens_per_s": [tokens / t
                                                         for t in times],
                 "adamw_ms": adamw, "peak_gib": peak,
                 "peak_bytes": peak_bytes,
                 "losses": losses, "held": held}


# ---------------------------------------------------------------------------
# Phase 11: the planner against the card
# ---------------------------------------------------------------------------

def run_planner(dev, trained, counters, card):
    """Phase 10's cell (``TRAIN_ARCH``, B = ``TRAIN_BATCH`` × ``TRAIN_SEQ``,
    posit16 QAT, remat) planned by the dry run on a 1 × 1 mesh of the card
    (``make_debug_mesh_info(1, 1)``; the planner traces on ``meta`` and
    allocates nothing), held against the card:

    (a) the planned argument bytes equal the bytes of the train state and
        batch that phase 10 holds on the card, exactly;
    (b) ``analyze_step`` of one real step on the card counts the FLOPs and
        bytes of the planner's ``meta`` trace of the same step, exactly,
        its FLOPs on f32 operands give the plan's compute term, and the
        step launches B1 ``TRAIN_ROUNDS`` times;
    (c) the planned peak beside ``torch.cuda.max_memory_allocated`` over
        that step and over phase 10's steps, and ``HBM_BYTES`` beside the
        card's total memory;
    (d) the roofline terms beside phase 10's ms per step, as a share of
        the bound.

    A mismatch in (a) or (b) raises."""
    import torch
    from repro_torch.checkpoint import flatten_state
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch.dryrun import plan_cell
    from repro_torch.launch.mesh import make_debug_mesh_info
    from repro_torch.roofline import hw
    from repro_torch.roofline.analysis import analyze_step, roofline_terms
    held = trained["held"]
    cfg, state, step = held["cfg"], held["state"], held["step"]
    shape = ShapeConfig("phase10", TRAIN_SEQ, TRAIN_BATCH, "train")
    t0 = time.perf_counter()
    plan = plan_cell(cfg, shape, make_debug_mesh_info(1, 1, device=dev),
                     held["policy"])
    plan_s = time.perf_counter() - t0
    # the batch on the card before the step, as the planner's is on its
    # device: the counted step then copies nothing from the host
    batch = {k: v.to(dev) for k, v in
             held["pipe"].batch_at(TRAIN_STEPS + 3).items()}
    held_bytes = sum(t.numel() * t.element_size()
                     for t in flatten_state(state)[0] + [batch["tokens"]])
    planned = plan["memory"]["arg_bytes_per_device"]
    log(f"  (a) planned argument bytes {planned:.0f}; the state and batch "
        f"on the card {held_bytes} (planned in {plan_s:.1f} s on meta, "
        f"the trace {plan['compile_s']} s of it)")
    if planned != held_bytes:
        raise AssertionError(f"planned argument bytes {planned} != "
                             f"{held_bytes} held on the card")
    for c in counters:
        c.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    counted = analyze_step(step, state, batch)
    torch.cuda.synchronize()
    count_s = time.perf_counter() - t0
    step_peak = torch.cuda.max_memory_allocated()
    launches = {c.__name__: c.launches for c in counters if c.launches}
    log(f"  (b) the card's step counted in {count_s:.1f} s: FLOPs "
        f"{counted['flops']:.0f}, bytes {counted['bytes']:.0f}, "
        f"{counted['ops']} ops, kernel ops {counted['kernel_ops']}, "
        f"launches {launches}; the planner's meta trace: FLOPs "
        f"{plan['raw']['flops']:.0f}, bytes {plan['raw']['bytes']:.0f}")
    if launches != {"posit_round": TRAIN_ROUNDS}:
        raise AssertionError(f"the counted step launched {launches}, "
                             f"predicted {TRAIN_ROUNDS} posit_round")
    for k in ("flops", "bytes"):
        if counted[k] != plan["raw"][k]:
            raise AssertionError(f"{k}: the card counts {counted[k]}, the "
                                 f"meta plan {plan['raw'][k]}")
    # the compute term charges the FLOPs on f32 operands at the f32 peak:
    # the card's split of the FLOPs gives the plan's term
    card_terms = roofline_terms(counted["flops"], counted["bytes"], 0.0,
                                counted["flops_f32"])
    if card_terms["compute_s"] != plan["terms"]["compute_s"]:
        raise AssertionError(f"compute term: the card's count gives "
                             f"{card_terms['compute_s']} s, the meta plan "
                             f"{plan['terms']['compute_s']} s")
    peak = plan["memory"]["peak_bytes_per_device"]
    total = torch.cuda.get_device_properties(0).total_memory
    log(f"  (c) planned peak {peak / 1e9:.3f} GB (arguments "
        f"{planned / 1e9:.3f} + temporaries "
        f"{plan['memory']['temp_bytes_per_device'] / 1e9:.3f}); "
        f"max_memory_allocated {step_peak / 1e9:.3f} GB over the counted "
        f"step (planned/measured {peak / step_peak:.4f}), "
        f"{trained['peak_bytes'] / 1e9:.3f} GB over phase 10's steps "
        f"({peak / trained['peak_bytes']:.4f}); the card-side count's "
        f"peak {counted['peak_bytes_per_device'] / 1e9:.3f} GB; HBM_BYTES "
        f"{hw.HBM_BYTES / 1e9:.3f} GB, the card's total_memory "
        f"{total / 1e9:.3f} GB ({card})")
    terms = plan["terms"]
    ms = trained["ms_per_step"]
    log(f"  (d) roofline terms (H100 SXM5 constants): compute "
        f"{terms['compute_s'] * 1e3:.3f} ms ({counted['flops_f32']:.0f} of "
        f"the FLOPs on f32 operands, at the f32 peak), memory "
        f"{terms['memory_s'] * 1e3:.3f} ms, collective "
        f"{terms['collective_s'] * 1e3:.3f} ms, dominant "
        f"{terms['dominant']}, bound {terms['bound_s'] * 1e3:.3f} ms; "
        f"phase 10's ms per step {[round(t * 1e3, 1) for t in ms]}: the "
        f"bound is {[round(terms['bound_s'] / t * 100, 1) for t in ms]} % "
        f"of each; model FLOPs {plan['model_flops_global']:.0f}, useful "
        f"ratio {plan['useful_ratio']:.4f} ({card})")


def reduced_train_batch(cfg, B=2, S=32):
    """``tests/test_models_smoke.py::make_batch``'s inputs, as tensors."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    batch = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab, size=(B, S)).astype(np.int32))}
    if cfg.family == "vlm":
        batch["frontend"] = torch.from_numpy(rng.normal(
            size=(B, cfg.frontend_len, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.normal(
            size=(B, S, cfg.d_model)).astype(np.float32))
    return batch


class CardRoutes:
    """MoE routing held the same on two devices: entered with ``record``,
    each ``moe.route`` call's chosen experts are kept; entered with
    ``replay``, each call takes the kept experts (its gates and their
    renormalized values computed on its own device) and counts the tokens
    whose own top-k differs.  A bf16 GEMM that rounds in another order
    moves a router's near-tie (gate margins of ~1e-4 in the reduced
    configs) to the other expert; replaying the card's choices compares
    the arithmetic, and ``flips`` says how many routes the CPU would have
    chosen otherwise."""

    def __init__(self):
        self.kept, self.flips, self.replay = [], 0, False

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.mod, self.real = moe, moe.route
        it = iter(list(self.kept))

        def route(xf, router_w, k):
            gates, gatev, assign = self.real(xf, router_w, k)
            if not self.replay:
                self.kept.append(assign.cpu())
                return gates, gatev, assign
            card = next(it).to(assign.device)
            self.flips += int((torch.sort(card, -1).values
                               != torch.sort(assign, -1).values)
                              .any(-1).sum())
            gatev = torch.gather(gates, -1, card)
            gatev = gatev / torch.clamp(gatev.sum(-1, keepdim=True),
                                        min=1e-9)
            return gates, gatev, card
        moe.route = route
        return self

    def __exit__(self, *exc):
        self.mod.route = self.real
        self.replay = True


def rel_l2_max(a, b):
    """The largest relative L2 distance of a leaf of ``a`` from ``b``'s."""
    import torch
    return max(float(torch.linalg.vector_norm(x - y)
                     / max(float(torch.linalg.vector_norm(y)), 1e-30))
               for x, y in zip(a, b))


class F32Compute:
    """The models' compute dtype (``COMPUTE_DTYPE``, bf16) set to f32 while
    entered: the embedding's output, and so every product that takes its
    operands' dtype, stays f32."""

    def __enter__(self):
        import torch
        from repro_torch.models import common
        self.mod, self.real = common, common.COMPUTE_DTYPE
        common.COMPUTE_DTYPE = torch.float32
        return self

    def __exit__(self, *exc):
        self.mod.COMPUTE_DTYPE = self.real


def one_ulp(weights, seed):
    """``weights`` with every value moved by one f32 ulp, up or down at
    random (from ``seed``)."""
    import torch
    from repro_torch.models.common import tree_map
    g = torch.Generator().manual_seed(seed)
    return tree_map(lambda t: torch.nextafter(t, torch.where(
        torch.rand(t.shape, generator=g) < 0.5, math.inf, -math.inf)),
        weights)


def train_reduced_on_card_and_cpu(dev, card):
    """(b) every reduced config's loss and gradients on the card and on
    the CPU from the same weights: the loss within ``TRAIN_TOL``, each
    gradient leaf within a relative L2 error of ``TRAIN_GRAD_TOL`` (the
    CPU tests' bound against the reference).  A MoE config's CPU run takes
    the card's routes (``CardRoutes``); the routes its own top-k would
    have flipped are logged.  The ssm family (xlstm) is checked on each of
    ``RECURRENT_SEEDS``: its bf16 gradients move by 10-42 % when every
    weight moves by one ulp (on the CPU, ``one_ulp``: a bf16 rounding that
    flips; in f32 they move by < 1e-4), so with the compute dtype f32
    (``F32Compute``) the card's gradients are held within
    ``TRAIN_GRAD_TOL`` of the CPU's, and in bf16 the card's distance from
    an exact-sum run on the CPU (``exact_sums``) within
    ``WITNESS_FACTOR`` times the CPU's own spread: the largest distance
    from that witness of the CPU's gradients and of theirs after
    ``ULP_MOVES`` one-ulp moves of the weights (or ``TRAIN_GRAD_TOL``).
    Every config is checked before a failure is raised."""
    import contextlib
    import torch
    from repro_torch.checkpoint import flatten_state
    from repro_torch.configs import CONFIGS, reduced
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    cpu = torch.device("cpu")
    worst, failed = {}, []

    def loss_grads(cfg, weights, batch, d, routes, mode=None):
        params = tree_map(lambda t: t.to(d, copy=True).requires_grad_(),
                          weights)
        leaves = flatten_state(params)[0]
        ctx = {"exact": exact_sums, "f32": F32Compute}.get(
            mode, contextlib.nullcontext)
        with routes, ctx():
            loss, _ = build_model(cfg, device=d).loss(params, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return float(loss.detach()), [
            torch.zeros(t.shape) if g is None else g.detach().cpu()
            for t, g in zip(leaves, grads)]

    for arch in sorted(CONFIGS):
        cfg = reduced(CONFIGS[arch])
        batch = reduced_train_batch(cfg)
        seeds = RECURRENT_SEEDS if cfg.family == "ssm" else (SEED,)
        readings = []
        for seed in seeds:
            weights = build_model(cfg, device=cpu).init(
                torch.Generator().manual_seed(seed))
            routes = CardRoutes()
            lc, gc = loss_grads(cfg, weights, batch, dev, routes)
            lp, gp = loss_grads(cfg, weights, batch, cpu, routes)
            rel = rel_l2_max(gc, gp)
            tag = f"{arch} seed {seed}"
            n_routes = sum(a.shape[0] for a in routes.kept)
            if routes.flips > 0.05 * n_routes:
                failed.append(f"{tag}: {routes.flips} of {n_routes} routes "
                              f"flipped")
            if not all(bool(torch.isfinite(g).all()) for g in gc):
                failed.append(f"{tag}: a gradient on the card is not "
                              f"finite")
            if abs(lc - lp) >= TRAIN_TOL:
                failed.append(f"{tag}: card loss {lc}, CPU {lp}")
            if cfg.family != "ssm":
                readings.append(f"{abs(lc - lp):.2e} {rel:.2e} "
                                f"{routes.flips}")
                if rel >= TRAIN_GRAD_TOL:
                    failed.append(f"{tag}: largest gradient relative L2 "
                                  f"{rel} (bound {TRAIN_GRAD_TOL})")
                continue
            gw = loss_grads(cfg, weights, batch, cpu, routes, "exact")[1]
            w_card, w_cpu = rel_l2_max(gc, gw), rel_l2_max(gp, gw)
            w_ulp = [rel_l2_max(loss_grads(
                cfg, one_ulp(weights, ULP_MOVES * seed + k), batch, cpu,
                routes)[1], gw) for k in range(ULP_MOVES)]
            bound = WITNESS_FACTOR * max(w_cpu, *w_ulp, TRAIN_GRAD_TOL)
            f32 = rel_l2_max(
                loss_grads(cfg, weights, batch, dev, routes, "f32")[1],
                loss_grads(cfg, weights, batch, cpu, routes, "f32")[1])
            readings.append(
                f"seed {seed}: {abs(lc - lp):.2e} {rel:.2e}, from the "
                f"exact-sum witness card {w_card:.2e} CPU {w_cpu:.2e}, the "
                f"CPU after one-ulp moves {min(w_ulp):.2e}-"
                f"{max(w_ulp):.2e} (bound {bound:.2e}), in f32 card vs "
                f"CPU {f32:.2e}")
            if w_card > bound:
                failed.append(f"{tag}: card gradients {w_card} from the "
                              f"witness, over {bound}")
            if f32 >= TRAIN_GRAD_TOL:
                failed.append(f"{tag}: in f32, largest gradient relative "
                              f"L2 {f32} (bound {TRAIN_GRAD_TOL})")
        worst[arch] = "; ".join(readings)
    log(f"  reduced configs, loss and gradients card vs CPU (|loss diff|, "
        f"largest relative L2 of a gradient leaf, routes the CPU's own "
        f"top-k flips, at most 5 % of them; bound {TRAIN_GRAD_TOL}): "
        + ", ".join(f"{a} {w}" for a, w in worst.items()) + f" ({card})")
    if failed:
        raise AssertionError("reduced configs card vs CPU: "
                             + "; ".join(failed))


def train_steps_reduced(dev, counters, card):
    """(b) three posit16 QAT steps of reduced gemma2-2b on the card
    (``TRAIN_ROUNDS`` B1 launches a step, no plain version on a CUDA
    tensor) and on the CPU from the same weights, losses within
    ``TRAIN_TOL``; then a resume: reduced qwen3-8b trained 60 steps
    straight and 50 + a checkpoint + 10 resumed (``launch/train.py``), the
    last 10 losses within the reference's rtol 1e-4."""
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.configs import CONFIGS, reduced
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.kernels.counts import TRAIN_PLAIN, PlainCalls
    from repro_torch.launch.mesh import make_debug_mesh_info
    from repro_torch.launch.train import train
    from repro_torch.models import build_model
    from repro_torch.models.common import tree_map
    from repro_torch.train.step import init_train_state, make_train_step
    cfg = reduced(CONFIGS[TRAIN_ARCH])
    policy = QuantPolicy(weights="posit16")
    weights = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(SEED))
    pipe = TokenPipeline(TokenPipelineConfig(vocab=cfg.vocab, seq_len=32,
                                             global_batch=4))
    losses = {}
    for d in (dev, torch.device("cpu")):
        state = init_train_state(tree_map(lambda t: t.to(d, copy=True),
                                          weights))
        step = make_train_step(build_model(cfg, policy, device=d),
                               make_debug_mesh_info(device=d), policy)
        for c in counters:
            c.launches = 0
        with PlainCalls(TRAIN_PLAIN) as plain:
            losses[d.type] = []
            for s in range(3):
                state, met = step(state, pipe.batch_at(s))
                losses[d.type].append(float(met["loss"]))
        if d.type == "cuda":
            launches = {c.__name__: c.launches for c in counters
                        if c.launches}
            if launches != {"posit_round": 3 * TRAIN_ROUNDS} or any(
                    plain.calls.values()):
                raise AssertionError(f"reduced QAT steps: launches "
                                     f"{launches}, plain {plain.calls}")
    diff = max(abs(a - b) for a, b in zip(losses[dev.type], losses["cpu"]))
    if diff >= TRAIN_TOL:
        raise AssertionError(f"reduced QAT steps: card {losses[dev.type]}, "
                             f"CPU {losses['cpu']}")
    log(f"  reduced {TRAIN_ARCH}, 3 posit16 QAT steps: card losses "
        f"{[round(x, 5) for x in losses[dev.type]]}, CPU "
        f"{[round(x, 5) for x in losses['cpu']]} (largest difference "
        f"{diff:.2e}); {3 * TRAIN_ROUNDS} posit_round launches (as "
        f"predicted), no plain version on a CUDA tensor ({card})")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train-")
    try:
        t0 = time.perf_counter()
        _, full = train("qwen3-8b", steps=60, batch=4, seq=32,
                        log_every=1000, device=dev)
        t_full = time.perf_counter() - t0
        train("qwen3-8b", steps=50, batch=4, seq=32, ckpt_dir=tmp,
              log_every=1000, device=dev)
        _, resumed = train("qwen3-8b", steps=60, batch=4, seq=32,
                           ckpt_dir=tmp, log_every=1000, device=dev)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if len(resumed) != 10 or not np.allclose(full[-10:], resumed,
                                             rtol=RESUME_RTOL, atol=0):
        raise AssertionError(f"resume: {full[-10:]} against {resumed}")
    gap = max(abs(a - b) / abs(a) for a, b in zip(full[-10:], resumed))
    log(f"  reduced qwen3-8b through launch/train.py on the card: 60 steps "
        f"in {t_full:.1f} s (host clock), loss {full[0]:.4f} -> "
        f"{full[-1]:.4f}; resumed from step 50's checkpoint: the last 10 "
        f"losses within rtol {gap:.2e} of the straight run's (bound "
        f"{RESUME_RTOL}) ({card})")


def train_pod_branch(dev, counters, card):
    """(b) the pod-compressed branch at world size 1 on NCCL (an in-process
    ``HashStore``): one step of reduced qwen3-8b with
    ``grad_allreduce="posit16"`` on a (pod=1, data=1, model=1) mesh, every
    gradient leaf through ``posit_all_reduce``: 2 encodes and 2 decodes a
    leaf, each reduced gradient bitwise the plain codec's
    decode(encode(g)), no plain codec on a CUDA tensor."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import flatten_state
    from repro_torch.configs import CONFIGS, reduced
    from repro_torch.core.policy import QuantPolicy
    from repro_torch.data.tokens import TokenPipeline, TokenPipelineConfig
    from repro_torch.distributed import MeshInfo, collectives
    from repro_torch.kernels.counts import TRAIN_PLAIN, PlainCalls
    from repro_torch.kernels.posit_codec import (posit_decode_torch,
                                                 posit_encode_torch)
    from repro_torch.models import build_model
    from repro_torch.train.step import init_train_state, make_train_step
    cfg = reduced(CONFIGS["qwen3-8b"])
    policy = QuantPolicy(grad_allreduce="posit16")
    fmt = policy.fmt("grad_allreduce")
    minfo = MeshInfo((dev,), ("pod", "data", "model"), (1, 1, 1),
                     dp_axes=("pod", "data"))
    model = build_model(cfg, policy, device=dev)
    state = init_train_state(model.init(
        torch.Generator(device=dev).manual_seed(SEED)))
    n_leaves = len(flatten_state(state["params"])[0])
    batch = TokenPipeline(TokenPipelineConfig(
        vocab=cfg.vocab, seq_len=32, global_batch=4)).batch_at(0)
    seen = []
    real = collectives.posit_all_reduce

    def captured(g, f, group=None):
        out = real(g, f, group)
        seen.append((g.detach().clone(), out))
        return out
    torch.cuda.set_device(torch.cuda.current_device())
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    collectives.posit_all_reduce = captured
    try:
        step = make_train_step(model, minfo, policy)
        for c in counters:
            c.launches = 0
        with PlainCalls(TRAIN_PLAIN) as plain:
            state, met = step(state, batch)
            loss = float(met["loss"])
        launches = {c.__name__: c.launches for c in counters if c.launches}
    finally:
        collectives.posit_all_reduce = real
        dist.destroy_process_group()
    want = {"posit_encode": 2 * n_leaves, "posit_decode": 2 * n_leaves}
    if launches != want or any(plain.calls.values()) or \
            len(seen) != n_leaves or not math.isfinite(loss):
        raise AssertionError(f"pod branch: launches {launches} (predicted "
                             f"{want}), {len(seen)} all-reduces of "
                             f"{n_leaves} leaves, plain {plain.calls}, loss "
                             f"{loss}")
    for g, out in seen:
        ref = posit_decode_torch(posit_encode_torch(g.cpu(), fmt), fmt,
                                 torch.float32)
        if not bits_equal(out.cpu(), ref):
            raise AssertionError("pod branch: a reduced gradient is not the "
                                 "plain codec's decode(encode(g))")
    log(f"  pod-compressed branch, world size 1 on NCCL: {n_leaves} gradient"
        f" leaves through posit_all_reduce, {launches} (2 encodes and 2 "
        f"decodes a leaf, as predicted), each bitwise the plain codec's "
        f"decode(encode(g)); loss {loss:.4f} ({card})")


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
    from repro_torch.kernels.counts import wrappers

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
                 "posit_kv_attention", "posit_kmeans"):
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
    counters = wrappers()
    stream_kernels = ("posit_round", "posit_fft_stages", "posit_matmul_round")
    phase("phase 2: kernels against their plain versions")
    shapes = check_kernels(dev, report)
    check_fft_stages(dev, report)
    check_serve_kernels(dev, report)
    check_moe_kernels(dev, report)
    check_api_kernels(dev, report)
    check_format_kernels(dev, report)
    check_kmeans(dev)

    phase("phase 3: stream path, 64-patient fleet")
    t0 = time.perf_counter()
    forest = train_reference_forest(96, 123, n_trees=10, depth=5, device=dev)
    log(f"  forest trained in {time.perf_counter() - t0:.1f} s")
    engine, records, pins, wall, launches = run_main_path(dev, forest,
                                                          counters)
    check_main_path(engine, records, pins, forest, wall,
                    {k: launches[k] for k in (*stream_kernels,
                                              "posit_kmeans_1d")})
    if launches["posit_round"] != FLEET_ROUND_LAUNCHES:
        raise AssertionError(f"posit_round launched {launches['posit_round']}"
                             f" times on the fleet, not the window cores' "
                             f"{FLEET_ROUND_LAUNCHES}")
    if launches["posit_kmeans_1d"] != FLEET_KMEANS_LAUNCHES:
        raise AssertionError(f"posit_kmeans_1d launched "
                             f"{launches['posit_kmeans_1d']} times on the "
                             f"fleet, not one per tracked window "
                             f"({FLEET_KMEANS_LAUNCHES})")
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
    extra.append(time_kmeans(dev))
    extra += time_format_kernels(dev, report)
    extra += time_serve_kernels(dev, report)
    extra += time_api_kernels(dev)
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
        if "earlier_plan_ms" in r:
            unfused += (f", the M-dependent plan it replaced "
                        f"{r['earlier_plan_ms']:.4f} ms per call "
                        f"({r['earlier_plan_device_ms']:.4f} on the device)")
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
    log_serve_ledger(summary, card)
    check_live_kv(captured)
    profile_serve(dev, model, params, reqs, by_rid, card)
    serve_kv_route_ab(dev, model, params, reqs, by_rid, card)
    del model, params
    torch.cuda.empty_cache()
    serve_reduced_on_card_and_cpu(dev)

    phase(f"phase 5b: serve path, {MOE_ARCH} at full width, "
          f"{2 * SERVE_PROMPTS} requests on two lanes, then a "
          f"{LONG_PREFILL}-position prefill")
    t0 = time.perf_counter()
    extra.append(run_moe_serve(dev, counters, card))
    extra += time_moe_kernels(dev)
    torch.cuda.empty_cache()
    log(f"  phase 5b in {time.perf_counter() - t0:.1f} s ({card})")

    for tag, arch, lanes in (("5c", VLM_ARCH, "two KV lanes"),
                             ("5d", ENCDEC_ARCH, "two KV lanes"),
                             ("5e", SSM_ARCH, "one lane, no KV cache"),
                             ("5f", HYBRID_ARCH, "two KV lanes")):
        phase(f"phase {tag}: {arch} at full width through prefill and "
              f"{API_STEPS} decode steps, {lanes}")
        t0 = time.perf_counter()
        run_model_api(dev, arch, counters, card)
        log(f"  phase {tag} in {time.perf_counter() - t0:.1f} s ({card})")

    phase("phase 6: the format study, the quickstart and Arith.fma")
    t0 = time.perf_counter()
    run_study(dev, counters)
    report["posit_matmul"]["launches"] = run_quickstart(
        dev, counters)["posit_matmul"]
    report["posit_fma_round"]["launches"] = run_fma(
        dev, counters)["posit_fma_round"]
    log(f"  phase 6 in {time.perf_counter() - t0:.1f} s ({card})")

    phase("phase 7: the ingest fleet over TCP, with the observability "
          "plane")
    t0 = time.perf_counter()
    check_ingest(run_ingest(dev, forest, counters), dev, card)
    log(f"  phase 7 in {time.perf_counter() - t0:.1f} s ({card})")

    phase(f"phase 8: the ingest worker pool, {POOL_WORKERS} workers on the "
          f"card")
    t0 = time.perf_counter()
    run_pool(dev, forest, card)
    log(f"  phase 8 in {time.perf_counter() - t0:.1f} s ({card})")

    phase("phase 9: distributed and durability")
    t0 = time.perf_counter()
    run_sharded_fleet(dev, forest, counters, card)
    state = run_checkpoint(dev, counters, card)
    run_all_reduce(dev, state, counters, card)
    del state
    torch.cuda.empty_cache()
    log(f"  phase 9 in {time.perf_counter() - t0:.1f} s ({card})")

    phase(f"phase 10: training on the card, {TRAIN_ARCH} at full width")
    t0 = time.perf_counter()
    row, trained = run_train_full(dev, counters, card)
    extra.append(row)
    train_reduced_on_card_and_cpu(dev, card)
    train_steps_reduced(dev, counters, card)
    train_pod_branch(dev, counters, card)
    log(f"  phase 10 in {time.perf_counter() - t0:.1f} s ({card})")

    phase(f"phase 11: the planner against the card, phase 10's "
          f"{TRAIN_ARCH} cell")
    t0 = time.perf_counter()
    run_planner(dev, trained, counters, card)
    del trained
    torch.cuda.empty_cache()
    log(f"  phase 11 in {time.perf_counter() - t0:.1f} s ({card})")
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
elif __name__ == "__mp_main__":
    # phase 8's pool spawns workers that import this script as
    # ``__mp_main__``: a stream kernel's plain version raises there on a
    # CUDA tensor, so a fallback fails its worker
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.counts import refuse_plain_on_card
    refuse_plain_on_card()
