"""Operations and bytes of the program's kernels and steps, from shapes
alone, and the peaks of the card they are held against.

Every count reads each input byte once and writes each output byte once,
whatever a kernel reads again; where the work depends on the data (the
K/V a row has filled), the count takes what these inputs need.  The peaks
are NVIDIA's data sheet for one H100 SXM5 (dense, without sparsity):
they are the yardstick's own and do not move with the program.
"""
from __future__ import annotations

from typing import Dict, Sequence

PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
PEAK_BYTES_PER_S = 3.35e12

F32 = 4


def numel(shape: Sequence[int]) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def posit_bytes(nbits: int) -> int:
    """Bytes of one posit pattern in its container (int8 / int16 / int32)."""
    return 1 if nbits <= 8 else 2 if nbits <= 16 else 4


def bound_s(flops: float, nbytes: float, operand: str = "f32") -> float:
    """The least time the card could take: the larger of the operations
    over the peak for their operand type and the bytes over HBM's rate."""
    return max(flops / PEAK_FLOPS[operand], nbytes / PEAK_BYTES_PER_S)


# ---------------------------------------------------------------------------
# Kernels
# ---------------------------------------------------------------------------

def posit_decode(shape: Sequence[int], nbits: int, out_bytes: int) -> Dict:
    """Posit patterns in, values out: no arithmetic worth counting."""
    n = numel(shape)
    return {"flops": 0.0, "bytes": float(n * (posit_bytes(nbits) + out_bytes))}


def posit_fft_stages(state_numel: int, n_fft: int, stages: int) -> Dict:
    """``stages`` radix-2 stages on an f32 state of ``state_numel`` values
    (the re and im planes): the state read and written once, the twiddle
    table (2, n - 1) read once; a butterfly pair (4 real values in, 4 out)
    takes 4 products and 6 adds in every stage."""
    return {"flops": float(10 * (state_numel // 4) * stages),
            "bytes": float(2 * state_numel * F32 + 2 * (n_fft - 1) * F32)}


def posit_matmul_round(M: int, K: int, N: int) -> Dict:
    return {"flops": float(2 * M * K * N),
            "bytes": float((M * K + K * N + M * N) * F32)}


def posit_kv_attention(B: int, KV: int, G: int, D: int, kv_nbits: int,
                       filled: int) -> Dict:
    """q (B, KV, G, D) f32 over the K and V rows each batch row has filled
    (``filled`` = their sum over the batch), out (B, KV, G, D) f32: two
    products of D per key and query head (logits, P·V)."""
    kv = 2 * filled * KV * D * posit_bytes(kv_nbits)
    io = 2 * B * KV * G * D * F32
    return {"flops": float(4 * filled * KV * G * D), "bytes": float(kv + io)}


# ---------------------------------------------------------------------------
# Whole steps
# ---------------------------------------------------------------------------

def moe_decode_step(cfg: Dict, rows: int, filled: int,
                    weight_nbits: int = 16, kv_nbits: int = 8) -> Dict:
    """One batched decode step of a MoE decoder for ``rows`` tokens whose
    caches hold ``filled`` positions in all (summed over the rows, before
    this step's append): FLOPs 2 × active parameters × rows plus the
    attention's; bytes every weight once in posit plus the K/V read.  The
    tied unembedding is counted once, as a product over the whole
    vocabulary."""
    d, L = cfg["hidden_size"], cfg["num_hidden_layers"]
    H, KV = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    hd = d // H
    E, k = cfg["num_local_experts"], cfg["num_experts_per_tok"]
    ff = cfg["intermediate_size"]
    V = cfg["vocab_size"]
    attn_w = d * hd * (H + 2 * KV) + H * hd * d
    expert_w = 3 * d * ff
    active = L * (attn_w + d * E + k * expert_w) + V * d
    every = L * (attn_w + d * E + E * expert_w) + V * d
    attn_flops = 4 * (filled + rows) * H * hd * L
    kv_bytes = 2 * (filled + rows) * KV * hd * posit_bytes(kv_nbits) * L
    return {"flops": float(2 * active * rows + attn_flops),
            "bytes": float(every * posit_bytes(weight_nbits) + kv_bytes)}


def cough_window(fft_n: int = 4096, channels: int = 2, audio_n: int = 4800,
                 imu_channels: int = 9, imu_n: int = 30, n_mel: int = 20,
                 n_coef: int = 13, trees: int = 20) -> Dict:
    """One cough window's arithmetic: the real FFT (n/2 · log2 n
    butterflies of 10 operations a channel), the PSD (3 a bin), the
    spectral prefix sum and centroid (3 a bin), the mel and DCT products
    (2 a product), the IMU moments (~8 a sample) and the votes; bytes:
    the window's samples in and its probability out, f32."""
    bins = fft_n // 2 + 1
    levels = fft_n.bit_length() - 1
    flops = channels * (10 * (fft_n // 2) * levels + 6 * bins
                        + 2 * bins * n_mel + 2 * n_mel * n_coef)
    flops += 8 * imu_channels * imu_n + 2 * trees
    nbytes = (channels * audio_n + imu_channels * imu_n + 1) * F32
    return {"flops": float(flops), "bytes": float(nbytes)}


def rpeak_window(n: int = 500, taps: int = 25) -> Dict:
    """One ECG window's scores: the slope product (3 a sample), the
    moving sum (2 a tap and sample), the logistic squashing (~6 a sample);
    bytes: the samples in, the scores out, f32."""
    return {"flops": float(n * (3 + 2 * taps + 6)),
            "bytes": float(2 * n * F32)}
