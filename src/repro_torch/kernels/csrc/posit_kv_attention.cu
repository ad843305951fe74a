// One decode step of attention against a posit-quantized KV cache, for
// Hopper (sm_90a): q (B, KV, G, D) f32 attends over K/V posit bits held as
// the cache holds them, (B, S, KV, D), with a per-row valid length.
//
// Replaces repro/kernels/posit_kv_attention.py::posit_kv_attention (with
// the B x KV vmap of repro/kernels/ops.py::kv_attention folded into the
// grid).  As on the TPU, the K/V bits stay narrow in device memory and are
// decoded tile by tile in on-chip memory (the codec's shared device
// function, posit_decode.cuh), and the softmax runs online over the key
// blocks of _block_plan (bs rounded to 8, S padded with masked zeros), with
// the (m, l, acc) carry updated once per block:
//   logits = (q . k) * D**-0.5, masked to -1e30 where pos >= min(len, S)
//   m' = max(m, max logits); p = exp(logits - m') (0 where masked)
//   l' = l * exp(m - m') + sum p;  acc' = acc * exp(m - m') + p . v
//   out = acc / max(l, 1e-30)
//
// Bound on the H100: memory.  A decode step reads 2 S D narrow integers per
// (row, KV head) and does 4 G D operations per position: G = 4 gives about
// 16 f32 operations per posit8 byte, below the ~20 where the card's 67
// TFLOP/s of f32 would take over from its 3.35 TB/s.  The simple design
// here: one thread block per (batch row, KV head), nothing carried between
// blocks; q in shared memory; K and V read as 16-byte chunks into
// registers one tile of T rows ahead (so the next tile's loads are in
// flight while this one is computed) and decoded into shared memory;
// logits of the whole key block kept in shared memory; each thread owns up
// to four (g, d) outputs of acc in registers.  The cache is read in place
// through its (B, S, KV) strides, never copied or transposed; its rows
// must be contiguous and 16-byte aligned, as a cache's always are.  With
// B x KV = 32 blocks on 132 SMs a long cache is decoded by a quarter of
// the card: splitting S across blocks (a second reduction pass) is the
// next step for speed.
//
// Build with -fmad=false: the carry update l * alpha + sum is two roundings
// in the reference, not one fused multiply-add.
#include <cstdint>

#include "posit_decode.cuh"

namespace {
constexpr int kThreads = 256;
constexpr int kMaxOut = 4;        // (g, d) outputs per thread: G D <= 1024
constexpr int kMaxChunks = 4;     // 16-byte loads in flight per thread
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xFFFFFFFFu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}
}  // namespace

// Every K/V row is contiguous and starts 16-byte aligned; it is read as
// 16-byte chunks, fetched into registers one tile ahead of the tile being
// computed (T D sizeof(S) / 16 <= kMaxChunks blockDim).
template <typename S>
__global__ void posit_kv_attention_kernel(
    const float* __restrict__ q, const S* __restrict__ kb,
    const S* __restrict__ vb, const int* __restrict__ lengths,
    float* __restrict__ out, int KV, int G, int D, int Slen, long long sB,
    long long sS, long long sH, int bs, int n_blocks, int T, float scale,
    int nbits, int es) {
  constexpr int kVec = 16 / sizeof(S);       // elements per 16-byte chunk
  constexpr int kPerWord = 4 / sizeof(S);
  extern __shared__ float smem[];
  float* q_s = smem;                        // (G, D)
  float* t_s = q_s + G * D;                 // (T, D + 1) decoded K or V
  float* p_s = t_s + T * (D + 1);           // (G, bs) logits, then p
  float* m_s = p_s + G * bs;                // (G) running max
  float* l_s = m_s + G;                     // (G) running denominator
  float* a_s = l_s + G;                     // (G) this block's alpha

  const int tid = threadIdx.x;
  const int b = blockIdx.x / KV, h = blockIdx.x % KV;
  const int GD = G * D;
  const float* qh = q + static_cast<long long>(blockIdx.x) * GD;
  for (int i = tid; i < GD; i += blockDim.x) q_s[i] = qh[i];
  for (int g = tid; g < G; g += blockDim.x) {
    m_s[g] = kNegInf;
    l_s[g] = 0.0f;
  }
  int len = lengths[b];
  len = len < Slen ? len : Slen;
  const long long head = b * sB + h * sH;
  const int cpr = D / kVec;                 // 16-byte chunks per row

  // rows [row0, row0 + rows) of K or V: fetch starts the loads into
  // registers, decode_tile writes the decoded tile into t_s (zeros past S)
  int4 buf[kMaxChunks];
  int buf_rows = 0;
  auto fetch = [&](const S* src, int row0, int rows) {
    buf_rows = rows;
#pragma unroll
    for (int u = 0; u < kMaxChunks; ++u) {
      const int c = tid + u * blockDim.x;
      const int r = c / cpr;
      buf[u] = make_int4(0, 0, 0, 0);
      if (c < rows * cpr && row0 + r < Slen)
        buf[u] = __ldg(reinterpret_cast<const int4*>(
            src + head + (row0 + r) * sS + (c - r * cpr) * kVec));
    }
  };
  auto decode_tile = [&]() {
#pragma unroll
    for (int u = 0; u < kMaxChunks; ++u) {
      const int c = tid + u * blockDim.x;
      if (c < buf_rows * cpr) {
        const int r = c / cpr;
        float* dst = t_s + r * (D + 1) + (c - r * cpr) * kVec;
        const uint32_t w[4] = {static_cast<uint32_t>(buf[u].x),
                               static_cast<uint32_t>(buf[u].y),
                               static_cast<uint32_t>(buf[u].z),
                               static_cast<uint32_t>(buf[u].w)};
#pragma unroll
        for (int j = 0; j < kVec; ++j) {
          // decode masks the pattern to its n bits: no sign extension
          const uint32_t word =
              w[j / kPerWord] >> ((j % kPerWord) * 8 * sizeof(S));
          dst[j] = posit::decode_f32(static_cast<int32_t>(word), nbits, es);
        }
      }
    }
  };

  float acc[kMaxOut];
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) acc[j] = 0.0f;
  const int lane = tid & 31, warp = tid >> 5, n_warps = blockDim.x >> 5;

  __syncthreads();
  fetch(kb, 0, bs < T ? bs : T);
  for (int blk = 0; blk < n_blocks; ++blk) {
    const int base = blk * bs;
    // logits of the block, masked
    for (int t0 = 0; t0 < bs; t0 += T) {
      const int rows = bs - t0 < T ? bs - t0 : T;
      decode_tile();
      __syncthreads();
      if (t0 + T < bs) {        // next K tile, else this block's first V
        fetch(kb, base + t0 + T, bs - t0 - T < T ? bs - t0 - T : T);
      } else {
        fetch(vb, base, bs < T ? bs : T);
      }
      for (int i = tid; i < G * rows; i += blockDim.x) {
        const int g = i / rows, r = i - g * rows;
        const float* qg = q_s + g * D;
        const float* kr = t_s + r * (D + 1);
        float dot = 0.0f;
        for (int d = 0; d < D; ++d) dot += qg[d] * kr[d];
        const int pos = base + t0 + r;
        p_s[g * bs + t0 + r] = pos < len ? dot * scale : kNegInf;
      }
      __syncthreads();
    }
    // per query row: new max, p, the carry's alpha and denominator
    for (int g = warp; g < G; g += n_warps) {
      float* pg = p_s + g * bs;
      float mx = kNegInf;
      for (int j = lane; j < bs; j += 32) mx = fmaxf(mx, pg[j]);
      mx = warp_max(mx);
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
      for (int j = lane; j < bs; j += 32) {
        const float p = base + j < len ? expf(pg[j] - m_new) : 0.0f;
        pg[j] = p;
        sum += p;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();
    // p . v over the block, then acc = acc * alpha + p . v
    float pv[kMaxOut];
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j) pv[j] = 0.0f;
    for (int t0 = 0; t0 < bs; t0 += T) {
      const int rows = bs - t0 < T ? bs - t0 : T;
      decode_tile();
      __syncthreads();
      if (t0 + T < bs) {        // next V tile, else the next block's first K
        fetch(vb, base + t0 + T, bs - t0 - T < T ? bs - t0 - T : T);
      } else if (blk + 1 < n_blocks) {
        fetch(kb, base + bs, bs < T ? bs : T);
      }
#pragma unroll
      for (int j = 0; j < kMaxOut; ++j) {
        const int o = tid + j * blockDim.x;
        if (o < GD) {
          const int g = o / D, d = o - g * D;
          const float* pg = p_s + g * bs + t0;
          float s = pv[j];
          for (int r = 0; r < rows; ++r) s += pg[r] * t_s[r * (D + 1) + d];
          pv[j] = s;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < kMaxOut; ++j) {
      const int o = tid + j * blockDim.x;
      if (o < GD) acc[j] = acc[j] * a_s[o / D] + pv[j];
    }
  }
  float* oh = out + static_cast<long long>(blockIdx.x) * GD;
#pragma unroll
  for (int j = 0; j < kMaxOut; ++j) {
    const int o = tid + j * blockDim.x;
    if (o < GD) oh[o] = acc[j] / fmaxf(l_s[o / D], 1e-30f);
  }
}

namespace {
template <typename S>
int launch(const float* q, const void* kb, const void* vb,
           const int* lengths, float* out, int B, int KV, int G, int D,
           int Slen, long long sB, long long sS, long long sH, long long sD,
           int bs, int n_blocks, float scale, int nbits, int es,
           void* stream) {
  const long long e = sizeof(S);
  const int row_bytes = D * static_cast<int>(e);
  const bool aligned =
      sD == 1 && row_bytes % 16 == 0 && (sS * e) % 16 == 0 &&
      (sH * e) % 16 == 0 && (sB * e) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(kb) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(vb) % 16 == 0;
  if (G * D > kThreads * kMaxOut || !aligned)
    return static_cast<int>(cudaErrorInvalidValue);
  // rows per tile: a tile's chunks fit the per-thread register buffer
  const int fit = kMaxChunks * kThreads * 16 / row_bytes;
  const int T = fit < 64 ? fit : 64;
  const size_t smem =
      sizeof(float) * (G * D + T * (D + 1) + G * bs + 3 * G);
  auto kernel = posit_kv_attention_kernel<S>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kernel<<<B * KV, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      q, static_cast<const S*>(kb), static_cast<const S*>(vb), lengths, out,
      KV, G, D, Slen, sB, sS, sH, bs, n_blocks, T, scale, nbits, es);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

extern "C" {

// q, out: (B, KV, G, D) f32 contiguous; k/v bits: (B, S, KV, D) read
// through the element strides (sB, sS, sH, sD), with sD == 1 and every row
// 16-byte aligned (else cudaErrorInvalidValue); lengths: (B,) int32.
// bits_bytes: 1, 2 or 4 (int8/int16/int32 patterns).
int posit_kv_attention(const float* q, const void* kb, const void* vb,
                       const int* lengths, float* out, int B, int KV, int G,
                       int D, int Slen, long long sB, long long sS,
                       long long sH, long long sD, int bs, int n_blocks,
                       float scale, int bits_bytes, int nbits, int es,
                       void* stream) {
  switch (bits_bytes) {
    case 1:
      return launch<int8_t>(q, kb, vb, lengths, out, B, KV, G, D, Slen, sB,
                            sS, sH, sD, bs, n_blocks, scale, nbits, es,
                            stream);
    case 2:
      return launch<int16_t>(q, kb, vb, lengths, out, B, KV, G, D, Slen, sB,
                             sS, sH, sD, bs, n_blocks, scale, nbits, es,
                             stream);
    case 4:
      return launch<int32_t>(q, kb, vb, lengths, out, B, KV, G, D, Slen, sB,
                             sS, sH, sD, bs, n_blocks, scale, nbits, es,
                             stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
