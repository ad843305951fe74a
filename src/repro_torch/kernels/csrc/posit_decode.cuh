// Posit codec device functions, shared by the codec kernels
// (posit_codec.cu) and the posit-KV attention kernel
// (posit_kv_attention.cu), which decodes its K/V tiles with the same
// function, as the TPU kernels inline repro/kernels/common.py::decode_tile.
//
// Decode is the device twin of common.py::decode_tile (and of
// repro_torch.core.posit.decode): regime run length by __clz in place of
// the smear+popcount, scale clipped to [-126, 127], NaR -> NaN, pattern 0
// -> +0.  Encode is the twin of common.py::encode_tile: RNE on the posit
// lattice, saturating to [minpos, maxpos], -0 -> 0, Inf/NaN -> NaR.  A
// zero or subnormal input is tested by its exponent field, so encode(1e-40)
// is pattern 0 as on the flush-to-zero backends the reference runs on.
#pragma once

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace posit {

constexpr uint32_t kNanF32 = 0x7FC00000u;

// Value of the n-bit posit pattern held in the low bits of `raw` (any
// signed container, sign-extended), as f32.
__device__ __forceinline__ float decode_f32(int32_t raw, int n, int es) {
  const uint32_t mask = n == 32 ? 0xFFFFFFFFu : (1u << n) - 1u;
  const uint32_t x = static_cast<uint32_t>(raw) & mask;
  if (x == 0u) return 0.0f;
  if (x == (1u << (n - 1))) return __uint_as_float(kNanF32);
  const uint32_t sign = (x >> (n - 1)) & 1u;
  const uint32_t mag = sign ? (~x + 1u) & mask : x;
  const uint32_t y = mag << (33 - n);         // n-1 bits under the sign
  const uint32_t r0 = y >> 31;
  const uint32_t inv = r0 ? ~y : y;
  int k = __clz(static_cast<int>(inv));       // regime run length
  k = k < n - 1 ? k : n - 1;
  const int r = r0 ? k - 1 : -k;
  const uint32_t z = k + 1 >= 32 ? 0u : y << (k + 1);
  const int e = es > 0 ? static_cast<int>(z >> (32 - es)) : 0;
  const uint32_t frac_top = es > 0 ? z << es : z;
  int scale = r * (1 << es) + e;
  scale = scale < -126 ? -126 : (scale > 127 ? 127 : scale);
  const float f = static_cast<float>(frac_top) * 2.3283064365386963e-10f;
  const float pw = __uint_as_float(static_cast<uint32_t>(scale + 127) << 23);
  const float val = (1.0f + f) * pw;
  return sign ? -val : val;
}

// n-bit posit pattern of the f32 `v` (low n bits of the returned word).
// Needs (n - 2) << es <= 126, so that minpos and maxpos are normal f32.
__device__ __forceinline__ uint32_t encode_f32(float v, int n, int es) {
  const uint32_t u = __float_as_uint(v);
  const uint32_t exp_field = (u >> 23) & 0xFFu;
  if (exp_field == 0u) return 0u;                     // +-0 or subnormal
  if (exp_field == 0xFFu) return 1u << (n - 1);       // Inf or NaN -> NaR
  const uint32_t mask = n == 32 ? 0xFFFFFFFFu : (1u << n) - 1u;
  const int max_scale = (n - 2) << es;
  const uint32_t minpos_bits = static_cast<uint32_t>(127 - max_scale) << 23;
  const uint32_t maxpos_bits = static_cast<uint32_t>(127 + max_scale) << 23;
  uint32_t a = u & 0x7FFFFFFFu;                       // clamp |v|
  a = a < minpos_bits ? minpos_bits : (a > maxpos_bits ? maxpos_bits : a);
  const int tbits = es + 23;
  const uint32_t man = a & 0x7FFFFFu;
  const int q = static_cast<int>(a >> 23) - 127;      // power-of-two scale
  const int r = q >> es;                              // floor division
  const uint32_t e = static_cast<uint32_t>(q - (r << es));
  const uint32_t R = r >= 0 ? ((1u << (r + 1)) - 1u) << 1 : 1u;
  const int nR = r >= 0 ? r + 2 : 1 - r;              // regime bit count
  const uint32_t T = (e << 23) | man;                 // exponent ++ fraction
  const int shift = nR + tbits - (n - 1);             // bits dropped
  uint32_t body;
  uint32_t g = 0u;
  bool st = false;
  if (shift <= 0) {
    body = (R << (tbits - shift)) | (T << -shift);
  } else if (shift <= tbits) {
    body = (R << (tbits - shift)) | (T >> shift);
    g = (T >> (shift - 1)) & 1u;
    st = (T & ((1u << (shift - 1)) - 1u)) != 0u;
  } else {
    body = R >> (shift - tbits);
  }
  body += g & (static_cast<uint32_t>(st) | (body & 1u));
  const uint32_t maxpos_pattern = (1u << (n - 1)) - 1u;
  body = body > maxpos_pattern ? maxpos_pattern : (body < 1u ? 1u : body);
  return (u >> 31) ? (~body + 1u) & mask : body;
}

}  // namespace posit
