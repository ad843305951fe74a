// Posit rounding on the float's own bits, shared by every kernel of the
// port.  The device twin of repro_torch.core.posit.round_posit_math (and of
// repro/core/posit.py::round_posit_math, which the TPU kernels inline):
// regime run length from the float exponent, integer round-to-nearest-even
// of the float bits at the posit's last kept bit, the pure-regime tie-break
// override, saturation to [minpos, maxpos].  Zero and subnormal inputs give
// +0 (the reference runs on flush-to-zero backends), Inf and NaN give NaN.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

template <typename T> struct PositBits;

template <> struct PositBits<float> {
  using U = uint32_t;
  static constexpr int MBITS = 23, EBITS = 8, BIAS = 127;
  static constexpr U NAN_BITS = 0x7FC00000u;
  __device__ static U to_bits(float x) { return __float_as_uint(x); }
  __device__ static float from_bits(U b) { return __uint_as_float(b); }
};

template <> struct PositBits<double> {
  using U = uint64_t;
  static constexpr int MBITS = 52, EBITS = 11, BIAS = 1023;
  static constexpr U NAN_BITS = 0x7FF8000000000000ull;
  __device__ static U to_bits(double x) {
    return static_cast<U>(__double_as_longlong(x));
  }
  __device__ static double from_bits(U b) {
    return __longlong_as_double(static_cast<long long>(b));
  }
};

// Nearest posit<n, es> value of x, in x's own float type.
template <typename T>
__device__ __forceinline__ T round_posit_math(T x, int n, int es) {
  using B = PositBits<T>;
  using U = typename B::U;
  constexpr int width = 8 * sizeof(U);
  constexpr U sign_mask = U(1) << (width - 1);
  constexpr U one_m = U(1) << B::MBITS;
  constexpr U full_exp = ((U(1) << B::EBITS) - 1) << B::MBITS;
  const int tbits = es + B::MBITS;
  const int max_scale = (n - 2) << es;
  const U minpos_bits = U(B::BIAS - max_scale) << B::MBITS;
  const U maxpos_bits = U(B::BIAS + max_scale) << B::MBITS;

  const U bits = B::to_bits(x);
  const U mag = bits & ~sign_mask;
  if (mag < one_m) return T(0);                       // zero or subnormal
  if (mag >= full_exp) return B::from_bits(B::NAN_BITS);  // Inf or NaN
  const U m = mag < minpos_bits ? minpos_bits
                                : (mag > maxpos_bits ? maxpos_bits : mag);
  const int q = static_cast<int>(m >> B::MBITS) - B::BIAS;  // scale
  const int r = q >> es;                              // regime value (floor)
  const int nr = (r ^ (r >> 31)) + 2;                 // regime bit count
  const int drop = nr + (tbits - (n - 1));            // bits the posit drops
  const bool wide = 2 + tbits - (n - 1) < 1;          // only wide posits
  U out;
  if (wide && drop < 1) {
    out = m;                                          // exact
  } else {
    const int dropc = drop < tbits ? drop : tbits;
    const U adj = m + one_m;                          // bias+1 alignment
    const U half = U(1) << (dropc - 1);
    // pure-regime patterns: the last kept bit is the regime's low bit
    const U lsb = drop < tbits ? (adj >> dropc) & U(1) : U(r < 0);
    out = ((adj + (half - 1) + lsb) & ~((half << 1) - 1)) - one_m;
  }
  return B::from_bits(out | (bits & sign_mask));
}

// Blocks for a grid-stride loop over n elements: enough to fill the card's
// 132 SMs several times over, never more than the work.
inline unsigned grid_for(long long n, int threads) {
  const long long blocks = (n + threads - 1) / threads;
  return static_cast<unsigned>(blocks < 132 * 16 ? blocks : 132 * 16);
}
