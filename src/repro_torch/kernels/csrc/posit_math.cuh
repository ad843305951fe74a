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

// How a flat run of n elements of `size` bytes at `p` splits into vectors
// of `per` elements (per * size bytes, a power of two up to 16): `head`
// elements before the first vector boundary, then `n_vec` whole vectors,
// then `tail` elements (the kernels take the head and the tail one
// element per thread).  Mirrored for the tests by
// kernels/posit_codec.py::vector_plan.
struct VecPlan {
  long long head, n_vec, tail;
};

inline VecPlan vec_plan(const void* p, long long n, int size, int per) {
  const long long bytes = static_cast<long long>(per) * size;
  const long long mis =
      static_cast<long long>(reinterpret_cast<uintptr_t>(p) % bytes);
  long long head = mis ? (bytes - mis) / size : 0;
  head = head < n ? head : n;
  const long long n_vec = (n - head) / per;
  return {head, n_vec, n - head - n_vec * per};
}

// Whether an output of `out_size` bytes per element takes each vector's
// `per` values in one aligned store at the plan's vectors.
inline bool vec_store_ok(const void* out, long long head, int out_size,
                         int per) {
  return (reinterpret_cast<uintptr_t>(out) + head * out_size) %
             (static_cast<long long>(per) * out_size) == 0;
}

// Blocks of `threads` threads (with `smem` bytes of dynamic shared memory)
// for `work` units of one thread each: the work's blocks, at most one wave
// of `kernel`'s resident blocks on every SM of the card (the first card
// asked; the occupancy is asked once per kernel and shared-memory size).
template <auto kernel>
unsigned wave_blocks(int threads, size_t smem, long long work) {
  static int sms = 0;
  static int per_sm = 0;
  static size_t asked_smem = ~size_t(0);
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  if (asked_smem != smem) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                  smem);
    asked_smem = smem;
  }
  const long long wave = static_cast<long long>(sms) *
                         (per_sm > 0 ? per_sm : 1);
  long long blocks = (work + threads - 1) / threads;
  blocks = blocks < 1 ? 1 : blocks;
  return static_cast<unsigned>(blocks < wave ? blocks : wave);
}
