// The R-peak tracker's 1-D 2-means (BayeSlope's stage 3) in one launch.
//
// apps/kmeans.py::kmeans_1d runs the whole 2-means of one reservoir (at
// most 500 scores) as rounded torch ops: the initial rounding, the cold or
// warm start and 12 Lloyd iterations of ~24 small launches each, about 290
// launches and a host copy per ECG window.  Each launch touches a few KB,
// so the host's launches are the whole cost.  This kernel runs all of it
// in one thread block and writes the two centroids: one launch per update.
//
// Every rounded op of kmeans_1d keeps its place, with the posit rounding of
// posit_math.cuh (posit8, posit10 and posit16 are runtime (n, es)):
//   x = rnd(x);
//   cold start: c0 = rnd(lo + (hi - lo) * 0), c1 = rnd(hi), with lo and hi
//   the min and max of x (NaN if any x is NaN), or warm start: rnd(init),
//   the centroids passed by value, never as a device tensor;
//   then each iteration: d_j = |rnd(x - c_j)|, the argmin with torch's
//   semantics (a tie goes to c0; a NaN d0 wins, else a NaN d1 does),
//   cnt_j = max(count_j, 1), and
//   c_j = rnd(sum of rnd(where(a == j, x, 0) / cnt_j)), the sum wide (f32)
//   and rounded once, as Arith.sum does for posits.  A non-member's term is
//   rnd(+0) = +0, which leaves an f32 sum that started at +0 as it was, so
//   each element adds to its own cluster's sum only.
//
// The sum's order is fixed: thread t adds the contributions of elements
// t, t + kThreads, ... in turn, starting from +0, then the kThreads
// partials are added in a tree (s[i] + s[i + h] for h = kThreads/2, ..., 1).
// Where an f32 sum is exact the order cannot matter: the tracker's scores
// lie in the logistic's [0.27, 1] (or are 0), so each cluster's
// contributions span a few binades of short posit fractions and every sum
// is exact.  Only an inexact sum rounded across a posit rounding boundary
// can make a centroid differ from the per-op path's torch.sum.
//
// Bound on the H100: latency, not bytes or operations.  A 500-value
// reservoir is 2 KB; 12 iterations of two passes over it are ~10 k rounded
// ops, done by one block on one SM, with a barrier between the counts and
// the sums and a tree of 9 levels a sum.  The per-op path's cost is its
// ~290 host launches; this kernel's is one launch and its copies.
//
// Build with -fmad=false; each float op is spelled __f*_rn anyway.
#include <math.h>

#include "posit_math.cuh"

constexpr int kThreads = 512;     // the block; the sum's tree has this width

__device__ __forceinline__ float rnd(float v, int nbits, int es) {
  return round_posit_math<float>(v, nbits, es);
}

// 1 where xr is nearer c1 than c0, as torch.argmin(|rnd(x - c)|) picks it.
__device__ __forceinline__ int nearest(float xr, float c0, float c1,
                                       int nbits, int es) {
  const float d0 = fabsf(rnd(__fsub_rn(xr, c0), nbits, es));
  if (isnan(d0)) return 0;
  const float d1 = fabsf(rnd(__fsub_rn(xr, c1), nbits, es));
  return isnan(d1) || d1 < d0;
}

// s[0] <- s[0] + ... + s[kThreads - 1] in the tree's order, s in shared
// memory; every thread of the block calls it, thread 0 has the sum.
__device__ __forceinline__ float tree_sum(float* s, int t) {
  __syncthreads();
  for (int h = kThreads / 2; h >= 32; h >>= 1) {
    if (t < h) s[t] = __fadd_rn(s[t], s[t + h]);
    __syncthreads();
  }
  float v = s[t];
  if (t < 32) {
#pragma unroll
    for (int h = 16; h >= 1; h >>= 1)
      v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, h));
  }
  return v;
}

__global__ void __launch_bounds__(kThreads)
    posit_kmeans_1d_kernel(const float* __restrict__ x, long long n, int iters,
                           int warm, float init0, float init1,
                           float* __restrict__ out, int nbits, int es) {
  __shared__ float part[2][kThreads];
  __shared__ int count1;
  __shared__ float cent_s[2];
  const int t = threadIdx.x;

  float c0, c1;
  if (warm) {
    c0 = rnd(init0, nbits, es);
    c1 = rnd(init1, nbits, es);
  } else {
    float lo = INFINITY, hi = -INFINITY;
    int any_nan = 0;
    for (long long i = t; i < n; i += kThreads) {
      const float v = rnd(x[i], nbits, es);
      any_nan |= isnan(v);
      lo = fminf(lo, v);
      hi = fmaxf(hi, v);
    }
    part[0][t] = lo;
    part[1][t] = hi;
    any_nan = __syncthreads_or(any_nan);
    for (int h = kThreads / 2; h >= 1; h >>= 1) {
      if (t < h) {
        part[0][t] = fminf(part[0][t], part[0][t + h]);
        part[1][t] = fmaxf(part[1][t], part[1][t + h]);
      }
      __syncthreads();
    }
    lo = any_nan ? NAN : part[0][0];
    hi = any_nan ? NAN : part[1][0];
    c0 = rnd(__fadd_rn(lo, __fmul_rn(__fsub_rn(hi, lo), 0.0f)), nbits, es);
    c1 = rnd(hi, nbits, es);
    __syncthreads();              // part is reused below
  }

  for (int it = 0; it < iters; ++it) {
    // pass 1: the elements nearer c1, counted (integers: any order)
    if (t == 0) count1 = 0;
    int local = 0;
    for (long long i = t; i < n; i += kThreads)
      local += nearest(rnd(x[i], nbits, es), c0, c1, nbits, es);
    __syncthreads();
    const int s = __reduce_add_sync(0xffffffffu, local);
    if ((t & 31) == 0 && s) atomicAdd(&count1, s);
    __syncthreads();
    const long long n1 = count1;
    const float cnt0 = static_cast<float>(n - n1 > 1 ? n - n1 : 1);
    const float cnt1 = static_cast<float>(n1 > 1 ? n1 : 1);

    // pass 2: the rounded contributions, summed in the fixed order
    float acc0 = 0.0f, acc1 = 0.0f;
    for (long long i = t; i < n; i += kThreads) {
      const float xr = rnd(x[i], nbits, es);
      if (nearest(xr, c0, c1, nbits, es))
        acc1 = __fadd_rn(acc1, rnd(__fdiv_rn(xr, cnt1), nbits, es));
      else
        acc0 = __fadd_rn(acc0, rnd(__fdiv_rn(xr, cnt0), nbits, es));
    }
    part[0][t] = acc0;
    part[1][t] = acc1;
    const float s0 = tree_sum(part[0], t);
    const float s1 = tree_sum(part[1], t);
    if (t == 0) {
      cent_s[0] = rnd(s0, nbits, es);
      cent_s[1] = rnd(s1, nbits, es);
    }
    __syncthreads();
    c0 = cent_s[0];
    c1 = cent_s[1];
  }
  if (t == 0) {
    out[0] = c0;
    out[1] = c1;
  }
}

extern "C" {

// The two centroids of x[0..n) into out (2 floats on the card); warm: start
// from init0 and init1 (host values), else from the min and max of x.
int posit_kmeans_1d_f32(const float* x, long long n, int iters, int warm,
                        float init0, float init1, float* out, int nbits,
                        int es, void* stream) {
  posit_kmeans_1d_kernel<<<1, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, n, iters, warm, init0, init1, out, nbits, es);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
