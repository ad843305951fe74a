// Posit rounding kernels for Hopper (sm_90a): the elementwise round, the
// rounded multiply-add and the rounded radix-2 FFT butterfly.
//
// Replaces repro/kernels/posit_round.py::posit_round_2d (every Arith.rnd of
// the main path), ::posit_fma_round_2d (Arith.fma) and ::posit_butterfly_2d
// (one launch per FFT stage).  The TPU kernels tile (block_rows, 128)
// planes for the vector unit and pad every operand to whole tiles; here a
// grid-stride loop covers any length, so the wrappers neither pad nor
// slice.
//
// Bound on the H100: memory.  The round reads and writes 4 bytes per f32
// element (8 for f64); the butterfly moves 40 bytes per f32 element (four
// planes in, four out; the twiddle tables are a few KB and stay in cache).
// The rounding is ~30 integer ops per value, below the card's integer
// rate per byte moved at 3.35 TB/s, so one pass with coalesced loads is the
// design; nothing is staged in shared memory because nothing is reused.
// The round loads and stores 16 bytes a thread (float4, double2), with the
// elements before the input's first 16-byte boundary and after its last
// whole vector taken one per thread, and its grid is the work's blocks, at
// most one wave of resident blocks.  Most of its launches are on small
// arrays (the 2-means' scalars and rows), where a call's cost is the
// host's: the wrapper (kernels/posit_round.py) binds its entry points once
// and reads the stream as a raw handle.
//
// The butterfly reads its twiddles through (inner, length): element i uses
// w[(i / inner) % length].  That is how both Stockham layouts broadcast a
// stage's twiddles, so the wrapper passes the plan's 1-D tables as they
// are and never expands them to the plane's size.
//
// The multiply-add (bound: memory, 16 bytes per f32 element with all three
// operands full size) has two paths.  Flat, where every operand is either
// contiguous in the output's shape or 0-d: 16-byte loads, split into a
// head, whole vectors and a tail as the round's by the operands' common
// offset within 16 bytes, the results stored 16 bytes at a time where the
// output shares that offset and one value at a time where not; one value a
// thread where the operands differ in 16-byte alignment.  Broadcast
// otherwise: each operand read through its strides over the output's
// dimensions (stride 0 along a broadcast axis), after the wrapper has
// merged the dimensions that are contiguous for all three; 32-bit indices
// where the output and every operand's reach stay below 2^31 elements.  A 0-d operand from the host comes by value (a null
// pointer beside it) and is never copied to the card.  Most calls are
// short, so the wrapper (kernels/posit_round.py) keeps its host path
// short: entry points bound once, the stream read as a raw handle, the
// geometry built only for the broadcast path.
//
// Build with -fmad=false: every product is rounded on its own before the
// add that follows, as in the reference; a contraction would change bits.
// The multiply-add spells its two roundings out with __fmul_rn/__fadd_rn,
// which the compiler never contracts, flag or no flag.
#include "posit_math.cuh"

constexpr int kMaxDims = 8;

// Output shape and each operand's element strides over it, in index type I.
template <typename I>
struct Bcast {
  int nd;
  I shape[kMaxDims];
  I stride[3][kMaxDims];
};

__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}

template <typename T> struct Vec16;
template <> struct Vec16<float> {
  using V = float4;
  __device__ static V round(V a, int n, int es) {
    return make_float4(round_posit_math(a.x, n, es),
                       round_posit_math(a.y, n, es),
                       round_posit_math(a.z, n, es),
                       round_posit_math(a.w, n, es));
  }
  __device__ static V splat(float v) { return make_float4(v, v, v, v); }
};
template <> struct Vec16<double> {
  using V = double2;
  __device__ static V round(V a, int n, int es) {
    return make_double2(round_posit_math(a.x, n, es),
                        round_posit_math(a.y, n, es));
  }
  __device__ static V splat(double v) { return make_double2(v, v); }
};

// The plan's head and tail one element per thread (of the first head +
// tail threads), its n_vec 16-byte vectors in a grid-stride loop; where y
// is not 16-byte aligned at those vectors (x and y at offsets that differ
// modulo 16 bytes), each vector's values are stored one at a time.
template <typename T, bool kVecStore>
__global__ void posit_round_kernel(const T* __restrict__ x,
                                   T* __restrict__ y, long long head,
                                   long long n_vec, long long tail,
                                   int nbits, int es) {
  using V = typename Vec16<T>::V;
  constexpr int kPer = 16 / sizeof(T);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t0 =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t0 < head + tail) {
    const long long i = t0 < head ? t0 : head + n_vec * kPer + (t0 - head);
    y[i] = round_posit_math<T>(x[i], nbits, es);
  }
  const V* vx = reinterpret_cast<const V*>(x + head);
  for (long long v = t0; v < n_vec; v += stride) {
    const V r = Vec16<T>::round(vx[v], nbits, es);
    if constexpr (kVecStore) {
      reinterpret_cast<V*>(y + head)[v] = r;
    } else {
      const T* e = reinterpret_cast<const T*>(&r);
#pragma unroll
      for (int k = 0; k < kPer; ++k) y[head + v * kPer + k] = e[k];
    }
  }
}

template <typename T>
__device__ __forceinline__ T fma_round(T a, T b, T c, int nbits, int es) {
  return round_posit_math<T>(add_rn(mul_rn(a, b), c), nbits, es);
}

// A multiply-add operand: a pointer, or a 0-d value where it is null.
template <typename T>
struct Operand {
  const T* p;
  T v;
  template <typename I>
  __device__ __forceinline__ T at(I i) const { return p ? __ldg(p + i) : v; }
  __device__ __forceinline__ typename Vec16<T>::V vec(long long i) const {
    using V = typename Vec16<T>::V;
    return p ? __ldg(reinterpret_cast<const V*>(p + i)) : Vec16<T>::splat(v);
  }
};

// Flat path: kVec, the plan's head and tail one value per thread (of the
// first head + tail threads) and its n_vec 16-byte vectors of the operands
// in a grid-stride loop, each vector's results stored whole (kVecStore,
// where y is 16-byte aligned at the vectors) or one value at a time;
// otherwise (head = n) every value one a thread, grid-stride.
template <typename T, bool kVec, bool kVecStore>
__global__ void posit_fma_round_flat_kernel(Operand<T> a, Operand<T> b,
                                            Operand<T> c, T* __restrict__ y,
                                            long long head, long long n_vec,
                                            long long tail, int nbits,
                                            int es) {
  using V = typename Vec16<T>::V;
  constexpr int kPer = 16 / sizeof(T);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t0 =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if constexpr (!kVec) {
    for (long long i = t0; i < head; i += stride)
      y[i] = fma_round(a.at(i), b.at(i), c.at(i), nbits, es);
  } else {
    if (t0 < head + tail) {
      const long long i = t0 < head ? t0 : head + n_vec * kPer + (t0 - head);
      y[i] = fma_round(a.at(i), b.at(i), c.at(i), nbits, es);
    }
    for (long long v = t0; v < n_vec; v += stride) {
      const long long i = head + v * kPer;
      const V va = a.vec(i), vb = b.vec(i), vc = c.vec(i);
      const T* ea = reinterpret_cast<const T*>(&va);
      const T* eb = reinterpret_cast<const T*>(&vb);
      const T* ec = reinterpret_cast<const T*>(&vc);
      V r;
      T* er = reinterpret_cast<T*>(&r);
#pragma unroll
      for (int k = 0; k < kPer; ++k)
        er[k] = fma_round(ea[k], eb[k], ec[k], nbits, es);
      if constexpr (kVecStore) {
        *reinterpret_cast<V*>(y + i) = r;
      } else {
#pragma unroll
        for (int k = 0; k < kPer; ++k) y[i + k] = er[k];
      }
    }
  }
}

// Broadcast path over the merged geometry, index type I (unsigned below
// 2^31 elements, so i + stride never wraps).
template <typename T, typename I>
__global__ void posit_fma_round_bcast_kernel(Operand<T> a, Operand<T> b,
                                             Operand<T> c, T* __restrict__ y,
                                             I n, Bcast<I> g, int nbits,
                                             int es) {
  const I stride = static_cast<I>(gridDim.x) * blockDim.x;
  for (I i = static_cast<I>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    I oa = 0, ob = 0, oc = 0, rest = i;
    for (int d = g.nd - 1; d >= 0; --d) {
      const I idx = rest % g.shape[d];
      rest /= g.shape[d];
      oa += idx * g.stride[0][d];
      ob += idx * g.stride[1][d];
      oc += idx * g.stride[2][d];
    }
    y[i] = fma_round(a.at(oa), b.at(ob), c.at(oc), nbits, es);
  }
}

template <typename T>
__global__ void posit_butterfly_kernel(
    const T* __restrict__ e_re, const T* __restrict__ e_im,
    const T* __restrict__ o_re, const T* __restrict__ o_im,
    const T* __restrict__ w_re, const T* __restrict__ w_im,
    T* __restrict__ u_re, T* __restrict__ u_im, T* __restrict__ v_re,
    T* __restrict__ v_im, long long n, long long tw_inner, long long tw_len,
    int nbits, int es) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    const long long j = (i / tw_inner) % tw_len;
    const T wr = w_re[j], wi = w_im[j];
    const T a = o_re[i], b = o_im[i];
    const T t_r = round_posit_math<T>(round_posit_math<T>(wr * a, nbits, es) -
                                          round_posit_math<T>(wi * b, nbits, es),
                                      nbits, es);
    const T t_i = round_posit_math<T>(round_posit_math<T>(wr * b, nbits, es) +
                                          round_posit_math<T>(wi * a, nbits, es),
                                      nbits, es);
    const T er = e_re[i], ei = e_im[i];
    u_re[i] = round_posit_math<T>(er + t_r, nbits, es);
    u_im[i] = round_posit_math<T>(ei + t_i, nbits, es);
    v_re[i] = round_posit_math<T>(er - t_r, nbits, es);
    v_im[i] = round_posit_math<T>(ei - t_i, nbits, es);
  }
}

namespace {
constexpr int kThreads = 256;

template <typename T, bool kVecStore>
int launch_round_as(const T* x, T* y, const VecPlan& p, int nbits, int es,
                    cudaStream_t stream) {
  constexpr auto kernel = posit_round_kernel<T, kVecStore>;
  const long long work = p.n_vec > p.head + p.tail ? p.n_vec
                                                    : p.head + p.tail;
  kernel<<<wave_blocks<kernel>(kThreads, 0, work), kThreads, 0, stream>>>(
      x, y, p.head, p.n_vec, p.tail, nbits, es);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_round(const T* x, T* y, long long n, int nbits, int es,
                 void* stream) {
  if (reinterpret_cast<uintptr_t>(x) % sizeof(T) != 0 ||
      reinterpret_cast<uintptr_t>(y) % sizeof(T) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int kPer = 16 / sizeof(T);
  const VecPlan p = vec_plan(x, n, sizeof(T), kPer);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return vec_store_ok(y, p.head, sizeof(T), kPer)
             ? launch_round_as<T, true>(x, y, p, nbits, es, st)
             : launch_round_as<T, false>(x, y, p, nbits, es, st);
}

template <typename T, bool kVec, bool kVecStore>
int launch_fma_flat_as(Operand<T> a, Operand<T> b, Operand<T> c, T* y,
                       const VecPlan& p, int nbits, int es,
                       cudaStream_t stream) {
  constexpr auto kernel = posit_fma_round_flat_kernel<T, kVec, kVecStore>;
  const long long work = p.n_vec > p.head + p.tail ? p.n_vec
                                                    : p.head + p.tail;
  kernel<<<wave_blocks<kernel>(kThreads, 0, work), kThreads, 0, stream>>>(
      a, b, c, y, p.head, p.n_vec, p.tail, nbits, es);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename I>
int launch_fma_bcast(Operand<T> a, Operand<T> b, Operand<T> c, T* y,
                     long long n, const long long* geom, int nbits, int es,
                     cudaStream_t stream) {
  Bcast<I> g;
  g.nd = static_cast<int>(geom[0]);
  for (int d = 0; d < kMaxDims; ++d) {
    g.shape[d] = static_cast<I>(geom[1 + d]);
    for (int k = 0; k < 3; ++k)
      g.stride[k][d] = static_cast<I>(geom[1 + (k + 1) * kMaxDims + d]);
  }
  constexpr auto kernel = posit_fma_round_bcast_kernel<T, I>;
  kernel<<<wave_blocks<kernel>(kThreads, 0, n), kThreads, 0, stream>>>(
      a, b, c, y, static_cast<I>(n), g, nbits, es);
  return static_cast<int>(cudaGetLastError());
}

// a, b, c: pointers, each null where its operand is 0-d and comes by value
// (sa, sb, sc).  geom null: the flat path; else nd, the output shape and
// the three operands' strides, each kMaxDims long (unused entries
// ignored).
template <typename T>
int launch_fma(const T* a, const T* b, const T* c, T sa, T sb, T sc, T* y,
               long long n, const long long* geom, int nbits, int es,
               void* stream) {
  const Operand<T> oa{a, sa}, ob{b, sb}, oc{c, sc};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (geom != nullptr) {
    const int nd = static_cast<int>(geom[0]);
    if (nd < 0 || nd > kMaxDims)
      return static_cast<int>(cudaErrorInvalidValue);
    // 32-bit indices where every index and every operand offset fits
    long long span = n;
    for (int k = 0; k < 3; ++k) {
      long long last = 0;
      for (int d = 0; d < nd; ++d)
        last += (geom[1 + d] - 1) * geom[1 + (k + 1) * kMaxDims + d];
      span = last + 1 > span ? last + 1 : span;
    }
    return span < (1ll << 31)
               ? launch_fma_bcast<T, unsigned>(oa, ob, oc, y, n, geom, nbits,
                                               es, st)
               : launch_fma_bcast<T, long long>(oa, ob, oc, y, n, geom,
                                                nbits, es, st);
  }
  // vectors where the operands read through pointers share one offset
  // within 16 bytes (the plan's head from it), stored whole where y has
  // that offset too
  const T* ref = a ? a : (b ? b : (c ? c : y));
  const uintptr_t mis = reinterpret_cast<uintptr_t>(ref) % 16;
  auto alike = [mis](const T* q) {
    return q == nullptr || reinterpret_cast<uintptr_t>(q) % 16 == mis;
  };
  constexpr int kPer = 16 / sizeof(T);
  const VecPlan p = vec_plan(ref, n, sizeof(T), kPer);
  if (alike(a) && alike(b) && alike(c) && mis % sizeof(T) == 0 &&
      p.n_vec > 0)
    return vec_store_ok(y, p.head, sizeof(T), kPer)
               ? launch_fma_flat_as<T, true, true>(oa, ob, oc, y, p, nbits,
                                                   es, st)
               : launch_fma_flat_as<T, true, false>(oa, ob, oc, y, p, nbits,
                                                    es, st);
  return launch_fma_flat_as<T, false, false>(oa, ob, oc, y, VecPlan{n, 0, 0},
                                             nbits, es, st);
}

template <typename T>
int launch_butterfly(const T* er, const T* ei, const T* o_r, const T* oi,
                     const T* wr, const T* wi, T* ur, T* ui, T* vr, T* vi,
                     long long n, long long tw_inner, long long tw_len,
                     int nbits, int es, void* stream) {
  posit_butterfly_kernel<T><<<grid_for(n, kThreads), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      er, ei, o_r, oi, wr, wi, ur, ui, vr, vi, n, tw_inner, tw_len, nbits, es);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

__global__ void empty_kernel() {}

extern "C" {

// An empty kernel's launch: the floor of a wrapper's cost per call.
int posit_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

int posit_round_f32(const float* x, float* y, long long n, int nbits, int es,
                    void* stream) {
  return launch_round<float>(x, y, n, nbits, es, stream);
}

int posit_round_f64(const double* x, double* y, long long n, int nbits,
                    int es, void* stream) {
  return launch_round<double>(x, y, n, nbits, es, stream);
}

int posit_fma_round_f32(const float* a, const float* b, const float* c,
                        float sa, float sb, float sc, float* y, long long n,
                        const long long* geom, int nbits, int es,
                        void* stream) {
  return launch_fma<float>(a, b, c, sa, sb, sc, y, n, geom, nbits, es,
                           stream);
}

int posit_fma_round_f64(const double* a, const double* b, const double* c,
                        double sa, double sb, double sc, double* y,
                        long long n, const long long* geom, int nbits, int es,
                        void* stream) {
  return launch_fma<double>(a, b, c, sa, sb, sc, y, n, geom, nbits, es,
                            stream);
}

int posit_butterfly_f32(const float* er, const float* ei, const float* o_r,
                        const float* oi, const float* wr, const float* wi,
                        float* ur, float* ui, float* vr, float* vi,
                        long long n, long long tw_inner, long long tw_len,
                        int nbits, int es, void* stream) {
  return launch_butterfly<float>(er, ei, o_r, oi, wr, wi, ur, ui, vr, vi, n,
                                 tw_inner, tw_len, nbits, es, stream);
}

int posit_butterfly_f64(const double* er, const double* ei, const double* o_r,
                        const double* oi, const double* wr, const double* wi,
                        double* ur, double* ui, double* vr, double* vi,
                        long long n, long long tw_inner, long long tw_len,
                        int nbits, int es, void* stream) {
  return launch_butterfly<double>(er, ei, o_r, oi, wr, wi, ur, ui, vr, vi, n,
                                  tw_inner, tw_len, nbits, es, stream);
}

}  // extern "C"
