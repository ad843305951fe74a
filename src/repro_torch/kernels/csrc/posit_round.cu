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
// The rounding is ~30 integer ops per value, far below the card's integer
// rate per byte moved at 3.35 TB/s, so one pass with coalesced loads is the
// design; nothing is staged in shared memory because nothing is reused.
//
// The butterfly reads its twiddles through (inner, length): element i uses
// w[(i / inner) % length].  That is how both Stockham layouts broadcast a
// stage's twiddles, so the wrapper passes the plan's 1-D tables as they
// are and never expands them to the plane's size.
//
// The multiply-add reads its three operands through broadcast strides
// (stride 0 along a broadcast axis), so a scalar or a row broadcast against
// a plane is read in place, never expanded in device memory; operands that
// already have the output's shape take a flat path with no index
// arithmetic.  Bound: memory, 16 bytes per f32 element with all three
// operands full size.
//
// Build with -fmad=false: every product is rounded on its own before the
// add that follows, as in the reference; a contraction would change bits.
// The multiply-add spells its two roundings out with __fmul_rn/__fadd_rn,
// which the compiler never contracts, flag or no flag.
#include "posit_math.cuh"

constexpr int kMaxDims = 8;

// Output shape and each operand's element strides over it; nd == 0 means
// every operand is contiguous in the output's shape.
struct Bcast {
  int nd;
  long long shape[kMaxDims];
  long long stride[3][kMaxDims];
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

template <typename T>
__global__ void posit_round_kernel(const T* __restrict__ x,
                                   T* __restrict__ y, long long n, int nbits,
                                   int es) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    y[i] = round_posit_math<T>(x[i], nbits, es);
  }
}

template <typename T>
__global__ void posit_fma_round_kernel(const T* __restrict__ a,
                                       const T* __restrict__ b,
                                       const T* __restrict__ c,
                                       T* __restrict__ y, long long n,
                                       Bcast g, int nbits, int es) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    long long oa = i, ob = i, oc = i;
    if (g.nd > 0) {
      oa = ob = oc = 0;
      long long rest = i;
      for (int d = g.nd - 1; d >= 0; --d) {
        const long long idx = rest % g.shape[d];
        rest /= g.shape[d];
        oa += idx * g.stride[0][d];
        ob += idx * g.stride[1][d];
        oc += idx * g.stride[2][d];
      }
    }
    y[i] = round_posit_math<T>(add_rn(mul_rn(a[oa], b[ob]), c[oc]), nbits,
                               es);
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

template <typename T>
int launch_round(const T* x, T* y, long long n, int nbits, int es,
                 void* stream) {
  posit_round_kernel<T><<<grid_for(n, kThreads), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(x, y, n, nbits,
                                                               es);
  return static_cast<int>(cudaGetLastError());
}

// geom: nd, then the output shape, then the three operands' strides,
// each kMaxDims long (unused tail entries ignored).
template <typename T>
int launch_fma(const T* a, const T* b, const T* c, T* y, long long n,
               const long long* geom, int nbits, int es, void* stream) {
  Bcast g;
  g.nd = static_cast<int>(geom[0]);
  if (g.nd < 0 || g.nd > kMaxDims)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int d = 0; d < kMaxDims; ++d) {
    g.shape[d] = geom[1 + d];
    for (int k = 0; k < 3; ++k)
      g.stride[k][d] = geom[1 + (k + 1) * kMaxDims + d];
  }
  posit_fma_round_kernel<T><<<grid_for(n, kThreads), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      a, b, c, y, n, g, nbits, es);
  return static_cast<int>(cudaGetLastError());
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

extern "C" {

int posit_round_f32(const float* x, float* y, long long n, int nbits, int es,
                    void* stream) {
  return launch_round<float>(x, y, n, nbits, es, stream);
}

int posit_round_f64(const double* x, double* y, long long n, int nbits,
                    int es, void* stream) {
  return launch_round<double>(x, y, n, nbits, es, stream);
}

int posit_fma_round_f32(const float* a, const float* b, const float* c,
                        float* y, long long n, const long long* geom,
                        int nbits, int es, void* stream) {
  return launch_fma<float>(a, b, c, y, n, geom, nbits, es, stream);
}

int posit_fma_round_f64(const double* a, const double* b, const double* c,
                        double* y, long long n, const long long* geom,
                        int nbits, int es, void* stream) {
  return launch_fma<double>(a, b, c, y, n, geom, nbits, es, stream);
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
