// Posit rounding kernels for Hopper (sm_90a): the elementwise round and the
// rounded radix-2 FFT butterfly.
//
// Replaces repro/kernels/posit_round.py::posit_round_2d (every Arith.rnd of
// the main path) and ::posit_butterfly_2d (one launch per FFT stage).  The
// TPU kernels tile (block_rows, 128) planes for the vector unit and pad the
// input to whole tiles; here a grid-stride loop covers any length, so the
// wrapper neither pads nor slices.
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
// Build with -fmad=false: every product is rounded on its own before the
// add that follows, as in the reference; a contraction would change bits.
#include "posit_math.cuh"

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
