// Posit matrix products for Hopper (sm_90a).
//
// 1. The rounded product C = round_posit(A[M,K] B[K,N]), one wide
//    accumulation per output and one rounding at the end.
//
// Replaces repro/kernels/posit_matmul.py::posit_matmul_round_2d, the
// Arith.matmul posit path (mel filterbank 2049->20, DCT 20->13, spectral
// centroid 2049->1, forest votes T->1).  As on the TPU, K stays whole: one
// thread block owns a 16x16 output tile and walks all of K in 32-deep
// slabs staged through shared memory, so nothing is carried between blocks
// and each output is rounded exactly once.
//
// Bound on the H100: memory.  The main-path shapes are tall and skinny
// (N <= 20): 2 M K N flops against 4 (M K + K N + M N) bytes is about 8
// flops per byte for the mel product and under one for the N = 1 rows,
// below the ~20 f32 flops per byte where the card's 67 TFLOP/s of f32
// would take over from its 3.35 TB/s.  A plain tiled loop in the input's
// float type is the simple design; tensor cores (TF32 or wgmma) would
// change the accumulation's precision, not its bound.
// The order of the sum differs from torch.matmul's, so the result agrees
// with round(a @ b) within one format ulp, not bit for bit.
//
// 2. The decode-fused product C[M,N] f32 = decode(A_bits[M,K]) .
//    decode(B_bits[K,N]), the posit bits staying in device memory.
//
// Replaces repro/kernels/posit_matmul.py::posit_matmul (ops.matmul, the
// quickstart's product).  On the TPU each (bm, bk) and (bk, bn) tile of
// bits is decoded in VMEM to bf16 (the MXU's input) and accumulated in f32
// across a sequential K grid axis.  Here one thread block owns a 64x64
// output tile and walks all of K itself in 32-deep slabs: its 256 threads
// load the slab's bits (coalesced along the row), decode them with
// posit_decode.cuh, round each value to bf16 (__float2bfloat16_rn, the
// reference's compute dtype) and stage them in shared memory as f32; each
// thread then accumulates a 4x4 register tile in f32.  A bf16 x bf16
// product is exact in f32, so the fused multiply-add below equals a
// rounded product followed by a rounded add.
//
// Bound on the H100 at the FFN width (64, 4096) . (4096, 12288) posit16:
// the 104 MB of bits and output take 0.031 ms at 3.35 TB/s; the 6.44
// GFLOP take 0.0065 ms on bf16 tensor cores but 0.096 ms in f32 FMAs, so
// this simple f32 design is held by its arithmetic, several times its
// byte bound.  Tensor-core tiles (wgmma) are the redesign's work.
//
// Build with -fmad=false: products round before they add, like the plain
// version's reduction, not as fused multiply-adds (the decode-fused
// product spells out its exact fused multiply-add with __fmaf_rn).
#include <cuda_bf16.h>

#include "posit_decode.cuh"
#include "posit_math.cuh"

namespace {
constexpr int kTM = 16, kTN = 16, kTK = 32;
constexpr int kThreads = kTM * kTN;
}  // namespace

template <typename T>
__global__ void posit_matmul_round_kernel(const T* __restrict__ a,
                                          const T* __restrict__ b,
                                          T* __restrict__ c, int M, int K,
                                          int N, int nbits, int es) {
  __shared__ T a_s[kTM][kTK];
  __shared__ T b_s[kTK][kTN + 1];
  const int tx = threadIdx.x % kTN, ty = threadIdx.x / kTN;
  const int row0 = blockIdx.x * kTM, col0 = blockIdx.y * kTN;
  T acc = T(0);
  for (int k0 = 0; k0 < K; k0 += kTK) {
    for (int t = threadIdx.x; t < kTM * kTK; t += kThreads) {
      const int r = row0 + t / kTK, k = k0 + t % kTK;
      a_s[t / kTK][t % kTK] =
          (r < M && k < K) ? a[static_cast<long long>(r) * K + k] : T(0);
    }
    for (int t = threadIdx.x; t < kTK * kTN; t += kThreads) {
      const int k = k0 + t / kTN, col = col0 + t % kTN;
      b_s[t / kTN][t % kTN] =
          (k < K && col < N) ? b[static_cast<long long>(k) * N + col] : T(0);
    }
    __syncthreads();
    const int kn = K - k0 < kTK ? K - k0 : kTK;
    for (int k = 0; k < kn; ++k) acc = acc + a_s[ty][k] * b_s[k][tx];
    __syncthreads();
  }
  const int row = row0 + ty, col = col0 + tx;
  if (row < M && col < N)
    c[static_cast<long long>(row) * N + col] =
        round_posit_math<T>(acc, nbits, es);
}

namespace {
constexpr int kDM = 64, kDN = 64, kDK = 32;   // decode-fused tile
constexpr int kDThreads = 256;                // 16 x 16, 4 x 4 outputs each
}  // namespace

// The posit value of `raw` rounded to bf16, as f32 (exact).
__device__ __forceinline__ float decode_bf16(int32_t raw, int nbits,
                                             int es) {
  return __bfloat162float(
      __float2bfloat16_rn(posit::decode_f32(raw, nbits, es)));
}

template <typename S>
__global__ void posit_matmul_decode_kernel(const S* __restrict__ a,
                                           const S* __restrict__ b,
                                           float* __restrict__ c, int M,
                                           int K, int N, int nbits, int es) {
  __shared__ float a_s[kDK][kDM + 1];   // transposed: k-major, padded
  __shared__ float b_s[kDK][kDN];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * kDM, col0 = blockIdx.x * kDN;
  float acc[4][4] = {};
  for (int k0 = 0; k0 < K; k0 += kDK) {
    for (int t = threadIdx.x; t < kDM * kDK; t += kDThreads) {
      const int r = t / kDK, k = t % kDK;
      const int gr = row0 + r, gk = k0 + k;
      a_s[k][r] = (gr < M && gk < K)
                      ? decode_bf16(a[static_cast<long long>(gr) * K + gk],
                                    nbits, es)
                      : 0.0f;
    }
    for (int t = threadIdx.x; t < kDK * kDN; t += kDThreads) {
      const int k = t / kDN, col = t % kDN;
      const int gk = k0 + k, gc = col0 + col;
      b_s[k][col] = (gk < K && gc < N)
                        ? decode_bf16(b[static_cast<long long>(gk) * N + gc],
                                      nbits, es)
                        : 0.0f;
    }
    __syncthreads();
    const int kn = K - k0 < kDK ? K - k0 : kDK;
    for (int k = 0; k < kn; ++k) {
      float av[4], bv[4];
      for (int i = 0; i < 4; ++i) av[i] = a_s[k][ty + 16 * i];
      for (int j = 0; j < 4; ++j) bv[j] = b_s[k][tx + 16 * j];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j < 4; ++j)
          acc[i][j] = __fmaf_rn(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= M) continue;
    for (int j = 0; j < 4; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col < N) c[static_cast<long long>(row) * N + col] = acc[i][j];
    }
  }
}

namespace {
template <typename S>
int launch_decode(const void* a, const void* b, float* c, int M, int K,
                  int N, int nbits, int es, void* stream) {
  const dim3 grid((N + kDN - 1) / kDN, (M + kDM - 1) / kDM);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  posit_matmul_decode_kernel<S><<<grid, kDThreads, 0,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(a), static_cast<const S*>(b), c, M, K, N, nbits,
      es);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* a, const T* b, T* c, int M, int K, int N, int nbits,
           int es, void* stream) {
  const dim3 grid((M + kTM - 1) / kTM, (N + kTN - 1) / kTN);
  if (grid.y > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  posit_matmul_round_kernel<T><<<grid, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      a, b, c, M, K, N, nbits, es);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

extern "C" {

int posit_matmul_round_f32(const float* a, const float* b, float* c, int M,
                           int K, int N, int nbits, int es, void* stream) {
  return launch<float>(a, b, c, M, K, N, nbits, es, stream);
}

int posit_matmul_round_f64(const double* a, const double* b, double* c,
                           int M, int K, int N, int nbits, int es,
                           void* stream) {
  return launch<double>(a, b, c, M, K, N, nbits, es, stream);
}

// a, b: posit bits in a signed container of `bits_size` bytes (1, 2, 4).
int posit_matmul_decode(const void* a, const void* b, float* c, int M, int K,
                        int N, int bits_size, int nbits, int es,
                        void* stream) {
  switch (bits_size) {
    case 1:
      return launch_decode<int8_t>(a, b, c, M, K, N, nbits, es, stream);
    case 2:
      return launch_decode<int16_t>(a, b, c, M, K, N, nbits, es, stream);
    case 4:
      return launch_decode<int32_t>(a, b, c, M, K, N, nbits, es, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
