// Rounded matrix product for Hopper (sm_90a): C = round_posit(A[M,K] B[K,N]),
// one wide accumulation per output and one rounding at the end.
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
// Build with -fmad=false: products round before they add, like the plain
// version's reduction, not as fused multiply-adds.
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

}  // extern "C"
