// Posit codec for Hopper (sm_90a): decode (posit bits -> f32/bf16) and
// encode (f32 -> posit bits, RNE, saturating), elementwise over any shape.
//
// Replaces repro/kernels/posit_decode.py::posit_decode_2d and
// repro/kernels/posit_encode.py::posit_encode_2d (the TPU's tile-wise
// codec around common.py's decode_tile / encode_tile).  On the serve path
// decode turns every posit16 weight matrix into bf16 before its product,
// the embedding rows and, on the plain route, the KV cache; encode writes
// every K/V position into the posit cache and quantizes the weights once.
//
// Bound on the H100: memory.  Decode moves 2 + 2 bytes per element for
// int16 -> bf16 (a few dozen integer operations each, far below the card's
// integer rate), encode 4 + 2 for f32 -> int16.  One thread per element in
// a grid-stride loop; neighbouring threads touch neighbouring elements, so
// every load and store is coalesced.  A bf16 output is rounded from the
// f32 value in the register (__float2bfloat16_rn), which equals the
// reference's decode(f32).astype(bf16) in one pass.
#include <type_traits>

#include "posit_decode.cuh"
#include "posit_math.cuh"

template <typename S, typename O>
__global__ void posit_decode_kernel(const S* __restrict__ bits,
                                    O* __restrict__ out, long long n,
                                    int nbits, int es) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += stride) {
    const float v = posit::decode_f32(static_cast<int32_t>(bits[i]), nbits,
                                      es);
    if constexpr (sizeof(O) == 4) {
      out[i] = v;
    } else {
      out[i] = __float2bfloat16_rn(v);
    }
  }
}

template <typename S>
__global__ void posit_encode_kernel(const float* __restrict__ x,
                                    S* __restrict__ out, long long n,
                                    int nbits, int es) {
  using U = typename std::make_unsigned<S>::type;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < n; i += stride) {
    // two's-complement wrap to the container: NaR of posit8 lands as -128
    out[i] = static_cast<S>(static_cast<U>(posit::encode_f32(x[i], nbits,
                                                             es)));
  }
}

namespace {
constexpr int kThreads = 256;

template <typename S, typename O>
int launch_decode(const void* bits, void* out, long long n, int nbits,
                  int es, void* stream) {
  posit_decode_kernel<S, O><<<grid_for(n, kThreads), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const S*>(bits), static_cast<O*>(out), n, nbits, es);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_decode_to(const void* bits, void* out, long long n, int out_bf16,
                     int nbits, int es, void* stream) {
  return out_bf16 ? launch_decode<S, __nv_bfloat16>(bits, out, n, nbits, es,
                                                    stream)
                  : launch_decode<S, float>(bits, out, n, nbits, es, stream);
}

template <typename S>
int launch_encode(const float* x, void* out, long long n, int nbits, int es,
                  void* stream) {
  posit_encode_kernel<S><<<grid_for(n, kThreads), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<S*>(out), n, nbits, es);
  return static_cast<int>(cudaGetLastError());
}
}  // namespace

extern "C" {

// bits_bytes: 1, 2 or 4 (int8/int16/int32 patterns); out_bf16: 0 -> f32.
int posit_decode(const void* bits, void* out, long long n, int bits_bytes,
                 int out_bf16, int nbits, int es, void* stream) {
  switch (bits_bytes) {
    case 1:
      return launch_decode_to<int8_t>(bits, out, n, out_bf16, nbits, es,
                                      stream);
    case 2:
      return launch_decode_to<int16_t>(bits, out, n, out_bf16, nbits, es,
                                       stream);
    case 4:
      return launch_decode_to<int32_t>(bits, out, n, out_bf16, nbits, es,
                                       stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// out_bytes: 1, 2 or 4, the format's storage container.
int posit_encode(const float* x, void* out, long long n, int out_bytes,
                 int nbits, int es, void* stream) {
  switch (out_bytes) {
    case 1:
      return launch_encode<int8_t>(x, out, n, nbits, es, stream);
    case 2:
      return launch_encode<int16_t>(x, out, n, nbits, es, stream);
    case 4:
      return launch_encode<int32_t>(x, out, n, nbits, es, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
