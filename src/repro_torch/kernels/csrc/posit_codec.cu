// Posit codec for Hopper (sm_90a): decode (posit bits -> f32/bf16) and
// encode (f32 -> posit bits, RNE, saturating), elementwise over any shape.
//
// Replaces repro/kernels/posit_decode.py::posit_decode_2d and
// repro/kernels/posit_encode.py::posit_encode_2d (the TPU's tile-wise
// codec around common.py's decode_tile / encode_tile).  On the serve path
// decode turns every posit16 weight matrix into bf16 before its product,
// the embedding rows and, on the plain route, the KV cache; encode
// quantizes the weights once, and its KV-append form (below) writes every
// K/V position into the posit cache.
//
// Decode.  Bound on the H100: memory, 2 + 2 bytes per element for int16 ->
// bf16, once the decode itself is cheap enough.  The arithmetic decoder
// (posit_decode.cuh, ~30 integer operations a value) is not: at one value
// per thread it ran at 46 % of the byte bound, held by the integer ALUs.
// So a posit of n <= 16 bits is decoded by table lookup:
//  * a table of the values of the 2^(n-1) non-negative patterns, in the
//    output type, then one entry for NaR (a NaN with the sign bit set); a
//    pattern p reads entry |p| (p sign-extended from n bits) and flips the
//    sign bit if p < 0, which gives -value for a negative pattern (posit
//    negation is two's complement) and a positive NaN for NaR.  posit16:
//    64 KB in bf16, 128 KB in f32;
//  * the table is built once per (card, n, es, output type) by
//    posit_decode_table_kernel (the arithmetic decoder, so the values are
//    the old kernel's bit for bit) and cached by the wrapper; each block
//    copies it into shared memory with cp.async, while its first loads
//    are already in flight;
//  * every thread takes a vector of kPer = 16 / max(pattern, output size)
//    elements: one load and one store, each at most 16 bytes and
//    contiguous across the warp (8 int16 -> 8 bf16 is 16 bytes each way;
//    4 int16 -> 4 f32 loads 8 bytes and stores 16).  Loading 16 bytes
//    whatever the output leaves a wider output two 16-byte stores a
//    thread at a 32-byte stride, which held int16 -> f32 and int8 -> bf16
//    at 69 % of their bound on the H100.  Each thread keeps
//    kUnroll vectors (32 bytes of patterns) in flight and loads the next
//    kUnroll before it decodes the current ones; one block of 1024
//    threads per SM (the table fills its shared memory) walks the tensor
//    in a grid-stride loop;
//  * the elements before the input's first vector boundary and after its
//    last whole vector go one per thread through the same lookup; an
//    output that cannot take whole stores at the input's vectors (a view
//    at an odd offset) takes them one element at a time.
// A posit wider than 16 bits (an int32 container) has no table and keeps
// the arithmetic decoder, four values per 16-byte load.  A bf16 output of
// the arithmetic decoder is rounded from the f32 value in the register
// (__float2bfloat16_rn), which equals the reference's
// decode(f32).astype(bf16); the table holds the same values.
//
// Encode: one thread per element in a grid-stride loop, coalesced.
//
// KV append (posit_kv_append_kernel).  Replaces
// repro/kernels/posit_encode.py::posit_encode_2d at the KV write (the
// encode of KVCache.append) together with the per-row scatter around it:
// one launch writes the posit bits of one layer's new K and V rows into
// that layer's (B, cap, KV, D) storage, in place.  At the serve shape it
// moves 24 KB (4 rows x 8 heads x 128 of bf16 in, posit8 out, K and V):
// some 7 ns at 3.35 TB/s.  What bounds it is the launch, not bytes: a
// cast, an encode launch and an eager scatter for each of K and V would be
// ~22 device kernels a layer, each a host dispatch.  So the design is one
// kernel for everything the write does:
//  * the positions come from the cache's int32 lengths in device memory,
//    so the host never waits on the card: per-row decode (S_new = 1) writes
//    row b at length[b], and nothing where length[b] is outside [0, cap);
//    per-row prefill writes the block at position 0; a scalar length
//    writes the block at clamp(length, 0, cap - S_new);
//  * each thread takes 8 consecutive values of one row of K or of V: one
//    16-byte load of bf16 (two of f32), widened to f32 exactly, encoded by
//    posit::encode_f32 (the same bits as posit_encode_kernel), one 8- or
//    16-byte store of bits (two for an int32 container); a row width that
//    is not a multiple of 8, or a pointer not aligned for those accesses,
//    takes one value per thread instead.
#include <type_traits>

#include "posit_decode.cuh"
#include "posit_math.cuh"

namespace {
constexpr int kDecodeThreads = 1024;

// Elements per vector of the decode of S patterns into O values: the
// load and the store each at most 16 bytes.
template <typename S, typename O>
__host__ __device__ constexpr int vec_elems() {
  return 16 / (sizeof(S) > sizeof(O) ? sizeof(S) : sizeof(O));
}

// Vectors a thread keeps in flight: 32 bytes of patterns.
template <typename S, typename O>
__host__ __device__ constexpr int vec_unroll() {
  return 32 / (vec_elems<S, O>() * sizeof(S));
}

// kBytes (4, 8 or 16) of patterns as 32-bit words, or stored from them.
template <int kBytes>
struct Words {
  uint32_t w[kBytes / 4];
  __device__ __forceinline__ void load(const void* p) {
    if constexpr (kBytes == 16) {
      const uint4 t = __ldg(static_cast<const uint4*>(p));
      w[0] = t.x, w[1] = t.y, w[2] = t.z, w[3] = t.w;
    } else if constexpr (kBytes == 8) {
      const uint2 t = __ldg(static_cast<const uint2*>(p));
      w[0] = t.x, w[1] = t.y;
    } else {
      w[0] = __ldg(static_cast<const unsigned int*>(p));
    }
  }
  __device__ __forceinline__ void store(void* p) const {
    if constexpr (kBytes == 16)
      *static_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    else if constexpr (kBytes == 8)
      *static_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    else
      *static_cast<uint32_t*>(p) = w[0];
  }
};

template <typename O> struct OutBits;
template <> struct OutBits<float> {
  using T = uint32_t;
  static constexpr uint32_t kSign = 0x80000000u;
  static constexpr uint32_t kNegNan = 0xFFC00000u;
  __device__ static uint32_t of(float v) { return __float_as_uint(v); }
};
template <> struct OutBits<__nv_bfloat16> {
  using T = uint16_t;
  static constexpr uint32_t kSign = 0x8000u;
  static constexpr uint32_t kNegNan = 0xFFC0u;
  __device__ static uint32_t of(float v) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(v));
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// The n-bit pattern at bit `off` of `word`, sign-extended (off + n <= 32).
__device__ __forceinline__ int32_t pattern_at(uint32_t word, int off, int n) {
  return static_cast<int32_t>(word << (32 - off - n)) >> (32 - n);
}

// Output bits of the pattern at bit `off` of `word`: the table's entry for
// |p| with the sign bit flipped for p < 0, or the arithmetic decoder.
template <typename O, bool kTable>
__device__ __forceinline__ uint32_t decode_bits(
    uint32_t word, int off, const typename OutBits<O>::T* tab, int n,
    int es) {
  if constexpr (kTable) {
    const int32_t p = pattern_at(word, off, n);
    return static_cast<uint32_t>(tab[abs(p)]) ^
           (static_cast<uint32_t>(p) & OutBits<O>::kSign);
  } else {
    return OutBits<O>::of(
        posit::decode_f32(static_cast<int32_t>(word), n, es));
  }
}

template <typename O>
__device__ __forceinline__ void store_bits(O* dst, uint32_t b) {
  *reinterpret_cast<typename OutBits<O>::T*>(dst) =
      static_cast<typename OutBits<O>::T>(b);
}

// Decode one vector of kPer patterns and store its outputs at out.
template <typename S, typename O, bool kTable, bool kVecStore>
__device__ __forceinline__ void decode_vector(
    const Words<vec_elems<S, O>() * sizeof(S)>& in, O* out,
    const typename OutBits<O>::T* tab, int n, int es) {
  constexpr int kPer = vec_elems<S, O>();
  uint32_t v[kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
    v[i] = decode_bits<O, kTable>(in.w[i * sizeof(S) / 4],
                                  (i * sizeof(S)) % 4 * 8, tab, n, es);
  if constexpr (kVecStore) {
    Words<kPer * sizeof(O)> o;
#pragma unroll
    for (int j = 0; j < kPer * static_cast<int>(sizeof(O)) / 4; ++j)
      o.w[j] = sizeof(O) == 4 ? v[j] : (v[2 * j] | (v[2 * j + 1] << 16));
    o.store(out);
  } else {
#pragma unroll
    for (int i = 0; i < kPer; ++i) store_bits(out + i, v[i]);
  }
}
}  // namespace

// Entries [0, 2^(n-1)) of the table: the values of the non-negative
// patterns; entry 2^(n-1): NaR, a NaN with the sign bit set.
template <typename O>
__global__ void posit_decode_table_kernel(typename OutBits<O>::T* table,
                                          int nbits, int es) {
  const int half = 1 << (nbits - 1);
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i <= half;
       i += gridDim.x * blockDim.x) {
    table[i] = static_cast<typename OutBits<O>::T>(
        i == half ? OutBits<O>::kNegNan
                  : OutBits<O>::of(posit::decode_f32(i, nbits, es)));
  }
}

// The plan's head and tail one element per thread (of the first head +
// tail threads), its n_vec vectors of kPer elements in a grid-stride loop.
// With a table: `table` (16-byte chunks) is copied into dynamic shared
// memory.
template <typename S, typename O, bool kTable, bool kVecStore>
__global__ void __launch_bounds__(kDecodeThreads) posit_decode_kernel(
    const S* __restrict__ bits, O* __restrict__ out, long long head,
    long long n_vec, long long tail, const uint4* __restrict__ table,
    int table_chunks, int nbits, int es) {
  using U = std::make_unsigned_t<S>;
  constexpr int kPer = vec_elems<S, O>();
  constexpr int kInBytes = kPer * sizeof(S);
  constexpr int kUnroll = vec_unroll<S, O>();
  using In = Words<kInBytes>;
  extern __shared__ uint4 table_s[];
  const auto* tab = reinterpret_cast<const typename OutBits<O>::T*>(table_s);
  if constexpr (kTable) {
    for (int c = threadIdx.x; c < table_chunks; c += blockDim.x)
      cp_async16(table_s + c, table + c);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t0 =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const S* vin = bits + head;
  O* vout = out + head;
  In cur[kUnroll];
#pragma unroll
  for (int u = 0; u < kUnroll; ++u)
    if (t0 + u * stride < n_vec) cur[u].load(vin + (t0 + u * stride) * kPer);
  if constexpr (kTable) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();
  }
  if (t0 < head + tail) {
    const long long i = t0 < head ? t0 : head + n_vec * kPer + (t0 - head);
    store_bits(out + i, decode_bits<O, kTable>(
                            static_cast<uint32_t>(static_cast<U>(bits[i])),
                            0, tab, nbits, es));
  }
  for (long long v = t0; v < n_vec; v += kUnroll * stride) {
    In nxt[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = v + (kUnroll + u) * stride;
      if (j < n_vec) nxt[u].load(vin + j * kPer);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = v + u * stride;
      if (j < n_vec)
        decode_vector<S, O, kTable, kVecStore>(cur[u], vout + j * kPer, tab,
                                               nbits, es);
      cur[u] = nxt[u];
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
// Where posit_kv_append writes (kernels/posit_codec.py::posit_kv_append).
enum KvMode : int { kPerRowDecode = 0, kPerRowPrefill = 1, kScalarLength = 2 };

// kPer values at `src` (f32, or bf16 held as uint16_t) as f32: 16-byte
// loads when kPer > 1.  Widening bf16 is exact: its bits on top.
template <typename I, int kPer>
__device__ __forceinline__ void load_f32(const I* src, float (&v)[kPer]) {
  if constexpr (kPer == 1) {
    if constexpr (sizeof(I) == 4)
      v[0] = __ldg(reinterpret_cast<const float*>(src));
    else
      v[0] = __uint_as_float(static_cast<uint32_t>(__ldg(src)) << 16);
  } else {
    constexpr int kChunks = kPer * static_cast<int>(sizeof(I)) / 16;
    uint32_t w[4 * kChunks];
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const uint4 t = __ldg(reinterpret_cast<const uint4*>(src) + c);
      w[4 * c] = t.x, w[4 * c + 1] = t.y, w[4 * c + 2] = t.z,
             w[4 * c + 3] = t.w;
    }
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      v[i] = __uint_as_float(sizeof(I) == 4 ? w[i]
                             : i % 2       ? w[i / 2] & 0xFFFF0000u
                                           : w[i / 2] << 16);
  }
}

// kPer patterns (low bits of p) stored at dst in S's container: one 8-byte
// store or 16-byte stores when kPer > 1.
template <typename S, int kPer>
__device__ __forceinline__ void store_patterns(S* dst,
                                               const uint32_t (&p)[kPer]) {
  using U = std::make_unsigned_t<S>;
  if constexpr (kPer == 1) {
    *dst = static_cast<S>(static_cast<U>(p[0]));
  } else {
    constexpr int kBytes = kPer * static_cast<int>(sizeof(S));  // 8-32
    uint32_t w[kBytes / 4] = {};
#pragma unroll
    for (int i = 0; i < kPer; ++i)
      w[i * sizeof(S) / 4] |= static_cast<uint32_t>(static_cast<U>(p[i]))
                              << (i * sizeof(S) % 4 * 8);
    if constexpr (kBytes == 8) {
      *reinterpret_cast<uint2*>(dst) = make_uint2(w[0], w[1]);
    } else {
#pragma unroll
      for (int c = 0; c < kBytes / 16; ++c)
        reinterpret_cast<uint4*>(dst)[c] =
            make_uint4(w[4 * c], w[4 * c + 1], w[4 * c + 2], w[4 * c + 3]);
    }
  }
}
}  // namespace

// k_new/v_new (batch, s_new, row) of I -> posit bits in k_bits/v_bits
// (batch, cap, row) of S at the positions `mode` reads from `length`; one
// thread per kPer consecutive values of one row of K or V.
template <typename I, typename S, int kPer>
__global__ void __launch_bounds__(256) posit_kv_append_kernel(
    const I* __restrict__ k_new, const I* __restrict__ v_new,
    S* __restrict__ k_bits, S* __restrict__ v_bits,
    const int32_t* __restrict__ length, int batch, int s_new, int cap,
    int row, int mode, int nbits, int es) {
  const long long row_units = row / kPer;
  const long long units = static_cast<long long>(batch) * s_new * row_units;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long u = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       u < 2 * units; u += stride) {
    const bool is_v = u >= units;
    const long long w = is_v ? u - units : u;
    const long long r = w / row_units;          // source row b * s_new + s
    const int j = static_cast<int>(w - r * row_units) * kPer;
    const int b = static_cast<int>(r / s_new);
    const int s = static_cast<int>(r - static_cast<long long>(b) * s_new);
    int pos;
    if (mode == kPerRowDecode) {
      pos = __ldg(length + b);
      if (pos < 0 || pos >= cap) continue;      // dropped, as the scatter
    } else if (mode == kPerRowPrefill) {
      pos = s;
    } else {
      pos = min(max(__ldg(length), 0), cap - s_new) + s;
    }
    float v[kPer];
    load_f32<I, kPer>((is_v ? v_new : k_new) + r * row + j, v);
    uint32_t p[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) p[i] = posit::encode_f32(v[i], nbits, es);
    store_patterns<S, kPer>((is_v ? v_bits : k_bits) +
                                (static_cast<long long>(b) * cap + pos) *
                                    row +
                                j,
                            p);
  }
}

namespace {
constexpr int kThreads = 256;

template <typename I, typename S, int kPer>
int launch_kv_append(const void* k_new, const void* v_new, void* k_bits,
                     void* v_bits, const int32_t* length, int batch,
                     int s_new, int cap, int row, int mode, int nbits,
                     int es, cudaStream_t stream) {
  const long long threads =
      2LL * batch * s_new * static_cast<long long>(row / kPer);
  if (threads == 0) return 0;
  posit_kv_append_kernel<I, S, kPer><<<grid_for(threads, kThreads), kThreads,
                                       0, stream>>>(
      static_cast<const I*>(k_new), static_cast<const I*>(v_new),
      static_cast<S*>(k_bits), static_cast<S*>(v_bits), length, batch, s_new,
      cap, row, mode, nbits, es);
  return static_cast<int>(cudaGetLastError());
}

// Eight values a thread where the row width and every pointer allow its
// 16-byte loads and 8- or 16-byte stores, else one.
template <typename I, typename S>
int launch_kv_append_to(const void* k_new, const void* v_new, void* k_bits,
                        void* v_bits, const int32_t* length, int batch,
                        int s_new, int cap, int row, int mode, int nbits,
                        int es, cudaStream_t stream) {
  const uintptr_t out_align = sizeof(S) == 1 ? 8 : 16;
  const bool vec = row % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(k_new) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(v_new) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(k_bits) % out_align == 0 &&
                   reinterpret_cast<uintptr_t>(v_bits) % out_align == 0;
  return vec ? launch_kv_append<I, S, 8>(k_new, v_new, k_bits, v_bits,
                                         length, batch, s_new, cap, row,
                                         mode, nbits, es, stream)
             : launch_kv_append<I, S, 1>(k_new, v_new, k_bits, v_bits,
                                         length, batch, s_new, cap, row,
                                         mode, nbits, es, stream);
}

template <typename I>
int launch_kv_append_in(const void* k_new, const void* v_new, void* k_bits,
                        void* v_bits, const int32_t* length, int bits_bytes,
                        int batch, int s_new, int cap, int row, int mode,
                        int nbits, int es, cudaStream_t stream) {
  switch (bits_bytes) {
    case 1:
      return launch_kv_append_to<I, int8_t>(k_new, v_new, k_bits, v_bits,
                                            length, batch, s_new, cap, row,
                                            mode, nbits, es, stream);
    case 2:
      return launch_kv_append_to<I, int16_t>(k_new, v_new, k_bits, v_bits,
                                             length, batch, s_new, cap, row,
                                             mode, nbits, es, stream);
    case 4:
      return launch_kv_append_to<I, int32_t>(k_new, v_new, k_bits, v_bits,
                                             length, batch, s_new, cap, row,
                                             mode, nbits, es, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename S, typename O, bool kTable, bool kVecStore>
int launch_decode(const void* bits, void* out, const VecPlan& plan,
                  const void* table, int table_bytes, int nbits, int es,
                  cudaStream_t stream) {
  constexpr auto kernel = posit_decode_kernel<S, O, kTable, kVecStore>;
  const size_t smem = kTable ? static_cast<size_t>(table_bytes) : 0;
  if constexpr (kTable) {
    static size_t smem_set = 48 * 1024;   // the largest size allowed so far
    if (smem > smem_set) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      smem_set = smem;
    }
  }
  constexpr int kUnroll = vec_unroll<S, O>();
  const long long work = (plan.n_vec + kUnroll - 1) / kUnroll;
  const unsigned blocks = wave_blocks<kernel>(
      kDecodeThreads, smem, work > plan.head + plan.tail ? work
                                                         : plan.head +
                                                               plan.tail);
  kernel<<<blocks, kDecodeThreads, smem, stream>>>(
      static_cast<const S*>(bits), static_cast<O*>(out), plan.head,
      plan.n_vec, plan.tail, static_cast<const uint4*>(table),
      table_bytes / 16, nbits, es);
  return static_cast<int>(cudaGetLastError());
}

template <typename S, typename O>
int launch_decode_to(const void* bits, void* out, long long n, int nbits,
                     int es, const void* table, int table_bytes,
                     cudaStream_t stream) {
  constexpr int kPer = vec_elems<S, O>();
  const VecPlan plan = vec_plan(bits, n, sizeof(S), kPer);
  const bool vec_store = vec_store_ok(out, plan.head, sizeof(O), kPer);
  if (nbits <= 16) {
    if (table == nullptr || table_bytes % 16 != 0 ||
        table_bytes < static_cast<int>(((1 << (nbits - 1)) + 1) * sizeof(O)))
      return static_cast<int>(cudaErrorInvalidValue);
    return vec_store ? launch_decode<S, O, true, true>(
                           bits, out, plan, table, table_bytes, nbits, es,
                           stream)
                     : launch_decode<S, O, true, false>(
                           bits, out, plan, table, table_bytes, nbits, es,
                           stream);
  }
  if constexpr (sizeof(S) == 4) {
    return vec_store ? launch_decode<S, O, false, true>(
                           bits, out, plan, nullptr, 0, nbits, es, stream)
                     : launch_decode<S, O, false, false>(
                           bits, out, plan, nullptr, 0, nbits, es, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename S>
int launch_decode_s(const void* bits, void* out, long long n, int out_bf16,
                    int nbits, int es, const void* table, int table_bytes,
                    cudaStream_t stream) {
  if (nbits < 2 || nbits > 8 * static_cast<int>(sizeof(S)) ||
      reinterpret_cast<uintptr_t>(bits) % sizeof(S) != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  return out_bf16
             ? launch_decode_to<S, __nv_bfloat16>(bits, out, n, nbits, es,
                                                  table, table_bytes, stream)
             : launch_decode_to<S, float>(bits, out, n, nbits, es, table,
                                          table_bytes, stream);
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

// The decode table of posit<nbits, es>, nbits <= 16, into `table`
// (2^(nbits-1) + 1 entries of f32, or of bf16 when out_bf16).
int posit_decode_table(void* table, int nbits, int es, int out_bf16,
                       void* stream) {
  if (nbits < 2 || nbits > 16) return static_cast<int>(cudaErrorInvalidValue);
  const int entries = (1 << (nbits - 1)) + 1;
  const unsigned blocks = static_cast<unsigned>((entries + 255) / 256);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (out_bf16)
    posit_decode_table_kernel<__nv_bfloat16><<<blocks, 256, 0, st>>>(
        static_cast<uint16_t*>(table), nbits, es);
  else
    posit_decode_table_kernel<float><<<blocks, 256, 0, st>>>(
        static_cast<uint32_t*>(table), nbits, es);
  return static_cast<int>(cudaGetLastError());
}

// bits_bytes: 1, 2 or 4 (int8/int16/int32 patterns, nbits at most the
// container's); out_bf16: 0 -> f32.  nbits <= 16 needs `table`, the
// posit_decode_table of (nbits, es, out_bf16), table_bytes a multiple of
// 16 (else cudaErrorInvalidValue); wider posits take no table.
int posit_decode(const void* bits, void* out, long long n, int bits_bytes,
                 int out_bf16, int nbits, int es, const void* table,
                 int table_bytes, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bits_bytes) {
    case 1:
      return launch_decode_s<int8_t>(bits, out, n, out_bf16, nbits, es,
                                     table, table_bytes, st);
    case 2:
      return launch_decode_s<int16_t>(bits, out, n, out_bf16, nbits, es,
                                      table, table_bytes, st);
    case 4:
      return launch_decode_s<int32_t>(bits, out, n, out_bf16, nbits, es,
                                      table, table_bytes, st);
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

// k_new, v_new: (batch, s_new, row) f32, or bf16 when in_bf16; k_bits,
// v_bits: (batch, cap, row) posit bits in a container of bits_bytes (1, 2,
// 4); length: int32, (batch,) for modes 0 (per-row decode, s_new = 1) and
// 1 (per-row prefill, the block at 0), one value for mode 2 (the block at
// clamp(length, 0, cap - s_new)).
int posit_kv_append(const void* k_new, const void* v_new, void* k_bits,
                    void* v_bits, const int32_t* length, int in_bf16,
                    int bits_bytes, int batch, int s_new, int cap, int row,
                    int mode, int nbits, int es, void* stream) {
  if (mode < kPerRowDecode || mode > kScalarLength || batch < 0 ||
      s_new < 1 || cap < 1 || row < 1 || nbits < 2 ||
      nbits > 8 * bits_bytes || (mode == kPerRowDecode && s_new != 1) ||
      (mode != kPerRowDecode && s_new > cap))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return in_bf16
             ? launch_kv_append_in<uint16_t>(k_new, v_new, k_bits, v_bits,
                                             length, bits_bytes, batch, s_new,
                                             cap, row, mode, nbits, es, st)
             : launch_kv_append_in<float>(k_new, v_new, k_bits, v_bits,
                                          length, bits_bytes, batch, s_new,
                                          cap, row, mode, nbits, es, st);
}

}  // extern "C"
