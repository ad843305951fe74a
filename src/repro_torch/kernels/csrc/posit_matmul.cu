// Posit matrix products for Hopper (sm_90a).
//
// 1. The rounded product C = round_posit(A[M,K] B[K,N]), one wide
//    accumulation per output and one rounding at the end.
//
// Replaces repro/kernels/posit_matmul.py::posit_matmul_round_2d, the
// Arith.matmul posit path (mel filterbank 2049->20, DCT 20->13, spectral
// centroid 2049->1, forest votes T->1).  On the TPU K stays whole in one
// grid step per output tile.
//
// Bound on the H100: neither bytes nor flops, but latency.  The main-path
// shapes are tall and skinny: the mel product (64, 2049) . (2049, 20)
// moves 0.69 MB (0.2 us at 3.35 TB/s) and does 5.2 MFLOP (0.08 us at 67
// TFLOP/s of f32).  A block per output tile whose threads each walk all
// of K, as on the TPU, would leave 8 blocks on 132 SMs with 2049
// dependent adds a thread.  So this design spreads K instead
// (kernels/posit_matmul.py::round_matmul_plan):
//  * a block of 256 threads owns a kTM x kTN tile of 32 outputs (kTN = 8,
//    4, 2 or 1 by N); thread t accumulates, in the input's float type, the
//    products of every 256th k of its split, k = k0 + t, k0 + t + 256, ...
//    (the A loads of a warp are one contiguous row segment);
//  * the 32 partials of each warp are added across its lanes in a fixed
//    tree of 31 shuffles, each step halving the live sums, so lane l ends
//    with the warp's sum of output l of the tile; the eight warps' sums
//    are then added in warp order, and the result rounded once;
//  * where one row block's output tiles are fewer than the H100's 132
//    SMs, K is split across blocks as well: each split writes its sums to
//    scratch and posit_matmul_round_combine_kernel adds the splits in
//    split order and rounds.  No atomics: the same bits every run.  The
//    split follows K and N alone, never M, so a row's bits do not depend
//    on how many rows share the launch.
// Build with -fmad=false: each product rounds before it adds, as in the
// plain version, which sums in this kernel's order
// (kernels/posit_matmul.py::round_matmul_sum): the two agree bit for bit.
//
// 2. The decode-fused product C[M,N] f32 = decode(A_bits[M,K]) .
//    decode(B_bits[K,N]), the posit bits staying in device memory.
//
// Replaces repro/kernels/posit_matmul.py::posit_matmul (ops.matmul, the
// quickstart's product).  On the TPU each (bm, bk) and (bk, bn) tile of
// bits is decoded in VMEM to bf16 (the MXU's input) and accumulated in f32
// across a sequential K grid axis.
//
// Bound on the H100 at the FFN width (64, 4096) . (4096, 12288) posit16:
// the 104 MB of bits and output take 0.031 ms at 3.35 TB/s and the 6.44
// GFLOP 0.0065 ms on bf16 tensor cores; what the card really spends is
// the work of ~60 M posit decodes (some 30 integer operations each by
// arithmetic, ~0.1 ms at the SMs' integer rate).  So the design keeps the
// MMA off the critical path and spends the threads on decoding each value
// once, as cheaply as it can:
//  * persistent blocks of 512 threads walk work units, each a 64 x BN
//    output tile (BN = 64, 128 or 256: one warpgroup per 64 columns runs
//    the MMA, all 16 warps decode) over a contiguous range of K slabs 64
//    deep; a wide BN decodes the A panel once per BN columns;
//  * the bits of slab k+2 are fetched with cp.async.cg (16 bytes a
//    thread, or element loads at a ragged or unaligned edge) into a
//    two-stage staging ring while slab k is decoded;
//  * every thread decodes staged bits, through a table of all 2^n bf16
//    values (n <= 16, built once per block from posit_decode.cuh, where
//    the plan finds it pays) or posit_decode.cuh itself, rounds to bf16
//    with __float2bfloat16_rn (the reference's compute dtype) and writes
//    16-byte rows of eight values straight into the K-major,
//    128-byte-swizzled tiles that wgmma's descriptors read; neither
//    operand is ever written back to device memory decoded;
//  * the decoded tiles are double-buffered: wgmma.mma_async m64n64k16
//    (bf16 in, f32 out) multiplies slab k while slab k+1 is decoded, and
//    each slab's f32 result is added into a separate f32 register
//    accumulator (a rounded add), so the tensor cores' own accumulation
//    spans 64 products and never the whole of K;
//  * the plan (kernels/posit_matmul.py::matmul_plan) splits K across
//    work units when the output tiles alone would not fill the card; each
//    split writes an f32 partial tile and posit_matmul_combine_kernel adds
//    the splits in a fixed order (no atomics, the same bits every run).
//
// Build with -fmad=false: products round before they add, like the plain
// version's reduction, not as fused multiply-adds.
#include <cuda_bf16.h>
#include <cstdint>

#include "posit_decode.cuh"
#include "posit_math.cuh"

namespace {
constexpr int kRoundThreads = 256;   // 8 warps; thread t takes every 256th k
constexpr int kRoundAcc = 32;        // outputs of a tile, one a lane

// The warp's sums of its lanes' 2 kO live partials: at step kO a lane
// keeps the half of them that bit kO of its lane index selects and adds
// the partner's (lane ^ kO) partials of that half; after kO = 16 ... 1,
// acc[0] of lane l holds the warp's sum of output l.
template <int kO, typename T>
__device__ __forceinline__ void warp_fold(T (&acc)[kRoundAcc], int lane) {
  const bool upper = lane & kO;
#pragma unroll
  for (int i = 0; i < kO; ++i) {
    const T send = upper ? acc[i] : acc[i + kO];
    const T keep = upper ? acc[i + kO] : acc[i];
    acc[i] = keep + __shfl_xor_sync(0xFFFFFFFFu, send, kO);
  }
  if constexpr (kO > 1) warp_fold<kO / 2>(acc, lane);
}
}  // namespace

template <typename T, int kTN>
__global__ void __launch_bounds__(kRoundThreads) posit_matmul_round_kernel(
    const T* __restrict__ a, const T* __restrict__ b, T* __restrict__ out,
    int M, int K, int N, int per, int splits, int nbits, int es) {
  constexpr int kTM = kRoundAcc / kTN;
  __shared__ T warp_sum[kRoundThreads / 32][32];
  const int n_tiles = (N + kTN - 1) / kTN;
  const int m0 = static_cast<int>(blockIdx.x / n_tiles) * kTM;
  const int n0 = static_cast<int>(blockIdx.x % n_tiles) * kTN;
  const int split = blockIdx.y;
  const int k1 = static_cast<int>(
      min(static_cast<long long>(K), static_cast<long long>(split + 1) * per));
  T acc[kRoundAcc];
#pragma unroll
  for (int i = 0; i < kRoundAcc; ++i) acc[i] = T(0);
#pragma unroll 2
  for (int k = split * per + static_cast<int>(threadIdx.x); k < k1;
       k += kRoundThreads) {
    T av[kTM], bv[kTN];
#pragma unroll
    for (int i = 0; i < kTM; ++i)
      av[i] = m0 + i < M ? __ldg(a + static_cast<long long>(m0 + i) * K + k)
                         : T(0);
#pragma unroll
    for (int j = 0; j < kTN; ++j)
      bv[j] = n0 + j < N ? __ldg(b + static_cast<long long>(k) * N + n0 + j)
                         : T(0);
#pragma unroll
    for (int i = 0; i < kTM; ++i)
#pragma unroll
      for (int j = 0; j < kTN; ++j)
        acc[i * kTN + j] = acc[i * kTN + j] + av[i] * bv[j];
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_fold<16>(acc, lane);
  warp_sum[warp][lane] = acc[0];
  __syncthreads();
  if (warp != 0) return;
  T sum = warp_sum[0][lane];
#pragma unroll
  for (int w = 1; w < kRoundThreads / 32; ++w) sum = sum + warp_sum[w][lane];
  const int m = m0 + lane / kTN, n = n0 + lane % kTN;
  if (m >= M || n >= N) return;
  const long long at = static_cast<long long>(m) * N + n;
  if (splits == 1)
    out[at] = round_posit_math<T>(sum, nbits, es);
  else
    out[static_cast<long long>(split) * M * N + at] = sum;
}

// C = round(the sum of the split-K sums, split 0 first, in that order).
template <typename T>
__global__ void posit_matmul_round_combine_kernel(const T* __restrict__ part,
                                                  T* __restrict__ c,
                                                  long long MN, int splits,
                                                  int nbits, int es) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < MN; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    T s = part[i];
    for (int k = 1; k < splits; ++k) s = s + part[k * MN + i];
    c[i] = round_posit_math<T>(s, nbits, es);
  }
}

namespace {
constexpr int kBM = 64;            // output rows per block: one wgmma M
constexpr int kBK = 64;            // slab depth: 128 bytes of bf16 per row
constexpr int kStages = 2;         // staging ring of raw bits
constexpr int kThreadsB7 = 512;    // 16 warps decode; NWG of 4 multiply
constexpr int kWgN = 64;           // output columns per warpgroup
constexpr int kTileAlign = 1024;   // 128-byte swizzle atom: 8 rows
constexpr int kTableBits = 16;     // posits up to 16 bits decode by table

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// wgmma operand descriptor of a K-major tile whose rows are 128 bytes
// (64 bf16), swizzled in 1024-byte atoms of 8 rows: start >> 4, leading
// byte offset 16 B (unused by this layout), stride 1024 B between 8-row
// groups, layout 1 = 128-byte swizzle.
__device__ __forceinline__ uint64_t tile_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(16 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// Byte offset of the 16-byte group `kc` (of eight bf16) of row `r` in a
// swizzled tile: the group index XOR the row's place in its 8-row atom.
__device__ __forceinline__ uint32_t swz(int r, int kc) {
  return static_cast<uint32_t>(r * 128 + ((kc ^ (r & 7)) << 4));
}

// D (64 x 64 f32, 32 registers a thread) = A_desc (64 x 16) . B_desc
// (16 x 64), plus D when scale_d != 0.  Both operands K-major in shared
// memory.
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], uint64_t da,
                                                uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Keep the compiler from moving reads of the accumulator above the wait.
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// The posit value of `raw` rounded to bf16 (the reference's compute
// dtype), as its 16 bits.
__device__ __forceinline__ uint32_t decode_bf16_bits(int32_t raw, int nbits,
                                                     int es,
                                                     const uint16_t* table) {
  if (table != nullptr)
    return table[static_cast<uint32_t>(raw) & ((1u << nbits) - 1u)];
  return __bfloat16_as_ushort(
      __float2bfloat16_rn(posit::decode_f32(raw, nbits, es)));
}

template <typename S>
__device__ __forceinline__ uint32_t pack2(const S* v, int j, int nbits,
                                          int es, const uint16_t* table) {
  return decode_bf16_bits(v[j], nbits, es, table) |
         (decode_bf16_bits(v[j + 1], nbits, es, table) << 16);
}

// Eight decoded values as one 16-byte group of bf16.
template <typename S>
__device__ __forceinline__ uint4 pack8(const S (&v)[8], int nbits, int es,
                                       const uint16_t* table) {
  uint4 w;
  w.x = pack2(v, 0, nbits, es, table);
  w.y = pack2(v, 2, nbits, es, table);
  w.z = pack2(v, 4, nbits, es, table);
  w.w = pack2(v, 6, nbits, es, table);
  return w;
}
}  // namespace

// A persistent block walks the work units blockIdx.x, blockIdx.x +
// gridDim.x, ...: unit u is output rows [m0, m0 + 64) x columns [n0, n0 +
// 64 NWG) over the K slabs of split u % splits.  512 threads stage and
// decode; warpgroup w < NWG multiplies columns [64 w, 64 w + 64).  The
// decoded tiles are double-buffered: slab s is decoded while the tensor
// cores multiply slab s - 1.  With use_table (n <= 16), the posits decode
// through a table of all 2^n bf16 values that the block builds once from
// the same decoder.
// Dynamic shared memory: two sets of the swizzled bf16 tiles A (64 x 64)
// and B (64 NWG x 64, K-major), the staging ring (kStages x (A 64 x 64 and
// B 64 x 64 NWG raw bits, as in device memory)), the bf16 table.
template <typename S, int NWG>
__global__ void __launch_bounds__(kThreadsB7)
    posit_matmul_wgmma_kernel(const S* __restrict__ a,
                              const S* __restrict__ b, float* __restrict__ c,
                              int M, int K, int N, int nbits, int es,
                              int splits, int slabs_per_split, int use_table,
                              int a_vec, int b_vec) {
  constexpr int kBN = kWgN * NWG;
  constexpr int kVec = 16 / static_cast<int>(sizeof(S));  // per cp.async
  constexpr int kDecBytes = (kBM + kBN) * 128;            // A and B tiles
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = smem_addr(smem_raw);
  uint8_t* smem =
      smem_raw + ((kTileAlign - base % kTileAlign) % kTileAlign);
  S* stage = reinterpret_cast<S*>(smem + 2 * kDecBytes);
  constexpr int kStageElems = kBM * kBK + kBK * kBN;
  uint16_t* table_s =
      reinterpret_cast<uint16_t*>(stage + kStages * kStageElems);

  const int tid = threadIdx.x;
  const int wg = tid / 128;
  const bool mma = wg < NWG;            // this warpgroup multiplies
  const int lane = tid & 31, warp = (tid >> 5) & 3;
  const int n_slabs = (K + kBK - 1) / kBK;
  const int n_tiles = (N + kBN - 1) / kBN, m_tiles = (M + kBM - 1) / kBM;
  const int n_units = n_tiles * m_tiles * splits;
  const uint16_t* table = nullptr;
  if (use_table) {
    for (int i = tid; i < (1 << nbits); i += kThreadsB7)
      table_s[i] = __bfloat16_as_ushort(
          __float2bfloat16_rn(posit::decode_f32(i, nbits, es)));
    table = table_s;          // visible after the first __syncthreads
  }

  for (int unit = blockIdx.x; unit < n_units; unit += gridDim.x) {
    const int split = unit % splits;
    const int tile = unit / splits;
    const int m0 = (tile / n_tiles) * kBM, n0 = (tile % n_tiles) * kBN;
    const int s0 = split * slabs_per_split;
    const int s1 = min(n_slabs, s0 + slabs_per_split);

    // raw bits of slab s into stage buffer `st`: A rows m, B rows k, as in
    // device memory; zeros past M, N and K
    auto load_slab = [&](int s, int st) {
      S* sa = stage + st * kStageElems;
      S* sb = sa + kBM * kBK;
      const int k0 = s * kBK;
      for (int ch = tid; ch < kBM * kBK / kVec; ch += kThreadsB7) {
        const int m = ch / (kBK / kVec), kk = (ch % (kBK / kVec)) * kVec;
        const int gm = m0 + m, gk = k0 + kk;
        S* dst = sa + m * kBK + kk;
        const S* src = a + static_cast<long long>(gm) * K + gk;
        if (a_vec && gm < M && gk + kVec <= K) {
          cp_async16(dst, src);
        } else {
          for (int j = 0; j < kVec; ++j)
            dst[j] = (gm < M && gk + j < K) ? src[j] : S(0);
        }
      }
      for (int ch = tid; ch < kBK * kBN / kVec; ch += kThreadsB7) {
        const int k = ch / (kBN / kVec), nn = (ch % (kBN / kVec)) * kVec;
        const int gk = k0 + k, gn = n0 + nn;
        S* dst = sb + k * kBN + nn;
        const S* src = b + static_cast<long long>(gk) * N + gn;
        if (b_vec && gk < K && gn + kVec <= N) {
          cp_async16(dst, src);
        } else {
          for (int j = 0; j < kVec; ++j)
            dst[j] = (gk < K && gn + j < N) ? src[j] : S(0);
        }
      }
    };
    // the slab's f32 product (in flight in d) into the f32 accumulator
    auto promote = [&](float (&acc)[32], float (&d)[32]) {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        fence_operand(d[i]);
        acc[i] = __fadd_rn(acc[i], d[i]);
      }
    };

    float acc[32], d[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = d[i] = 0.0f;

#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      if (s0 + st < s1) load_slab(s0 + st, st);
      asm volatile("cp.async.commit_group;\n" ::: "memory");
    }

    for (int s = s0; s < s1; ++s) {
      const int st = (s - s0) % kStages;
      uint8_t* dec_a = smem + ((s - s0) & 1) * kDecBytes;  // 64 x 128 B
      uint8_t* dec_b = dec_a + kBM * 128;                  // kBN x 128 B
      asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 1)
                   : "memory");
      // slab s staged; the tiles slab s - 2 used are free (every
      // warpgroup waited for their products in the last step)
      __syncthreads();
      const S* sa = stage + st * kStageElems;
      const S* sb = sa + kBM * kBK;
      // A: row m, 8 consecutive k -> one 16-byte group of the swizzled tile
#pragma unroll
      for (int u = tid; u < kBM * (kBK / 8); u += kThreadsB7) {
        const int m = u >> 3, kc = u & 7;
        S v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = sa[m * kBK + kc * 8 + j];
        *reinterpret_cast<uint4*>(dec_a + swz(m, kc)) =
            pack8(v, nbits, es, table);
      }
      // B: column n, 8 consecutive k (a column of the staged rows) -> one
      // 16-byte group of row n of the K-major tile
#pragma unroll
      for (int u = tid; u < kBN * (kBK / 8); u += kThreadsB7) {
        const int n = u % kBN, kc = u / kBN;
        S v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = sb[(kc * 8 + j) * kBN + n];
        *reinterpret_cast<uint4*>(dec_b + swz(n, kc)) =
            pack8(v, nbits, es, table);
      }
      // the generic-proxy stores above, visible to wgmma (the async proxy)
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      if (mma && s > s0) promote(acc, d);   // slab s - 1's product
      __syncthreads();  // tiles of slab s complete; stage st free again
      if (s + kStages < s1) load_slab(s + kStages, st);
      asm volatile("cp.async.commit_group;\n" ::: "memory");

      if (mma) {
        const uint64_t desc_a = tile_desc(smem_addr(dec_a));
        const uint64_t desc_b = tile_desc(smem_addr(dec_b + wg * kWgN * 128));
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)  // 16 bf16 = 32 B = 2 units
          wgmma_m64n64k16(d, desc_a + 2 * kk, desc_b + 2 * kk, kk);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      }
    }
    if (mma && s1 > s0) promote(acc, d);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");

    // the accumulator fragment: warp w of the warpgroup holds rows
    // 16 w + lane / 4 (+ 8), columns 8 j + 2 (lane % 4) (+ 1) of block j
    if (mma) {
      float* out = c + static_cast<long long>(split) * M * N;
      const int row = m0 + warp * 16 + (lane >> 2);
      const int col = n0 + wg * kWgN + 2 * (lane & 3);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = row + 8 * h;
          if (r >= M) continue;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cc = col + 8 * j + e;
            if (cc < N) out[static_cast<long long>(r) * N + cc] =
                acc[4 * j + 2 * h + e];
          }
        }
      }
    }
  }
}

// C = the sum of the split-K partials, split 0 first, in that order.
__global__ void posit_matmul_combine_kernel(const float* __restrict__ part,
                                            float* __restrict__ c,
                                            long long MN, int splits) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       i < MN; i += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = part[i];
    for (int k = 1; k < splits; ++k) s = __fadd_rn(s, part[k * MN + i]);
    c[i] = s;
  }
}

namespace {
// Bytes of dynamic shared memory the kernel needs (the plan function in
// kernels/posit_matmul.py mirrors this formula).
template <typename S, int NWG>
size_t wgmma_smem_bytes(int nbits, int use_table) {
  const size_t bn = kWgN * NWG;
  return kTileAlign + 2 * (kBM + bn) * 128 +
         kStages * (kBM * kBK + kBK * bn) * sizeof(S) +
         (use_table ? 2u << nbits : 0u);
}

template <typename S, int NWG>
int launch_wgmma(const void* a, const void* b, float* c, float* part, int M,
                 int K, int N, int nbits, int es, int splits,
                 int slabs_per_split, int grid, int use_table,
                 void* stream) {
  const size_t smem = wgmma_smem_bytes<S, NWG>(nbits, use_table);
  auto kernel = posit_matmul_wgmma_kernel<S, NWG>;
  static size_t smem_set = 48 * 1024;   // the largest size allowed so far
  cudaError_t err = cudaSuccess;
  if (smem > smem_set) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  const int esize = static_cast<int>(sizeof(S));
  const int a_vec = (static_cast<long long>(K) * esize) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(a) % 16 == 0;
  const int b_vec = (static_cast<long long>(N) * esize) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(b) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<grid, kThreadsB7, smem, st>>>(
      static_cast<const S*>(a), static_cast<const S*>(b),
      splits > 1 ? part : c, M, K, N, nbits, es, splits, slabs_per_split,
      use_table, a_vec, b_vec);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long MN = static_cast<long long>(M) * N;
  const long long blocks = (MN + 255) / 256;
  posit_matmul_combine_kernel<<<blocks < 4096 ? blocks : 4096, 256, 0, st>>>(
      part, c, MN, splits);
  return static_cast<int>(cudaGetLastError());
}

template <typename S>
int launch_decode(const void* a, const void* b, float* c, float* part, int M,
                  int K, int N, int nbits, int es, int bn, int splits,
                  int slabs_per_split, int grid, int use_table,
                  void* stream) {
  switch (bn) {
    case 64:
      return launch_wgmma<S, 1>(a, b, c, part, M, K, N, nbits, es, splits,
                                slabs_per_split, grid, use_table, stream);
    case 128:
      return launch_wgmma<S, 2>(a, b, c, part, M, K, N, nbits, es, splits,
                                slabs_per_split, grid, use_table, stream);
    case 256:
      return launch_wgmma<S, 4>(a, b, c, part, M, K, N, nbits, es, splits,
                                slabs_per_split, grid, use_table, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T, int kTN>
int launch_round_tn(const T* a, const T* b, T* c, T* part, int M, int K,
                    int N, int splits, int per, int nbits, int es,
                    cudaStream_t stream) {
  constexpr int kTM = kRoundAcc / kTN;
  const long long tiles = static_cast<long long>((M + kTM - 1) / kTM) *
                          ((N + kTN - 1) / kTN);
  if (tiles > 0x7FFFFFFFLL || splits > 65535)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  posit_matmul_round_kernel<T, kTN>
      <<<dim3(static_cast<unsigned>(tiles), splits), kRoundThreads, 0,
         stream>>>(a, b, splits > 1 ? part : c, M, K, N, per, splits, nbits,
                   es);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  const long long MN = static_cast<long long>(M) * N;
  posit_matmul_round_combine_kernel<T>
      <<<grid_for(MN, kRoundThreads), kRoundThreads, 0, stream>>>(
          part, c, MN, splits, nbits, es);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const T* a, const T* b, T* c, T* part, int M, int K, int N,
           int tn, int splits, int per, int nbits, int es, void* stream) {
  if (splits < 1 || per < kRoundThreads || per % kRoundThreads != 0 ||
      (splits > 1 && part == nullptr) ||
      static_cast<long long>(splits - 1) * per >= (K > 0 ? K : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (tn) {
    case 1:
      return launch_round_tn<T, 1>(a, b, c, part, M, K, N, splits, per,
                                   nbits, es, st);
    case 2:
      return launch_round_tn<T, 2>(a, b, c, part, M, K, N, splits, per,
                                   nbits, es, st);
    case 4:
      return launch_round_tn<T, 4>(a, b, c, part, M, K, N, splits, per,
                                   nbits, es, st);
    case 8:
      return launch_round_tn<T, 8>(a, b, c, part, M, K, N, splits, per,
                                   nbits, es, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
}  // namespace

extern "C" {

// The plan (tn in {1, 2, 4, 8}, splits, per: K elements a split, a
// multiple of 256, no split empty) from
// kernels/posit_matmul.py::round_matmul_plan; part: splits x M x N
// scratch of the input's type when splits > 1 (else unused).
int posit_matmul_round_f32(const float* a, const float* b, float* c,
                           float* part, int M, int K, int N, int tn,
                           int splits, int per, int nbits, int es,
                           void* stream) {
  return launch<float>(a, b, c, part, M, K, N, tn, splits, per, nbits, es,
                       stream);
}

int posit_matmul_round_f64(const double* a, const double* b, double* c,
                           double* part, int M, int K, int N, int tn,
                           int splits, int per, int nbits, int es,
                           void* stream) {
  return launch<double>(a, b, c, part, M, K, N, tn, splits, per, nbits, es,
                        stream);
}

// a, b: posit bits in a signed container of `bits_size` bytes (1, 2, 4);
// the plan (bn in {64, 128, 256}, splits, slabs_per_split, grid: blocks
// of the persistent launch, use_table: decode by a table of the 2^nbits
// values, nbits <= 16) from kernels/posit_matmul.py::matmul_plan;
// part: splits x M x N f32 scratch when splits > 1 (else unused).
int posit_matmul_decode(const void* a, const void* b, float* c, float* part,
                        int M, int K, int N, int bits_size, int nbits, int es,
                        int bn, int splits, int slabs_per_split, int grid,
                        int use_table, void* stream) {
  if (nbits < 2 || nbits > 32 || splits < 1 || slabs_per_split < 1 ||
      grid < 1 || (use_table && nbits > kTableBits))
    return static_cast<int>(cudaErrorInvalidValue);
  switch (bits_size) {
    case 1:
      return launch_decode<int8_t>(a, b, c, part, M, K, N, nbits, es, bn,
                                   splits, slabs_per_split, grid, use_table,
                                   stream);
    case 2:
      return launch_decode<int16_t>(a, b, c, part, M, K, N, nbits, es, bn,
                                    splits, slabs_per_split, grid, use_table,
                                    stream);
    case 4:
      return launch_decode<int32_t>(a, b, c, part, M, K, N, nbits, es, bn,
                                    splits, slabs_per_split, grid, use_table,
                                    stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
