// One decode step of attention against a posit-quantized KV cache, for
// Hopper (sm_90a): q (B, KV, G, D) f32 attends over K/V posit bits held as
// the cache holds them, (B, S, KV, D), with a per-row valid length.
//
// Replaces repro/kernels/posit_kv_attention.py::posit_kv_attention (with
// the B x KV vmap of repro/kernels/ops.py::kv_attention folded into the
// grid).  As on the TPU, the K/V bits stay narrow in device memory and are
// decoded in on-chip storage (the codec's shared device function,
// posit_decode.cuh), and the softmax runs online over the key blocks of
// _block_plan (bs rounded to 8, S padded with masked zeros), with the
// (m, l, acc) carry updated once per block:
//   logits = (q . k) * D**-0.5, masked to -1e30 where pos >= min(len, S)
//   m' = max(m, max logits); p = exp(logits - m') (0 where masked)
//   l' = l * exp(m - m') + sum p;  acc' = acc * exp(m - m') + p . v
//   out = acc / max(l, 1e-30)
//
// Bound on the H100: memory.  A decode step reads 2 S D narrow integers per
// (row, KV head) and does 4 G D operations per position: G = 4 gives about
// 16 f32 operations per posit8 byte, below the ~20 where the card's 67
// TFLOP/s of f32 would take over from its 3.35 TB/s; the posit decode of
// every K and V value is integer work on top.  One block per (row, KV head)
// would leave most of the card idle (B x KV = 32 blocks on 132 SMs), so:
//  * the key blocks are split across blocks (flash-decoding): the grid is
//    (B KV, splits), block (bh, s) runs the online softmax over its
//    contiguous range of key blocks and writes (m, l, acc) partials to
//    scratch; posit_kv_combine_kernel merges the splits in a fixed order,
//    M = max m_s, w_s = exp(m_s - M), out = sum w_s acc_s / max(sum w_s
//    l_s, 1e-30).  The wrapper's plan (kernels/posit_kv_attention.py::
//    kv_split_plan) takes the splits from S, B KV and the SM count: one
//    split, and no combine launch, when the cache fits one key block;
//  * key blocks, and rows of a block, at or past the row's length are
//    neither fetched nor decoded: a fully masked block leaves (m, l, acc)
//    unchanged;
//  * the split's valid K/V rows stream through shared memory in tiles of
//    ~16 KB, a ring of 4 that cp.async fills 3 tiles ahead, so that the
//    loads of later tiles are in flight while one is computed;
//  * a warp takes one key row at a time, each lane EL consecutive elements
//    of it, decodes them (posit8: a 256-entry f32 table in shared memory,
//    one copy per bank so that 32 lanes never conflict; wider posits: the
//    arithmetic decoder) and contracts them with its slice of q held in
//    registers, with explicit __fmaf_rn; the row's G dot products are then
//    summed across the lanes in one transposed butterfly (G - 1 + 5 -
//    log2 G shuffles, not 5 G);
//  * for p . v each lane owns EL outputs of each query row, and each warp
//    keeps its own partial of acc over the rows it read; the warps' partials
//    are added, in warp order, once per split;
//  * a KV head with more query rows than a variant keeps in registers (Gq
//    > 8, or > 4 at D > 128) is cut into groups of at most Gc rows, the
//    grid's third dimension: attention rows are independent, so each group
//    runs the same schedule on its slice of q and of the output, and reads
//    the same K/V (from L2 after the first group).
// The cache is read in place through its (B, S, KV) strides, never copied
// or transposed; its rows must be contiguous and 16-byte aligned, as a
// cache's always are.
//
// Build with -fmad=false: the carry updates l * alpha + sum and acc * alpha
// + p . v are two roundings each in the reference, not one fused
// multiply-add; the dot products spell out their fused multiply-adds.
#include <cstdint>
#include <type_traits>

#include "posit_decode.cuh"

namespace {
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTableCopies = 32;   // one copy of the posit8 table per bank
constexpr int kStages = 4;         // tiles of K/V rows in flight or in use
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// GP values per lane -> the warp's sums of all GP of them, value g held by
// the lanes g << (5 - log2 GP) ... (g + 1) << (5 - log2 GP) - 1.  While
// more than one value is left, the lanes of one half keep the upper half
// of their values and the others the lower half, each adding its
// partner's copy of what it keeps (GP - 1 shuffles); the last value is
// then summed over the remaining lanes.
template <int GP>
__device__ __forceinline__ float transpose_sum(float (&v)[GP], int lane) {
#pragma unroll
  for (int half = GP / 2, o = 16; o > 0; half /= 2, o /= 2) {
    if (half >= 1) {
      const bool upper = (lane & o) != 0;
#pragma unroll
      for (int i = 0; i < half; ++i) {
        const float lo = v[i], hi = v[i + half];
        const float send = upper ? lo : hi;
        const float keep = upper ? hi : lo;
        v[i] = __fadd_rn(keep, __shfl_xor_sync(kFull, send, o));
      }
    } else {
      v[0] = __fadd_rn(v[0], __shfl_xor_sync(kFull, v[0], o));
    }
  }
  return v[0];
}

// The EL patterns of a lane's slice of one staged row (elements [0, n) of
// `src`, n <= EL), as raw words: one vector load when the slice is whole.
template <typename S, int EL>
struct Slice {
  static constexpr int kBytes = EL * static_cast<int>(sizeof(S));
  static constexpr int kWords = kBytes < 4 ? 1 : kBytes / 4;
  uint32_t w[kWords];

  __device__ __forceinline__ void load(const S* src, int n) {
#pragma unroll
    for (int i = 0; i < kWords; ++i) w[i] = 0u;
    if (kBytes >= 4 && n >= EL) {
      if constexpr (kBytes == 4) {
        w[0] = *reinterpret_cast<const unsigned int*>(src);
      } else if constexpr (kBytes == 8) {
        const uint2 t = *reinterpret_cast<const uint2*>(src);
        w[0] = t.x;
        w[1] = t.y;
      } else {
#pragma unroll
        for (int i = 0; i < kWords / 4; ++i) {
          const uint4 t = reinterpret_cast<const uint4*>(src)[i];
          w[4 * i] = t.x;
          w[4 * i + 1] = t.y;
          w[4 * i + 2] = t.z;
          w[4 * i + 3] = t.w;
        }
      }
    } else {
#pragma unroll
      for (int e = 0; e < EL; ++e) {
        if (e < n) {
          const uint32_t bits = static_cast<uint32_t>(
              static_cast<std::make_unsigned_t<S>>(src[e]));
          w[e * sizeof(S) / 4] |= bits << ((e * sizeof(S)) % 4 * 8);
        }
      }
    }
  }

  // pattern e (its low n bits; decode masks the rest)
  __device__ __forceinline__ int32_t raw(int e) const {
    return static_cast<int32_t>(w[e * sizeof(S) / 4] >>
                                ((e * sizeof(S)) % 4 * 8));
  }
};

// An int8 container holds at most 8 bits: its patterns go through the
// table (whose 256 entries are the decoder's values of every byte, so no
// masking), wider containers through the arithmetic decoder.  `lane_table`
// is the table offset by the lane's bank.
template <typename S>
__device__ __forceinline__ float decode_value(int32_t raw, int nbits, int es,
                                              const float* lane_table) {
  if constexpr (sizeof(S) == 1)
    return lane_table[(static_cast<uint32_t>(raw) & 0xFFu) * kTableCopies];
  else
    return posit::decode_f32(raw, nbits, es);
}
}  // namespace

// Grid (B KV, splits, groups), 256 threads.  Block (bh, s, grp) takes query
// rows [grp Gc, grp Gc + G) of q's Gq rows per KV head, G = min(Gc, Gq - grp
// Gc).  GP: Gc rounded up to a power of two,
// at least 2 (query rows g >= G are zero and never stored); EL: elements
// of a row per lane, D <= 32 EL; a warp takes one key row at a time.  The
// split's valid rows stream through shared memory as tiles of T rows, for
// each key block its K tiles then its V tiles, in a ring of kStages tiles
// that cp.async fills kStages - 1 tiles ahead.
// Dynamic shared memory: m, l, alpha (128 bytes), the posit8 table (256 x
// 32 f32, int8 patterns only), the block's logits (bs x GP f32, a row's GP
// together) and the ring; the end of the split reuses it for the warps'
// partials (8 x Gc x D f32).
template <typename S, int EL, int GP>
__global__ void __launch_bounds__(kThreads) posit_kv_attention_kernel(
    const float* __restrict__ q, const S* __restrict__ kb,
    const S* __restrict__ vb, const int* __restrict__ lengths,
    float* __restrict__ out, float* __restrict__ part, int KV, int Gq,
    int Gc, int D, int Slen, long long sB, long long sS, long long sH,
    int bs, int n_blocks, int blocks_per_split, int T, float scale,
    int nbits, int es) {
  constexpr bool use_table = sizeof(S) == 1;
  extern __shared__ float smem[];
  float* m_s = smem;
  float* l_s = m_s + 8;
  float* a_s = l_s + 8;
  float* table_s = smem + 32;
  float* p_s = table_s + (use_table ? 256 * kTableCopies : 0);
  S* ring = reinterpret_cast<S*>(p_s + bs * GP);  // 16-byte aligned: bs % 8
  float* red = table_s;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int bh = blockIdx.x, split = blockIdx.y, splits = gridDim.y;
  const int b = bh / KV, h = bh % KV;
  const int g0 = blockIdx.z * Gc;              // the group's first row
  const int G = min(Gc, Gq - g0);              // and its rows
  const int GD = G * D;
  int len = lengths[b];
  len = len < Slen ? len : Slen;
  const long long head = b * sB + h * sH;
  const int d0 = lane * EL;            // this lane's slice of a row
  const int n_el = D - d0;             // elements of it inside D
  const int tile_elems = T * D;
  const int chunks_per_row = D * static_cast<int>(sizeof(S)) / 16;

  if (use_table) {
    for (int i = tid; i < 256 * kTableCopies; i += kThreads)
      table_s[i] = posit::decode_f32(i / kTableCopies, nbits, es);
  }
  const float* table = table_s + lane;   // this lane's bank
  for (int g = tid; g < GP; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.0f;
  }
  float qr[GP][EL], acc[GP][EL], pv[GP][EL];
  const long long row0 = (static_cast<long long>(bh) * Gq + g0) * D;
  const float* qh = q + row0;
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int e = 0; e < EL; ++e) {
      qr[g][e] = (g < G && e < n_el) ? qh[g * D + d0 + e] : 0.0f;
      acc[g][e] = pv[g][e] = 0.0f;
    }

  // the split's tiles: key blocks [blk0, blk_end) hold valid rows; block
  // blk's tiles are its K tiles then its V tiles, T rows each but the last
  const int blk0 = split * blocks_per_split;
  int blk_end = min(n_blocks, blk0 + blocks_per_split);
  blk_end = min(blk_end, (len + bs - 1) / bs);
  const int full_tiles = (bs + T - 1) / T;
  int n_tiles = 0;
  if (blk_end > blk0) {
    const int last_valid = min(bs, len - (blk_end - 1) * bs);
    n_tiles = (blk_end - 1 - blk0) * 2 * full_tiles +
              2 * ((last_valid + T - 1) / T);
  }
  // tile t -> key block, K (0) or V (1), first row in the block, rows,
  // the block's valid rows, and whether it is the block's last K/V tile
  struct Tile {
    int blk, kind, row0, rows, valid;
    bool last;
  };
  auto tile_at = [&](int t) {
    Tile x;
    const int qb = t / (2 * full_tiles);
    x.blk = blk0 + qb;
    x.valid = min(bs, len - x.blk * bs);
    const int nt = (x.valid + T - 1) / T;
    const int r = t - qb * 2 * full_tiles;
    x.kind = r >= nt ? 1 : 0;
    const int j = r - x.kind * nt;
    x.row0 = j * T;
    x.rows = min(T, x.valid - x.row0);
    x.last = j == nt - 1;
    return x;
  };
  auto prefetch = [&](int t) {
    if (t < n_tiles) {
      const Tile x = tile_at(t);
      const S* src = (x.kind ? vb : kb) + head + (x.blk * bs + x.row0) * sS;
      S* dst = ring + (t % kStages) * tile_elems;
      for (int c = tid; c < x.rows * chunks_per_row; c += kThreads) {
        const int r = c / chunks_per_row, col = c - r * chunks_per_row;
        cp_async16(dst + r * D + col * (16 / sizeof(S)),
                   src + r * sS + col * (16 / sizeof(S)));
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) prefetch(t);

  for (int t = 0; t < n_tiles; ++t) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();     // tile t landed; tile t - 1 consumed by every warp
    prefetch(t + kStages - 1);   // into the stage tile t - 1 held
    const Tile x = tile_at(t);
    const S* tile = ring + (t % kStages) * tile_elems;
    if (x.kind == 0) {
      // logits of the tile's rows, one row per warp step
      constexpr int kLog2 = GP == 2 ? 1 : (GP == 4 ? 2 : 3);
      const int gw = lane >> (5 - kLog2);   // the row this lane stores
      const bool writer = (lane & ((32 >> kLog2) - 1)) == 0 && gw < G;
#pragma unroll 4
      for (int r = warp; r < x.rows; r += kWarps) {
        Slice<S, EL> sl;
        sl.load(tile + r * D + d0, n_el);
        float kv[EL];
#pragma unroll
        for (int e = 0; e < EL; ++e)
          kv[e] = decode_value<S>(sl.raw(e), nbits, es, table);
        float v[GP];
#pragma unroll
        for (int gg = 0; gg < GP; ++gg) {
          float s = 0.0f;
#pragma unroll
          for (int e = 0; e < EL; ++e) s = __fmaf_rn(qr[gg][e], kv[e], s);
          v[gg] = s;
        }
        const float dot = transpose_sum<GP>(v, lane);
        if (writer) p_s[(x.row0 + r) * GP + gw] = __fmul_rn(dot, scale);
      }
      if (x.last) {
        __syncthreads();   // every logit of the block written
        // per query row: the new max (over the block's masked positions
        // too, at -1e30), p, the carry's alpha and denominator
        for (int g = warp; g < G; g += kWarps) {
          float* pg = p_s + g;             // row j at pg[j * GP]
          float mx = x.valid < bs ? kNegInf : -INFINITY;
          for (int j = lane; j < x.valid; j += 32)
            mx = fmaxf(mx, pg[j * GP]);
          mx = warp_max(mx);
          const float m_prev = m_s[g];
          const float m_new = fmaxf(m_prev, mx);
          float sum = 0.0f;
          for (int j = lane; j < x.valid; j += 32) {
            const float p = expf(pg[j * GP] - m_new);
            pg[j * GP] = p;
            sum = __fadd_rn(sum, p);
          }
          sum = warp_sum(sum);
          if (lane == 0) {
            const float alpha = expf(m_prev - m_new);
            l_s[g] = __fadd_rn(__fmul_rn(l_s[g], alpha), sum);
            m_s[g] = m_new;
            a_s[g] = alpha;
          }
        }
      }
    } else {
      // p . v over the tile's rows; after the block's last V tile,
      // acc = acc * alpha + p . v
#pragma unroll 4
      for (int row = warp; row < x.rows; row += kWarps) {
        Slice<S, EL> sl;
        sl.load(tile + row * D + d0, n_el);
        float vv[EL];
#pragma unroll
        for (int e = 0; e < EL; ++e)
          vv[e] = decode_value<S>(sl.raw(e), nbits, es, table);
        float p[GP];                       // the row's GP weights
        const float* pr = p_s + (x.row0 + row) * GP;
#pragma unroll
        for (int g = 0; g < GP; g += 2) {
          const float2 t = *reinterpret_cast<const float2*>(pr + g);
          p[g] = t.x;
          p[g + 1] = t.y;
        }
#pragma unroll
        for (int g = 0; g < GP; ++g)
#pragma unroll
          for (int e = 0; e < EL; ++e)
            pv[g][e] = __fmaf_rn(p[g], vv[e], pv[g][e]);
      }
      if (x.last) {
#pragma unroll
        for (int g = 0; g < GP; ++g) {
          const float alpha = g < G ? a_s[g] : 1.0f;
#pragma unroll
          for (int e = 0; e < EL; ++e) {
            acc[g][e] = __fadd_rn(__fmul_rn(acc[g][e], alpha), pv[g][e]);
            pv[g][e] = 0.0f;
          }
        }
      }
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();     // the ring, the table and the logits are free

  // the warps' partials of acc, added in warp order
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int e = 0; e < EL; ++e)
      if (g < G && e < n_el) red[(warp * G + g) * D + d0 + e] = acc[g][e];
  __syncthreads();
  // partials of (bh, group, split) in slot (bh groups + group) splits +
  // split, each Gc D acc floats (rows past G unused)
  const long long slot =
      (static_cast<long long>(bh) * gridDim.z + blockIdx.z) * splits + split;
  const int GcD = Gc * D;
  for (int o = tid; o < GD; o += kThreads) {
    float s = red[o];
    for (int w = 1; w < kWarps; ++w) s = __fadd_rn(s, red[w * GD + o]);
    const int g = o / D;
    if (splits == 1) {
      out[row0 + o] = s / fmaxf(l_s[g], 1e-30f);
    } else {
      part[slot * GcD + o] = s;
    }
  }
  if (splits > 1) {
    // (m, l) of every slot after all acc partials: (n_slots Gc D) acc
    // floats, then (n_slots Gc) m, then as many l
    const long long n_slots =
        static_cast<long long>(gridDim.x) * gridDim.z * splits;
    float* ml = part + n_slots * GcD;
    for (int g = tid; g < G; g += kThreads) {
      ml[slot * Gc + g] = m_s[g];
      ml[n_slots * Gc + slot * Gc + g] = l_s[g];
    }
  }
}

// Grid (B KV, groups): out rows of (bh, group) from the splits' partials,
// split 0 first, in that order.
__global__ void posit_kv_combine_kernel(const float* __restrict__ part,
                                        float* __restrict__ out, int Gq,
                                        int Gc, int D, int splits) {
  const int bh = blockIdx.x, g0 = blockIdx.y * Gc;
  const int G = min(Gc, Gq - g0), GD = G * D, GcD = Gc * D;
  const long long n_slots =
      static_cast<long long>(gridDim.x) * gridDim.y * splits;
  const long long first =
      (static_cast<long long>(bh) * gridDim.y + blockIdx.y) * splits;
  const float* acc = part + first * GcD;
  const float* m = part + n_slots * GcD + first * Gc;
  const float* l = m + n_slots * Gc;
  const long long row0 = (static_cast<long long>(bh) * Gq + g0) * D;
  for (int o = threadIdx.x; o < GD; o += blockDim.x) {
    const int g = o / D;
    float mx = kNegInf;
    for (int s = 0; s < splits; ++s) mx = fmaxf(mx, m[s * Gc + g]);
    float num = 0.0f, den = 0.0f;
    for (int s = 0; s < splits; ++s) {
      const float w = expf(m[s * Gc + g] - mx);
      num = __fadd_rn(num, __fmul_rn(w, acc[s * GcD + o]));
      den = __fadd_rn(den, __fmul_rn(w, l[s * Gc + g]));
    }
    out[row0 + o] = num / fmaxf(den, 1e-30f);
  }
}

namespace {
struct Args {
  const float* q;
  const void* kb;
  const void* vb;
  const int* lengths;
  float* out;
  float* part;
  int B, KV, Gq, Gc, groups, D, Slen;
  long long sB, sS, sH;
  int bs, n_blocks, blocks_per_split, splits, T;
  float scale;
  int nbits, es;
};

template <typename S, int EL, int GP>
int launch(const Args& a, void* stream) {
  constexpr bool use_table = sizeof(S) == 1;
  const size_t work =
      (use_table ? 256 * kTableCopies : 0) * sizeof(float) +
      static_cast<size_t>(GP) * a.bs * sizeof(float) +
      static_cast<size_t>(kStages) * a.T * a.D * sizeof(S);
  const size_t red = static_cast<size_t>(kWarps) * a.Gc * a.D * sizeof(float);
  const size_t smem = 32 * sizeof(float) + (work > red ? work : red);
  auto kernel = posit_kv_attention_kernel<S, EL, GP>;
  static size_t smem_set = 48 * 1024;   // the largest size allowed so far
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  kernel<<<dim3(a.B * a.KV, a.splits, a.groups), kThreads, smem, st>>>(
      a.q, static_cast<const S*>(a.kb), static_cast<const S*>(a.vb),
      a.lengths, a.out, a.part, a.KV, a.Gq, a.Gc, a.D, a.Slen, a.sB, a.sS,
      a.sH,
      a.bs, a.n_blocks, a.blocks_per_split, a.T, a.scale, a.nbits, a.es);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  posit_kv_combine_kernel<<<dim3(a.B * a.KV, a.groups), kThreads, 0, st>>>(
      a.part, a.out, a.Gq, a.Gc, a.D, a.splits);
  return static_cast<int>(cudaGetLastError());
}

// EL in {1, 2, 4, 8} and GP in {2, 4, 8} with EL GP <= 32 (q's slice
// and the accumulators in registers); G = 1 runs as GP = 2.
template <typename S, int GP>
int launch_el(const Args& a, int el, void* stream) {
  switch (el) {
    case 1: return launch<S, 1, GP>(a, stream);
    case 2: return launch<S, 2, GP>(a, stream);
    case 4: return launch<S, 4, GP>(a, stream);
    case 8: if constexpr (GP <= 4) return launch<S, 8, GP>(a, stream);
            break;
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <typename S>
int launch_s(const Args& a, int el, int gp, void* stream) {
  switch (gp) {
    case 2: return launch_el<S, 2>(a, el, stream);
    case 4: return launch_el<S, 4>(a, el, stream);
    case 8: return launch_el<S, 8>(a, el, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
}  // namespace

extern "C" {

// q, out: (B, KV, Gq, D) f32 contiguous; k/v bits: (B, S, KV, D) read
// through the element strides (sB, sS, sH, sD), with sD == 1 and every row
// 16-byte aligned (else cudaErrorInvalidValue); lengths: (B,) int32.
// bits_bytes: 1, 2 or 4 (int8/int16/int32 patterns).  The plan (Gc,
// groups, bs, n_blocks, blocks_per_split, splits, el, gp) from
// kernels/posit_kv_attention.py; part: scratch of B KV groups splits (Gc D
// + 2 Gc) floats when splits > 1 (else unused).
int posit_kv_attention(const float* q, const void* kb, const void* vb,
                       const int* lengths, float* out, float* part, int B,
                       int KV, int Gq, int Gc, int groups, int D, int Slen,
                       long long sB,
                       long long sS, long long sH, long long sD, int bs,
                       int n_blocks, int blocks_per_split, int splits,
                       int el, int gp, float scale, int bits_bytes,
                       int nbits, int es, void* stream) {
  const long long e = bits_bytes;
  const bool aligned =
      sD == 1 && (D * e) % 16 == 0 && (sS * e) % 16 == 0 &&
      (sH * e) % 16 == 0 && (sB * e) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(kb) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(vb) % 16 == 0;
  if (!aligned || Gc > gp || Gc < 1 || groups < 1 ||
      static_cast<long long>(groups) * Gc < Gq ||
      static_cast<long long>(groups - 1) * Gc >= Gq || groups > 65535 ||
      D > 32 * el || splits < 1 ||
      (bits_bytes == 1 && nbits > 8) ||
      blocks_per_split < 1 ||
      static_cast<long long>(splits) * blocks_per_split < n_blocks)
    return static_cast<int>(cudaErrorInvalidValue);
  // K/V rows per tile: about 16 KB of bits, a multiple of 8, at most bs
  int T = 16384 / (D * bits_bytes);
  T = (T < 8 ? 8 : (T > bs ? bs : T)) / 8 * 8;
  const Args a{q,  kb,   vb,     lengths, out, part, B,  KV, Gq, Gc,
               groups, D, Slen, sB, sS, sH, bs, n_blocks,
               blocks_per_split, splits, T, scale, nbits, es};
  switch (bits_bytes) {
    case 1: return launch_s<int8_t>(a, el, gp, stream);
    case 2: return launch_s<int16_t>(a, el, gp, stream);
    case 4: return launch_s<int32_t>(a, el, gp, stream);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
