// A range of rounded radix-2 FFT stages in one launch, for Hopper (sm_90a).
//
// Replaces repro/kernels/posit_round.py::posit_butterfly_2d on the FFT
// path.  The TPU kernel runs one launch per Stockham stage over the whole
// plane, and the stage loop around it splits and joins the planes in
// device memory between stages.  Here one launch runs stages s0 .. s0+k-1:
// over k stages the state splits into independent groups of 2^k complex
// values (kernels/posit_fft.py says why), so a block loads its groups into
// shared memory, runs the k stages there with a barrier between them, and
// writes each group's outputs straight into the layout the stage loop
// holds after the range (transposed l·R + r, or natural r·L + l).
//
// Bound on the H100: device memory is touched once per launch instead of
// once per stage (16 bytes per f32 value pair); what holds the kernel back
// beyond that is read from its SASS (chip_smoke.py counts the stage loop's
// instructions, and the integer ones among them, against the card's issue
// rates) and not yet settled (PERF.md).  Index arithmetic
// is 32-bit shifts and masks (every size is a power of two; the wrapper
// refuses 2^31 elements or more).
//
// The butterfly is posit_butterfly_kernel's (csrc/posit_round.cu), the same
// ten rounded ops in the same order: t = w ⊗ o (4 mul + 2 add), u = e + t,
// v = e − t.  Build with -fmad=false so no product is contracted into the
// add that follows.
//
// The twiddles of every stage come from one table: (2, n - 1), stage s's
// 2^s values at offset 2^s - 1, wr then wi.
#include "posit_math.cuh"

namespace {

constexpr int kMaxSmem = 48 * 1024;  // kernels/posit_fft.py SMEM_BUDGET

struct FFTPass {
  int nfft;         // FFTs in the batch
  int log_n;        // log2 of the FFT length
  int s0;           // first stage of the pass
  int k;            // stages in the pass: groups of 2^k values
  int log_g;        // log2 of the groups a block
  int tr_in;        // entering state transposed (l·R0 + r) or natural
  int tr_out;       // state after the pass transposed or natural
};

template <typename T>
__device__ __forceinline__ T rnd(T x, int nbits, int es) {
  return round_posit_math<T>(x, nbits, es);
}

// (l0, rr) of group gl of one FFT: along rr first where the entering state
// is transposed, along l0 first where it is natural, so a block's loads of
// neighbouring groups are neighbouring addresses.
__device__ __forceinline__ void group_origin(const FFTPass& p, unsigned gl,
                                             unsigned& l0, unsigned& rr) {
  const unsigned log_rk = p.log_n - p.s0 - p.k;
  if (p.tr_in) {
    rr = gl & ((1u << log_rk) - 1);
    l0 = gl >> log_rk;
  } else {
    l0 = gl & ((1u << p.s0) - 1);
    rr = gl >> p.s0;
  }
}

// Shared memory: buffer b, plane c (0 re, 1 im), group gg, member j at
// sm[((2 b + c) << (log_g + k)) + (gg << k) + j].
template <typename T>
__global__ void posit_fft_stages_kernel(const T* __restrict__ z,
                                        T* __restrict__ y,
                                        const T* __restrict__ tw, FFTPass p,
                                        int nbits, int es) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const unsigned n = 1u << p.log_n;
  const unsigned log_gsz = p.log_g + p.k;     // values of a plane of a buffer
  const unsigned gsz = 1u << log_gsz;
  const unsigned log_groups = p.log_n - p.k;  // groups of one FFT
  const unsigned log_rk = log_groups - p.s0;  // R0 >> k
  const unsigned total = static_cast<unsigned>(p.nfft) << log_groups;
  const unsigned first = blockIdx.x << p.log_g;
  const unsigned im = static_cast<unsigned>(p.nfft) << p.log_n;
  const unsigned gmask = (1u << p.log_g) - 1;

  // load: member j of group gg is (l0, rr + j·Rk) of the entering state
  for (unsigned idx = threadIdx.x; idx < gsz; idx += blockDim.x) {
    const unsigned gg = idx & gmask, j = idx >> p.log_g;
    const unsigned gi = first + gg;
    if (gi >= total) continue;
    unsigned l0, rr;
    group_origin(p, gi & ((1u << log_groups) - 1), l0, rr);
    const unsigned r = rr + (j << log_rk);
    const unsigned at = ((gi >> log_groups) << p.log_n) +
                        (p.tr_in ? (l0 << (p.log_n - p.s0)) + r
                                 : (r << p.s0) + l0);
    const unsigned s = (gg << p.k) + j;
    sm[s] = z[at];
    sm[gsz + s] = z[im + at];
  }
  __syncthreads();

  // stage t: member (a, b) of the local (2^t, 2^(k-t)) state is
  // (l0 + a·L0, rr + b·Rk) of the global one; butterfly q = a·h + b pairs
  // members 2q - b and 2q - b + h and writes members q and q + 2^(k-1)
  const unsigned log_half = p.k - 1;
  const unsigned bfly = 1u << (p.log_g + log_half);
  // one copy of each loop's body, none unrolled: the SASS between the
  // load's barrier and the stages' is what a thread issues a stage
#pragma unroll 1
  for (int t = 0; t < p.k; ++t) {
    const T* src = sm + ((t & 1) << (log_gsz + 1));
    T* dst = sm + (((t + 1) & 1) << (log_gsz + 1));
    const unsigned log_h = p.k - t - 1;
    const unsigned h = 1u << log_h;
    const unsigned off = (1u << (p.s0 + t)) - 1;   // stage s0 + t's twiddles
#pragma unroll 1
    for (unsigned idx = threadIdx.x; idx < bfly; idx += blockDim.x) {
      const unsigned gg = idx >> log_half;
      const unsigned q = idx & ((1u << log_half) - 1);
      const unsigned gi = first + gg;
      if (gi >= total) continue;
      unsigned l0, rr;
      group_origin(p, gi & ((1u << log_groups) - 1), l0, rr);
      const unsigned a = q >> log_h, b = q & (h - 1);
      const unsigned l = l0 + (a << p.s0);
      const T wr = tw[off + l], wi = tw[n - 1 + off + l];
      const unsigned base = gg << p.k;
      const unsigned ie = base + 2 * q - b, io = ie + h;
      const T er = src[ie], ei = src[gsz + ie];
      const T o_r = src[io], oi = src[gsz + io];
      const T t_r = rnd(rnd(wr * o_r, nbits, es) - rnd(wi * oi, nbits, es),
                        nbits, es);
      const T t_i = rnd(rnd(wr * oi, nbits, es) + rnd(wi * o_r, nbits, es),
                        nbits, es);
      const unsigned iu = base + q, iv = iu + (1u << log_half);
      dst[iu] = rnd(er + t_r, nbits, es);
      dst[gsz + iu] = rnd(ei + t_i, nbits, es);
      dst[iv] = rnd(er - t_r, nbits, es);
      dst[gsz + iv] = rnd(ei - t_i, nbits, es);
    }
    __syncthreads();
  }

  // store: member i of group gg is (l0 + i·L0, rr) of the state after the
  // pass, (L1, R1) = (L0·2^k, Rk)
  const T* fin = sm + ((p.k & 1) << (log_gsz + 1));
  for (unsigned idx = threadIdx.x; idx < gsz; idx += blockDim.x) {
    const unsigned gg = idx & gmask, i = idx >> p.log_g;
    const unsigned gi = first + gg;
    if (gi >= total) continue;
    unsigned l0, rr;
    group_origin(p, gi & ((1u << log_groups) - 1), l0, rr);
    const unsigned l = l0 + (i << p.s0);
    const unsigned at = ((gi >> log_groups) << p.log_n) +
                        (p.tr_out ? (l << log_rk) + rr
                                  : (rr << (p.s0 + p.k)) + l);
    const unsigned s = (gg << p.k) + i;
    y[at] = fin[s];
    y[im + at] = fin[gsz + s];
  }
}

template <typename T>
int launch_fft_stages(const T* z, T* y, const T* tw, int nfft, int log_n,
                      int s0, int k, int log_g, int tr_in, int tr_out,
                      int blocks, int threads, int smem, int nbits, int es,
                      void* stream) {
  const long long per_plane = static_cast<long long>(nfft) << log_n;
  if (nfft < 1 || k < 1 || s0 < 0 || s0 + k > log_n || log_g < 0 ||
      2 * per_plane >= (1ll << 31) || threads < 1 || threads > 1024 ||
      smem != static_cast<int>(4 * sizeof(T)) << (log_g + k) ||
      smem > kMaxSmem || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const FFTPass p{nfft, log_n, s0, k, log_g, tr_in, tr_out};
  posit_fft_stages_kernel<T><<<blocks, threads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      z, y, tw, p, nbits, es);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int posit_fft_stages_f32(const float* z, float* y, const float* tw, int nfft,
                         int log_n, int s0, int k, int log_g, int tr_in,
                         int tr_out, int blocks, int threads, int smem,
                         int nbits, int es, void* stream) {
  return launch_fft_stages<float>(z, y, tw, nfft, log_n, s0, k, log_g, tr_in,
                                  tr_out, blocks, threads, smem, nbits, es,
                                  stream);
}

int posit_fft_stages_f64(const double* z, double* y, const double* tw,
                         int nfft, int log_n, int s0, int k, int log_g,
                         int tr_in, int tr_out, int blocks, int threads,
                         int smem, int nbits, int es, void* stream) {
  return launch_fft_stages<double>(z, y, tw, nfft, log_n, s0, k, log_g,
                                   tr_in, tr_out, blocks, threads, smem,
                                   nbits, es, stream);
}

}  // extern "C"
