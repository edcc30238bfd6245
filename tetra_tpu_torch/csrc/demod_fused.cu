// Fused hard-decision pi/4-DQPSK demodulator (kernel K5 of the port), at
// every rate sps = 1..11 (a template parameter; the TPU kernel takes every
// sps whose 11*sps-tap filter fits its 128-lane halo). Sps 2 is the rate
// of the steady chain and of bench stage 5; the design below was made for
// it, and the other rates reuse it with their own tiling.
//
// Replaces: tetra_tpu/phy/demod_pallas.py, _demod_sel (Pallas body
// _make_kernel) together with the phase argmax and gather XLA runs after
// it: RRC matched filter, differential phasor over sps samples, sign
// decisions b0 = (Im d <= 0), b1 = (Re d < 0), the per-phase |sin 2θ|
// timing metric summed over the whole stream, the pick of the phase with
// the larger sum, and the chosen phase's decisions unpacked to bits.
// Planar baseband re, im f32 [C, T] -> bits int8 [C, 2*(T/sps)], best
// int64 [C], met f32 [C, sps].
//
// What bounds it on an H100, at sps 2: each sample is read once (8 bytes)
// and one bit byte written (9 bytes a sample, 0.36 ms at [4096, 32768];
// the scratch row below adds half a byte out and back); the filter costs
// 2*K = 44 multiply-adds a sample and the metric an IEEE division, about
// half that time at the f32 rate, so device memory is the limit as long
// as the FIR's operands come from registers and not from a shared-memory
// load per tap. At sps s the filter has 11s taps and a sample costs 22s
// multiply-adds, so from sps 4 or so the arithmetic is the limit.
//
// Design:
// - One block per carrier. The TPU grid's sequential time axis (the
//   metric accumulated across time blocks) becomes a loop over time
//   tiles of kTile samples inside the block, so the whole-stream metric,
//   the phase pick and the final bits need no second launch and nothing
//   but the decisions leaves the block before the pick.
// - The window of tile j + 1 is copied to shared memory (cp.async,
//   double buffer; 16 bytes a copy where the rows are 16-byte aligned)
//   while tile j is filtered, so device-memory reads overlap the block's
//   own arithmetic.
// - Register-tiled FIR: each thread owns kR = kSymT * sps consecutive
//   samples of the tile (whole symbols; 16 at sps 1 and 2) and computes
//   the filter at kR + sps positions (the extra sps give the lag of its
//   first samples), from a window of kR + sps + K - 1 input values. At
//   sps 1..3 the window is read into registers with 16-byte shared loads;
//   the window buffer pads every 16 floats by 4, so at sps 2 the eight
//   threads of a quarter warp, 80 bytes apart, hit distinct banks. From
//   sps 4 the window would not fit the registers, so it streams: each
//   window value is read from shared memory once and added into every
//   output it reaches (kSymT shrinks to 2 and 1 at sps 5-8 and 9-11 to
//   bound those outputs). The taps are a kernel parameter (constant
//   bank) and the loops are unrolled. In both forms the multiply-adds of
//   an output run in tap order k = 0..K-1 on x[t - K/2 + k] * taps[K-1-k],
//   so both give the same value.
// - d and the metric use round-to-nearest intrinsics so that no multiply
//   is contracted into an add: the plain version evaluates them as
//   separate elementwise operations.
// - The lag is zero for the stream's first sps samples, as in the XLA
//   demod's zero-padded lag. Metric range: samples t < (T / sps) * sps,
//   the XLA demod's range (the TPU kernel also counts filter-tail lanes
//   past T in its last block).
// - All phases' decisions of a symbol share one word (phase p in bits
//   2p, 2p + 1; a byte up to sps 4, 32 bits above) in a scratch row the
//   wrapper allocates (tt_demod_fused_scratch gives its size); the block
//   writes it during the tile loop and reads it back (from L2) after the
//   pick.
// - Metric sums in a fixed order, without float atomics: each thread
//   sums its samples of a phase in time order, a warp adds its lanes by
//   an xor-shuffle tree, thread 0 adds the warps in order and the tiles
//   in order. The result is the same on every run, so a near-tie phase
//   pick cannot flip between runs; ties go to the lower phase, as
//   torch.argmax's first maximum.
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kGroup = 16;                   // buffer layout: 16 floats
constexpr int kStride = kGroup + 4;          // ... then 4 of padding

template <int SPS>
struct Cfg {
  static constexpr int kTaps = 11 * SPS;     // rrc_taps(sps)
  static constexpr int kHalf = kTaps / 2;
  // symbols a thread owns: 8 at sps 2 (16 samples); fewer where the
  // filter is long, so that its outputs stay in registers
  static constexpr int kSymT = SPS == 1   ? 16
                               : SPS == 2 ? 8
                               : SPS <= 4 ? 4
                               : SPS <= 8 ? 2
                                          : 1;
  static constexpr int kR = kSymT * SPS;     // samples a thread owns
  static constexpr int kTile = kThreads * kR;
  static constexpr int kTileSym = kThreads * kSymT;
  static constexpr int kNf = kR + SPS;       // filter outputs a thread
  static constexpr int kWin = kNf + kTaps - 1;  // window values a thread
  // the tile's buffer starts kBack samples before the tile (16-byte
  // aligned when the tile is); a thread's window starts kLead values into
  // its first float4
  static constexpr int kBack = (SPS + kHalf + 3) / 4 * 4;
  static constexpr int kLead = kBack - SPS - kHalf;
  static constexpr int kWinLoad = (kLead + kWin + 3) / 4 * 4;
  static constexpr int kBufLogical =
      ((kThreads - 1) * kR + kWinLoad + 3) / 4 * 4;
  static constexpr int kBufPhys =
      (kBufLogical + kGroup - 1) / kGroup * kStride;
  // the window in registers where it is short (sps 1..3), else streamed
  static constexpr bool kRegFir = kR % 4 == 0 && kWinLoad <= 48;
  // a symbol's decisions, phase p in bits 2p, 2p + 1
  using Word = std::conditional_t<2 * SPS <= 8, uint8_t, uint32_t>;
  // whole 8-byte stores of packed symbol bytes
  static constexpr bool kPacked = 2 * SPS <= 8 && kSymT % 8 == 0;
  static_assert(kBufLogical % 4 == 0, "the buffer is whole float4s");
  static_assert(kTile % 4 == 0 && kBack % 4 == 0, "16-byte tile copies");
  static_assert(kBufPhys * 16 + kWarps * SPS * 4 <= 48 * 1024,
                "static shared memory");
};

template <int SPS>
struct Taps {
  float h[11 * SPS];                         // h[k] = taps[K - 1 - k]
};

__device__ __forceinline__ int phys(int i) {
  return i + (kStride - kGroup) * (i / kGroup);
}

// FIR at the thread's kNf positions from its window w[kLead ..)
template <int SPS>
__device__ __forceinline__ void fir(const float* buf, int tid,
                                   const Taps<SPS>& tp,
                                   float (&f)[Cfg<SPS>::kNf]) {
  using G = Cfg<SPS>;
  if constexpr (G::kRegFir) {
    float w[G::kWinLoad];
#pragma unroll
    for (int q = 0; q < G::kWinLoad / 4; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(buf + phys(tid * G::kR + 4 * q));
      w[4 * q] = v.x;
      w[4 * q + 1] = v.y;
      w[4 * q + 2] = v.z;
      w[4 * q + 3] = v.w;
    }
#pragma unroll
    for (int u = 0; u < G::kNf; ++u) {
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < G::kTaps; ++k)
        a = fmaf(w[G::kLead + u + k], tp.h[k], a);
      f[u] = a;
    }
  } else {
#pragma unroll
    for (int u = 0; u < G::kNf; ++u) f[u] = 0.f;
    const int base = tid * G::kR + G::kLead;
#pragma unroll
    for (int j = 0; j < G::kWin; ++j) {
      const float x = buf[phys(base + j)];
#pragma unroll
      for (int u = 0; u < G::kNf; ++u) {
        if (j - u >= 0 && j - u < G::kTaps) f[u] = fmaf(x, tp.h[j - u], f[u]);
      }
    }
  }
}

// asynchronous copy of 4 (N = 1) or 16 (N = 4) bytes of *src to shared
// dst, or zeros where !in (src-size 0: nothing is read)
template <int N>
__device__ __forceinline__ void copy(float* dst, const float* src, bool in) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (N == 4)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(in ? 16 : 0));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
                 "l"(src), "r"(in ? 4 : 0));
}

// window of the tile starting at sample t0 into buffers br, bi, N floats
// a copy: logical L holds sample t0 - kBack + L, zero outside [0, T)
// (the TPU kernel's `valid` mask). N = 4 needs 16-byte aligned rows and
// T % 4 == 0, so that a copy lies wholly inside or outside [0, T). One
// commit group per call.
template <int SPS, int N>
__device__ __forceinline__ void stage(float* br, float* bi, const float* xr,
                                      const float* xi, int t0, int T,
                                      int tid) {
  using G = Cfg<SPS>;
  for (int L = N * tid; L < G::kBufLogical; L += N * kThreads) {
    const int g = t0 - G::kBack + L;
    const bool in = g >= 0 && g < T;
    copy<N>(br + phys(L), in ? xr + g : xr, in);
    copy<N>(bi + phys(L), in ? xi + g : xi, in);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int SPS>
__device__ __forceinline__ void stage_tile(bool vec, float* br, float* bi,
                                           const float* xr, const float* xi,
                                           int t0, int T, int tid) {
  if (vec)
    stage<SPS, 4>(br, bi, xr, xi, t0, T, tid);
  else
    stage<SPS, 1>(br, bi, xr, xi, t0, T, tid);
}

template <int SPS>
__global__ void __launch_bounds__(kThreads, SPS <= 2 ? 4 : 2)
demod_fused_kernel(const float* __restrict__ re, const float* __restrict__ im,
                   const Taps<SPS> tp, int T, int n_tile, bool vec,
                   int8_t* __restrict__ bits, long long* __restrict__ best,
                   float* __restrict__ met, void* __restrict__ scratch) {
  using G = Cfg<SPS>;
  using Word = typename G::Word;
  __shared__ __align__(16) float b_re[2][G::kBufPhys];
  __shared__ __align__(16) float b_im[2][G::kBufPhys];
  __shared__ float red[kWarps][SPS];
  __shared__ int s_best;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t c = blockIdx.x;
  const float* xr = re + c * (size_t)T;
  const float* xi = im + c * (size_t)T;
  const int n_sym = T / SPS;
  const int n_met = n_sym * SPS;
  Word* srow = reinterpret_cast<Word*>(scratch) + c * (size_t)n_tile *
                                                      G::kTileSym;
  float tot[SPS];                            // thread 0's running sums
#pragma unroll
  for (int p = 0; p < SPS; ++p) tot[p] = 0.f;

  stage_tile<SPS>(vec, b_re[0], b_im[0], xr, xi, 0, T, tid);
  for (int j = 0; j < n_tile; ++j) {
    const int t0 = j * G::kTile;
    // the next tile's copies run while this one is computed; its buffer
    // was last read before the previous tile's second barrier
    if (j + 1 < n_tile)
      stage_tile<SPS>(vec, b_re[(j + 1) & 1], b_im[(j + 1) & 1], xr, xi,
                      t0 + G::kTile, T, tid);
    else
      asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();

    float fr[G::kNf], fi[G::kNf];
    fir<SPS>(b_re[j & 1], tid, tp, fr);
    fir<SPS>(b_im[j & 1], tid, tp, fi);

    const int ts = t0 + tid * G::kR;         // the thread's first sample
    float acc[SPS];
#pragma unroll
    for (int p = 0; p < SPS; ++p) acc[p] = 0.f;
    // packed symbol bytes (4 a word) or one word a symbol
    unsigned pk[G::kPacked ? G::kSymT / 4 : 1] = {};
    Word wd[G::kPacked ? 1 : G::kSymT] = {};
#pragma unroll
    for (int r = 0; r < G::kR; ++r) {
      const int t = ts + r;
      const float cr = fr[r + SPS], ci = fi[r + SPS];
      const float lr = t >= SPS ? fr[r] : 0.f;
      const float li = t >= SPS ? fi[r] : 0.f;
      const float dr = __fadd_rn(__fmul_rn(cr, lr), __fmul_rn(ci, li));
      const float di = __fsub_rn(__fmul_rn(ci, lr), __fmul_rn(cr, li));
      const unsigned d = (di <= 0.f ? 1u : 0u) | (dr < 0.f ? 2u : 0u);
      const int s = r / SPS;
      if constexpr (G::kPacked)
        pk[s / 4] |= d << (8 * (s & 3) + 2 * (r % SPS));
      else
        wd[s] |= (Word)(d << (2 * (r % SPS)));
      if (t < n_met) {
        const float mag2 = __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di));
        const float m = __fdiv_rn(__fmul_rn(2.f, fabsf(__fmul_rn(dr, di))),
                                  __fadd_rn(mag2, 1e-12f));
        acc[r % SPS] += m;
      }
    }
    if constexpr (G::kPacked) {
#pragma unroll
      for (int q = 0; q < G::kSymT / 8; ++q)
        *reinterpret_cast<uint2*>(srow + ts / SPS + 8 * q) =
            make_uint2(pk[2 * q], pk[2 * q + 1]);
    } else {
#pragma unroll
      for (int s = 0; s < G::kSymT; ++s) srow[ts / SPS + s] = wd[s];
    }
#pragma unroll
    for (int p = 0; p < SPS; ++p) {
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1)
        acc[p] += __shfl_xor_sync(0xffffffffu, acc[p], off);
    }
    if (lane == 0) {
#pragma unroll
      for (int p = 0; p < SPS; ++p) red[warp][p] = acc[p];
    }
    __syncthreads();
    if (tid == 0) {
#pragma unroll
      for (int p = 0; p < SPS; ++p) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += red[w][p];
        tot[p] += sum;
      }
    }
  }

  if (tid == 0) {
    int b = 0;                               // first maximum
    float bv = tot[0];
#pragma unroll
    for (int p = 1; p < SPS; ++p)
      if (tot[p] > bv) {
        bv = tot[p];
        b = p;
      }
#pragma unroll
    for (int p = 0; p < SPS; ++p) met[c * SPS + p] = tot[p];
    best[c] = b;
    s_best = b;
  }
  __syncthreads();
  const int sh = 2 * s_best;
  int8_t* out = bits + c * (size_t)(2 * n_sym);
  if (sizeof(Word) == 1 && (n_sym & 3) == 0) {
    // four symbols a thread: one 4-byte scratch load, one 8-byte store
    const uint32_t* s4 = reinterpret_cast<const uint32_t*>(srow);
    uint2* o8 = reinterpret_cast<uint2*>(out);
    for (int q = tid; q < n_sym / 4; q += kThreads) {
      const uint32_t v = s4[q];
      uint32_t w[2] = {0u, 0u};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint32_t d = (v >> (8 * i + sh)) & 3u;
        w[i / 2] |= ((d & 1u) | ((d >> 1) << 8)) << (16 * (i & 1));
      }
      o8[q] = make_uint2(w[0], w[1]);
    }
  } else {
    for (int s = tid; s < n_sym; s += kThreads) {
      const unsigned d = ((unsigned)srow[s] >> sh) & 3u;
      out[2 * s] = (int8_t)(d & 1u);
      out[2 * s + 1] = (int8_t)(d >> 1);
    }
  }
}

template <int SPS>
long long scratch_row(int T) {
  using G = Cfg<SPS>;
  const long long n_tile = ((long long)T + G::kTile - 1) / G::kTile;
  return n_tile * G::kTileSym * (long long)sizeof(typename G::Word);
}

template <int SPS>
int launch(const void* re, const void* im, const float* taps, int C, int T,
           void* bits, void* best, void* met, void* scratch, int row,
           cudaStream_t stream) {
  using G = Cfg<SPS>;
  const int n_tile = (int)(((long long)T + G::kTile - 1) / G::kTile);
  if (row != scratch_row<SPS>(T)) return (int)cudaErrorInvalidValue;
  if (C == 0 || T == 0) return 0;
  Taps<SPS> tp;
  for (int k = 0; k < G::kTaps; ++k) tp.h[k] = taps[G::kTaps - 1 - k];
  // 16-byte copies where every row is 16-byte aligned
  const bool vec = T % 4 == 0 && (uintptr_t)re % 16 == 0
                   && (uintptr_t)im % 16 == 0;
  demod_fused_kernel<SPS><<<C, kThreads, 0, stream>>>(
      (const float*)re, (const float*)im, tp, T, n_tile, vec, (int8_t*)bits,
      (long long*)best, (float*)met, scratch);
  return (int)cudaGetLastError();
}

template <int SPS>
int occupancy(int* out) {
  const void* k = (const void*)demod_fused_kernel<SPS>;
  cudaFuncAttributes attr;
  int rc = (int)cudaFuncGetAttributes(&attr, k);
  if (rc) return rc;
  int blocks = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k,
                                                          kThreads, 0);
  if (rc) return rc;
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = kThreads;
  return 0;
}

// F<S>::call(args...) for the run-time rate sps in 1..11; `bad` otherwise
#define TT_SPS_SWITCH(sps, F, bad, ...)   \
  switch (sps) {                          \
    case 1: return F<1>(__VA_ARGS__);     \
    case 2: return F<2>(__VA_ARGS__);     \
    case 3: return F<3>(__VA_ARGS__);     \
    case 4: return F<4>(__VA_ARGS__);     \
    case 5: return F<5>(__VA_ARGS__);     \
    case 6: return F<6>(__VA_ARGS__);     \
    case 7: return F<7>(__VA_ARGS__);     \
    case 8: return F<8>(__VA_ARGS__);     \
    case 9: return F<9>(__VA_ARGS__);     \
    case 10: return F<10>(__VA_ARGS__);   \
    case 11: return F<11>(__VA_ARGS__);   \
    default: return bad;                  \
  }

}  // namespace

// Bytes of one carrier's scratch row at rate sps and T samples; -1 for a
// rate the kernel does not take.
extern "C" long long tt_demod_fused_scratch(int sps, int T) {
  if (T < 0) return -1;
  TT_SPS_SWITCH(sps, scratch_row, -1LL, T)
}

// taps: host array of the K = 11 * sps RRC taps (dqpsk.rrc_taps(sps));
// bits, best, met: outputs; scratch: [C, scratch_row] bytes, where
// scratch_row must be tt_demod_fused_scratch(sps, T).
extern "C" int tt_demod_fused(const void* re, const void* im,
                              const float* taps, int K, int C, int T,
                              int sps, void* bits, void* best, void* met,
                              void* scratch, int scratch_row, void* stream) {
  if (K != 11 * sps || C < 0 || T < 0) return (int)cudaErrorInvalidValue;
  TT_SPS_SWITCH(sps, launch, (int)cudaErrorInvalidValue, re, im, taps, C, T,
                bits, best, met, scratch, scratch_row, (cudaStream_t)stream)
}

// out[0..3]: resident blocks per SM, registers per thread, shared bytes
// per block, threads per block, of the kernel at rate sps.
extern "C" int tt_demod_fused_sps_occupancy(int sps, int* out) {
  TT_SPS_SWITCH(sps, occupancy, (int)cudaErrorInvalidValue, out)
}
