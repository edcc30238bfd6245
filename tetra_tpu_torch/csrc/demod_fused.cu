// Fused hard-decision pi/4-DQPSK demodulator (kernel K5 of the port), at
// 2 samples per symbol, the rate of every path that runs it.
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
// What bounds it on an H100: each sample is read once (8 bytes) and one
// bit byte written (9 bytes a sample, 0.36 ms at [4096, 32768]; the
// scratch row below adds half a byte out and back); the
// filter costs 2*K = 44 multiply-adds a sample and the metric an IEEE
// division, about half that time at the f32 rate, so device memory is
// the limit as long as the FIR's operands come from registers and not
// from a shared-memory load per tap.
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
// - Register-tiled FIR: each thread owns kR consecutive samples of the
//   tile and computes the filter at kR + sps positions (the extra sps
//   give the lag of its first samples), from a window of kR + sps + K - 1
//   input values read with 16-byte shared loads. The window buffer pads
//   every 16 floats by 4, so the eight threads of a quarter warp, 80
//   bytes apart, hit distinct banks. The taps are a kernel parameter
//   (constant bank) and the tap loop is unrolled: the multiply-adds read
//   window values and taps from registers and the constant bank. Per
//   output the multiply-adds run in tap order k = 0..K-1 on
//   x[t - K/2 + k] * taps[K-1-k].
// - d and the metric use round-to-nearest intrinsics so that no multiply
//   is contracted into an add: the plain version evaluates them as
//   separate elementwise operations.
// - The lag is zero for the stream's first sps samples, as in the XLA
//   demod's zero-padded lag. Metric range: samples t < (T / sps) * sps,
//   the XLA demod's range (the TPU kernel also counts filter-tail lanes
//   past T in its last block).
// - Both phases' decisions of a symbol share one byte (phase p in bits
//   2p, 2p + 1) in a scratch row the wrapper allocates; the block writes
//   it during the tile loop and reads it back (from L2) after the pick.
// - Metric sums in a fixed order, without float atomics: each thread
//   sums its samples of a phase in time order, a warp adds its lanes by
//   an xor-shuffle tree, thread 0 adds the warps in order and the tiles
//   in order. The result is the same on every run, so a near-tie phase
//   pick cannot flip between runs; ties go to the lower phase, as
//   torch.argmax's first maximum.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSps = 2;                      // samples per symbol
constexpr int kTaps = 11 * kSps;             // rrc_taps(2): 22 taps
constexpr int kHalf = kTaps / 2;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kR = 16;                       // samples a thread owns
constexpr int kTile = kThreads * kR;         // samples a tile
constexpr int kTileSym = kTile / kSps;
constexpr int kNf = kR + kSps;               // filter outputs a thread
constexpr int kWin = kNf + kTaps - 1;        // window values a thread
// the tile's buffer starts kBack samples before the tile (16-byte
// aligned when the tile is); a thread's window starts kLead values into
// its first float4
constexpr int kBack = (kSps + kHalf + 3) / 4 * 4;
constexpr int kLead = kBack - kSps - kHalf;
constexpr int kWinLoad = (kLead + kWin + 3) / 4 * 4;  // loaded as float4
constexpr int kGroup = 16;                   // buffer layout: 16 floats
constexpr int kStride = kGroup + 4;          // ... then 4 of padding
constexpr int kBufLogical = (kThreads - 1) * kR + kWinLoad;
constexpr int kBufPhys = (kBufLogical + kGroup - 1) / kGroup * kStride;
static_assert(kR == kGroup, "one padded group per thread");
static_assert(kWinLoad <= 3 * kGroup, "a window spans at most 3 groups");
static_assert(kBufLogical % 4 == 0, "the buffer is whole float4s");
static_assert(kR % 8 == 0, "8 symbols a thread: one 8-byte scratch store");

struct Taps {
  float h[kTaps];                            // h[k] = taps[K - 1 - k]
};

__device__ __forceinline__ int phys(int i) {
  return i + (kStride - kGroup) * (i / kGroup);
}

// FIR at the thread's kNf positions from its window w[kLead ..)
__device__ __forceinline__ void fir(const float* buf, int tid,
                                   const Taps& tp, float (&f)[kNf]) {
  float w[kWinLoad];
#pragma unroll
  for (int q = 0; q < kWinLoad / 4; ++q) {
    const float4 v =
        *reinterpret_cast<const float4*>(buf + phys(tid * kR + 4 * q));
    w[4 * q] = v.x;
    w[4 * q + 1] = v.y;
    w[4 * q + 2] = v.z;
    w[4 * q + 3] = v.w;
  }
#pragma unroll
  for (int u = 0; u < kNf; ++u) {
    float a = 0.f;
#pragma unroll
    for (int k = 0; k < kTaps; ++k) a = fmaf(w[kLead + u + k], tp.h[k], a);
    f[u] = a;
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
template <int N>
__device__ __forceinline__ void stage(float* br, float* bi, const float* xr,
                                      const float* xi, int t0, int T,
                                      int tid) {
  for (int L = N * tid; L < kBufLogical; L += N * kThreads) {
    const int g = t0 - kBack + L;
    const bool in = g >= 0 && g < T;
    copy<N>(br + phys(L), in ? xr + g : xr, in);
    copy<N>(bi + phys(L), in ? xi + g : xi, in);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void stage_tile(bool vec, float* br, float* bi,
                                           const float* xr, const float* xi,
                                           int t0, int T, int tid) {
  if (vec)
    stage<4>(br, bi, xr, xi, t0, T, tid);
  else
    stage<1>(br, bi, xr, xi, t0, T, tid);
}

__global__ void __launch_bounds__(kThreads, 4)
demod_fused_kernel(const float* __restrict__ re, const float* __restrict__ im,
                   const Taps tp, int T, int n_tile, bool vec,
                   int8_t* __restrict__ bits, long long* __restrict__ best,
                   float* __restrict__ met, uint8_t* __restrict__ scratch) {
  __shared__ __align__(16) float b_re[2][kBufPhys];
  __shared__ __align__(16) float b_im[2][kBufPhys];
  __shared__ float red[kWarps][kSps];
  __shared__ int s_best;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t c = blockIdx.x;
  const float* xr = re + c * (size_t)T;
  const float* xi = im + c * (size_t)T;
  const int n_sym = T / kSps;
  const int n_met = n_sym * kSps;
  uint8_t* srow = scratch + c * (size_t)n_tile * kTileSym;
  float tot0 = 0.f, tot1 = 0.f;              // thread 0's running sums

  stage_tile(vec, b_re[0], b_im[0], xr, xi, 0, T, tid);
  for (int j = 0; j < n_tile; ++j) {
    const int t0 = j * kTile;
    // the next tile's copies run while this one is computed; its buffer
    // was last read before the previous tile's second barrier
    if (j + 1 < n_tile)
      stage_tile(vec, b_re[(j + 1) & 1], b_im[(j + 1) & 1], xr, xi,
                 t0 + kTile, T, tid);
    else
      asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();

    float fr[kNf], fi[kNf];
    fir(b_re[j & 1], tid, tp, fr);
    fir(b_im[j & 1], tid, tp, fi);

    const int ts = t0 + tid * kR;            // the thread's first sample
    float acc0 = 0.f, acc1 = 0.f;
    unsigned lo = 0, hi = 0;                 // symbol bytes 0-3, 4-7
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int t = ts + r;
      const float cr = fr[r + kSps], ci = fi[r + kSps];
      const float lr = t >= kSps ? fr[r] : 0.f;
      const float li = t >= kSps ? fi[r] : 0.f;
      const float dr = __fadd_rn(__fmul_rn(cr, lr), __fmul_rn(ci, li));
      const float di = __fsub_rn(__fmul_rn(ci, lr), __fmul_rn(cr, li));
      const unsigned d = (di <= 0.f ? 1u : 0u) | (dr < 0.f ? 2u : 0u);
      const int sh = 8 * ((r / kSps) & 3) + 2 * (r % kSps);
      if (r < kR / 2) lo |= d << sh; else hi |= d << sh;
      if (t < n_met) {
        const float mag2 = __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di));
        const float s = __fdiv_rn(__fmul_rn(2.f, fabsf(__fmul_rn(dr, di))),
                                  __fadd_rn(mag2, 1e-12f));
        if (r % kSps == 0) acc0 += s; else acc1 += s;
      }
    }
    *reinterpret_cast<uint2*>(srow + ts / kSps) = make_uint2(lo, hi);
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
      acc0 += __shfl_xor_sync(0xffffffffu, acc0, off);
      acc1 += __shfl_xor_sync(0xffffffffu, acc1, off);
    }
    if (lane == 0) {
      red[warp][0] = acc0;
      red[warp][1] = acc1;
    }
    __syncthreads();
    if (tid == 0) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        s0 += red[w][0];
        s1 += red[w][1];
      }
      tot0 += s0;
      tot1 += s1;
    }
  }

  if (tid == 0) {
    const int b = tot1 > tot0 ? 1 : 0;       // first maximum
    met[c * kSps] = tot0;
    met[c * kSps + 1] = tot1;
    best[c] = b;
    s_best = b;
  }
  __syncthreads();
  const int sh = 2 * s_best;
  int8_t* out = bits + c * (size_t)(2 * n_sym);
  if ((n_sym & 3) == 0) {
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
      const unsigned d = (srow[s] >> sh) & 3u;
      out[2 * s] = (int8_t)(d & 1u);
      out[2 * s + 1] = (int8_t)(d >> 1);
    }
  }
}

}  // namespace

// taps: host array of the K RRC taps (dqpsk.rrc_taps(2)); bits, best,
// met: outputs; scratch: [C, scratch_row] bytes, where scratch_row must
// be ceil(T / kTile) * kTile / sps.
extern "C" int tt_demod_fused(const void* re, const void* im,
                              const float* taps, int K, int C, int T,
                              int sps, void* bits, void* best, void* met,
                              void* scratch, int scratch_row, void* stream) {
  if (K != kTaps || sps != kSps || C < 0 || T < 0)
    return (int)cudaErrorInvalidValue;
  const int n_tile = (int)(((long long)T + kTile - 1) / kTile);
  if (scratch_row != n_tile * kTileSym) return (int)cudaErrorInvalidValue;
  if (C == 0 || T == 0) return 0;
  Taps tp;
  for (int k = 0; k < kTaps; ++k) tp.h[k] = taps[kTaps - 1 - k];
  // 16-byte copies where every row is 16-byte aligned
  const bool vec = T % 4 == 0 && (uintptr_t)re % 16 == 0
                   && (uintptr_t)im % 16 == 0;
  demod_fused_kernel<<<C, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)re, (const float*)im, tp, T, n_tile, vec, (int8_t*)bits,
      (long long*)best, (float*)met, (uint8_t*)scratch);
  return (int)cudaGetLastError();
}

// out[0..3]: resident blocks per SM, registers per thread, shared bytes
// per block, threads per block.
extern "C" int tt_demod_fused_occupancy(int* out) {
  const void* k = (const void*)demod_fused_kernel;
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
