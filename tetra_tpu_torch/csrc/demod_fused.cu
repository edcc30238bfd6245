// Fused hard-decision pi/4-DQPSK demodulator (kernel K5 of the port), at
// 2 samples per symbol, the rate of every path that runs it.
//
// Replaces: tetra_tpu/phy/demod_pallas.py, _demod_sel (Pallas body
// _make_kernel): RRC matched filter, differential phasor over sps
// samples, packed sign decisions b0 | b1 << 1 with b0 = (Im d <= 0),
// b1 = (Re d < 0), and the per-phase |sin 2θ| timing metric, on planar
// baseband re, im f32 [C, T] -> pk int8 [C, T] and partial metric sums
// part f32 [C, n_blk, sps]. The argmax over phases and the gather of the
// chosen phase stay outside the kernel, as on the TPU.
//
// What bounds it on an H100: each sample is read once (8 bytes) and one
// decision byte written; the filter costs 2*K multiply-adds per sample
// (K = 22 at sps 2), so the kernel sits below the card's ridge point and
// device-memory traffic is the limit. The TPU kernel runs the FIR as
// banded [149, 128] matmuls because its matrix unit wants them; here a
// direct K-tap FIR from shared memory does the same work without the
// band's zero multiplies.
//
// Design:
// - One CTA per (carrier, block of tb samples), grid flattened with time
//   fastest, so a CTA's loads and stores are contiguous runs.
// - Shared memory holds the block's window of tb + sps + K - 1 samples
//   of each plane, zero outside [0, T) (the TPU kernel's `valid` mask),
//   then the FIR outputs for samples [t0 - sps, t0 + tb): the lag of the
//   block's first sps samples comes from the same window.
// - The lag is zero for the stream's first sps samples, as in the XLA
//   demod's zero-padded lag.
// - d and the metric use round-to-nearest intrinsics so that no multiply
//   is contracted into an add: the plain version evaluates them as
//   separate elementwise operations.
// - Metric range: samples t < (T / sps) * sps, the XLA demod's range.
//   The TPU kernel sums every lane of its last time block, which can
//   include up to K - 1 - K/2 filter-tail outputs past T.
// - Metric reduction without float atomics: each thread only ever sees
//   one phase (tid % kSps, since tb and the thread count are multiples
//   of kSps), warp shuffles sum lanes of one phase, and thread p sums the
//   warps in a fixed order into part[c, j, p]. The result is the same on
//   every run, so a near-tie phase pick cannot flip between runs.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTb = 1024;
constexpr int kSps = 2;                     // samples per symbol
constexpr int kMaxTaps = 11 * kSps;
constexpr int kMaxWin = kMaxTb + kSps + kMaxTaps - 1;

__global__ void __launch_bounds__(kThreads)
demod_fused_kernel(const float* __restrict__ re, const float* __restrict__ im,
                   const float* __restrict__ taps, int K, int T, int tb,
                   int n_blk, int8_t* __restrict__ pk,
                   float* __restrict__ part) {
  __shared__ float w_re[kMaxWin];
  __shared__ float w_im[kMaxWin];
  __shared__ float f_re[kMaxTb + kSps];
  __shared__ float f_im[kMaxTb + kSps];
  __shared__ float k_rev[kMaxTaps];
  __shared__ float red[kWarps][kSps];

  const int tid = threadIdx.x;
  const int j = blockIdx.x % n_blk;
  const size_t c = blockIdx.x / n_blk;
  const float* xr = re + c * (size_t)T;
  const float* xi = im + c * (size_t)T;
  const int t0 = j * tb;                    // first sample of the block
  const int g0 = t0 - kSps - K / 2;         // sample index of window[0]
  const int n_win = tb + kSps + K - 1;
  const int n_fir = tb + kSps;

  for (int k = tid; k < K; k += kThreads) k_rev[k] = taps[K - 1 - k];
  for (int i = tid; i < n_win; i += kThreads) {
    const int g = g0 + i;
    const bool in = g >= 0 && g < T;
    w_re[i] = in ? __ldg(xr + g) : 0.f;
    w_im[i] = in ? __ldg(xi + g) : 0.f;
  }
  __syncthreads();
  // f[u] = FIR output at sample t0 - kSps + u:
  // sum_k x[t - K/2 + k] * taps[K - 1 - k]
  for (int u = tid; u < n_fir; u += kThreads) {
    float ar = 0.f, ai = 0.f;
    for (int k = 0; k < K; ++k) {
      const float h = k_rev[k];
      ar = fmaf(w_re[u + k], h, ar);
      ai = fmaf(w_im[u + k], h, ai);
    }
    f_re[u] = ar;
    f_im[u] = ai;
  }
  __syncthreads();

  const int n_met = (T / kSps) * kSps;
  float acc = 0.f;                          // phase tid % kSps only
  int8_t* out = pk + c * (size_t)T;
  for (int i = tid; i < tb; i += kThreads) {
    const int t = t0 + i;
    if (t >= T) break;
    const float cr = f_re[i + kSps], ci = f_im[i + kSps];
    const float lr = t >= kSps ? f_re[i] : 0.f;
    const float li = t >= kSps ? f_im[i] : 0.f;
    const float dr = __fadd_rn(__fmul_rn(cr, lr), __fmul_rn(ci, li));
    const float di = __fsub_rn(__fmul_rn(ci, lr), __fmul_rn(cr, li));
    out[t] = (int8_t)((di <= 0.f ? 1 : 0) | (dr < 0.f ? 2 : 0));
    if (t < n_met) {
      const float mag2 = __fadd_rn(__fmul_rn(dr, dr), __fmul_rn(di, di));
      const float s = __fdiv_rn(__fmul_rn(2.f, fabsf(__fmul_rn(dr, di))),
                                __fadd_rn(mag2, 1e-12f));
      acc += s;
    }
  }
  // lanes of one phase differ by multiples of kSps
#pragma unroll
  for (int off = 16; off >= kSps; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  const int lane = tid & 31, warp = tid >> 5;
  if (lane < kSps) red[warp][lane] = acc;
  __syncthreads();
  if (tid < kSps) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) s += red[w][tid];
    part[(c * n_blk + j) * kSps + tid] = s;
  }
}

}  // namespace

extern "C" int tt_demod_fused(const void* re, const void* im,
                              const void* taps, int K, int C, int T,
                              int sps, int tb, void* pk, void* part,
                              void* stream) {
  if (C <= 0 || T <= 0) return 0;
  if (K <= 0 || K > kMaxTaps || sps != kSps
      || tb <= 0 || tb > kMaxTb || tb % kThreads != 0)
    return (int)cudaErrorInvalidValue;
  const long long n_blk = (T + tb - 1) / tb;
  if ((long long)C * n_blk >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)C * (unsigned)n_blk;
  demod_fused_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)re, (const float*)im, (const float*)taps, K, T, tb,
      (int)n_blk, (int8_t*)pk, (float*)part);
  return (int)cudaGetLastError();
}
