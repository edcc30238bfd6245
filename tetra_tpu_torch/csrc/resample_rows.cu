// Rational polyphase resampler over time-major rows (kernel K3 of the
// port).
//
// Replaces: tetra_tpu/phy/pfb_pallas.py, resample_rows_pallas (Pallas
// body _make_resample_kernel, matrix _resample_A): the 50 -> 36 kHz
// (L = 25, M = 18) resampler of every channel, with rows outside the
// input read as zero (pfb_pallas.py:279-286).
//
// What bounds it on an H100: each output is a dot of at most ~10 taps
// (one column of channelizer._resample_block_plan's W) with input rows,
// i.e. ~2 flops per 4-byte output and a 1.4x re-read of the input, so
// the kernel is bound by device-memory bandwidth. The TPU kernel's
// banded block-Toeplitz matmul multiplies mostly zeros to feed its
// matrix unit; here only the live taps are read.
//
// Design: one thread per (output row, channel), channels fastest, so a
// warp reads 32 neighbouring channels of one input row (coalesced) and
// writes 32 neighbouring outputs. The per-phase tap vectors and their
// row offsets are tiny and stay in L1 via __ldg.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
resample_rows_kernel(const float* __restrict__ xr,
                     const float* __restrict__ xi, int n_in, int C,
                     const float* __restrict__ taps,
                     const int32_t* __restrict__ off, int NT, int L,
                     int Mph, float* __restrict__ yr,
                     float* __restrict__ yi, int n_out) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (size_t)n_out * C) return;
  const int o = (int)(idx / C);
  const int c = (int)(idx - (size_t)o * C);
  const int q = o / Mph, r = o - q * Mph;
  const int base = q * L + __ldg(off + r);
  float ar = 0.f, ai = 0.f;
  for (int t = 0; t < NT; ++t) {
    const int row = base + t;
    if (row >= 0 && row < n_in) {
      const float w = __ldg(taps + r * NT + t);
      ar += w * __ldg(xr + (size_t)row * C + c);
      ai += w * __ldg(xi + (size_t)row * C + c);
    }
  }
  yr[idx] = ar;
  yi[idx] = ai;
}

}  // namespace

// xr, xi: [n_in, C]; taps: [Mph, NT]; off: [Mph] (input row of tap 0
// for output phase r, relative to q*L); yr, yi: [n_out, C].
extern "C" int tt_resample_rows(const void* xr, const void* xi, int n_in,
                                int C, const void* taps, const void* off,
                                int NT, int L, int Mph, void* yr, void* yi,
                                int n_out, void* stream) {
  if (C <= 0 || NT <= 0 || L <= 0 || Mph <= 0)
    return (int)cudaErrorInvalidValue;
  const size_t total = (size_t)n_out * C;
  if (total == 0) return 0;
  const unsigned grid = (unsigned)((total + kThreads - 1) / kThreads);
  resample_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)xr, (const float*)xi, n_in, C, (const float*)taps,
      (const int32_t*)off, NT, L, Mph, (float*)yr, (float*)yi, n_out);
  return (int)cudaGetLastError();
}
