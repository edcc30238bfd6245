// 2x-oversampled WOLA polyphase channelizer (kernel K2 of the port).
//
// Replaces: tetra_tpu/phy/pfb_pallas.py, pfb_channelize_rows_pallas
// (Pallas body _make_kernel): J-tap polyphase window over hop rows,
// analysis DFT across the C branches, (-1)^(c*m) hop rotation.
//
// What bounds it on an H100: each frame reads J*C input samples per
// plane (hop = C/2 new ones; the rest overlap neighbouring frames and
// come from L2) and writes C complex outputs; the DFT is C*log2(C)
// butterflies per frame. At C = 1024 that is ~10 flops per byte moved
// from device memory, far below the card's ~20 flops/byte fp32 ridge,
// so the kernel is bound by device-memory bandwidth and by L2 for the
// window's overlapping reads.
//
// Design: one block per F frames (F*C <= 4096, 32 KB of shared memory).
// Threads first compute the windowed branch vectors with coalesced
// reads along the branch axis and store them in bit-reversed order;
// the analysis DFT then runs in shared memory as an iterative radix-2
// FFT (power-of-two C) with a float32 twiddle table, or, for other even
// C, as a direct in-kernel DFT against the same table. The hop rotation
// is applied while the frames are written out in the time-major [M, C]
// layout, so the branch tensor never exists in device memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxElems = 4096;   // F * C per block

__global__ void __launch_bounds__(kThreads)
pfb_wola_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                const float* __restrict__ h, const float* __restrict__ twc,
                const float* __restrict__ tws, float* __restrict__ yr,
                float* __restrict__ yi, int M, int C, int J, int F,
                int logC) {
  extern __shared__ float2 sm[];
  const int m0 = blockIdx.x * F;
  const int nf = min(F, M - m0);
  const int hop = C / 2;

  for (int idx = threadIdx.x; idx < nf * C; idx += blockDim.x) {
    const int f = idx / C, k = idx - f * C;
    const size_t base = (size_t)(m0 + f) * hop + k;
    float ar = 0.f, ai = 0.f;
    for (int j = 0; j < J; ++j) {
      const float w = __ldg(h + j * C + k);
      ar += __ldg(xr + base + (size_t)j * C) * w;
      ai += __ldg(xi + base + (size_t)j * C) * w;
    }
    const int pos = logC > 0 ? (int)(__brev((unsigned)k) >> (32 - logC)) : k;
    sm[f * C + pos] = make_float2(ar, ai);
  }
  __syncthreads();

  if (logC > 0) {
    // iterative radix-2 DIT FFT, y[c] = sum_k b[k] exp(-2 pi i c k / C)
    const int halfC = C / 2;
    for (int len = 2; len <= C; len <<= 1) {
      const int half = len >> 1;
      const int tstep = C / len;
      for (int idx = threadIdx.x; idx < nf * halfC; idx += blockDim.x) {
        const int f = idx / halfC, i = idx - f * halfC;
        const int g = i / half, j = i - g * half;
        const int a = f * C + g * len + j;
        const int b = a + half;
        const float c = __ldg(twc + j * tstep), s = __ldg(tws + j * tstep);
        const float2 u = sm[a], v = sm[b];
        const float tr = v.x * c + v.y * s, ti = v.y * c - v.x * s;
        sm[a] = make_float2(u.x + tr, u.y + ti);
        sm[b] = make_float2(u.x - tr, u.y - ti);
      }
      __syncthreads();
    }
    for (int idx = threadIdx.x; idx < nf * C; idx += blockDim.x) {
      const int f = idx / C, c = idx - f * C;
      const int m = m0 + f;
      const float sg = ((m & c) & 1) ? -1.f : 1.f;
      const float2 v = sm[idx];
      yr[(size_t)m * C + c] = sg * v.x;
      yi[(size_t)m * C + c] = sg * v.y;
    }
  } else {
    // direct DFT for even C that is not a power of two
    for (int idx = threadIdx.x; idx < nf * C; idx += blockDim.x) {
      const int f = idx / C, c = idx - f * C;
      const int m = m0 + f;
      float ar = 0.f, ai = 0.f;
      int e = 0;
      for (int k = 0; k < C; ++k) {
        const float2 b = sm[f * C + k];
        const float cw = __ldg(twc + e), sw = __ldg(tws + e);
        ar += b.x * cw + b.y * sw;
        ai += b.y * cw - b.x * sw;
        e += c;
        if (e >= C) e -= C;
      }
      const float sg = ((m & c) & 1) ? -1.f : 1.f;
      yr[(size_t)m * C + c] = sg * ar;
      yi[(size_t)m * C + c] = sg * ai;
    }
  }
}

}  // namespace

// xr, xi: [T] float32 planes with T >= (M - 1) * C/2 + J * C;
// h: [J*C] prototype; twc, tws: [C] cos/sin(2 pi e / C);
// yr, yi: [M, C] outputs.
extern "C" int tt_pfb_wola(const void* xr, const void* xi, const void* h,
                           const void* twc, const void* tws, void* yr,
                           void* yi, int M, int C, int J, void* stream) {
  if (C < 2 || (C & 1) || C > kMaxElems || J < 1)
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  int logC = 0;
  if ((C & (C - 1)) == 0) {
    while ((1 << logC) < C) ++logC;
  }
  const int F = kMaxElems / C;
  const int grid = (M + F - 1) / F;
  const size_t smem = (size_t)F * C * sizeof(float2);
  pfb_wola_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)xr, (const float*)xi, (const float*)h,
      (const float*)twc, (const float*)tws, (float*)yr, (float*)yi, M, C, J,
      F, logC);
  return (int)cudaGetLastError();
}
