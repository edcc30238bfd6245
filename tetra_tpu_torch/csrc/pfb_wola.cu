// 2x-oversampled WOLA polyphase channelizer (kernel K2 of the port).
//
// Replaces: tetra_tpu/phy/pfb_pallas.py, pfb_channelize_rows_pallas
// (Pallas body _make_kernel): J-tap polyphase window over hop rows,
// analysis DFT across the C branches, (-1)^(c*m) hop rotation.
//
// What bounds it on an H100: the planes are read once (8 bytes a
// sample) and each frame's C complex outputs written once (8 bytes a
// channel): ~160 MB at C = 1024 and 6.67 M samples, 0.048 ms at
// 3.35 TB/s. The window (2J multiply-adds a branch) and the FFT
// (5 C log2 C flops a frame) are ~1.5 GFLOP, 0.02 ms at the f32 rate,
// so the kernel sits below the ridge point and device memory is the
// limit, as long as the window does not re-read its input from L2 and
// the FFT does not make a pass through shared memory per radix-2 stage.
//
// Design:
// - The stream as hop rows u[r, k] = x[r*C/2 + k] (the TPU kernel's
//   layout): frame m's branch k < C/2 is lo = sum_j u[m+2j, k] * h[j*C+k],
//   branch k + C/2 is hi = sum_j u[m+2j+1, k] * h[j*C+C/2+k].
// - One block per TM consecutive frames. A thread owns a column k of u
//   and keeps the lo and hi sums of all TM frames in registers while it
//   walks the TM + 2J - 1 rows the block needs: each row is read once
//   per block ((TM + 2J - 1) / TM times in all), not once per frame and
//   tap. The J taps of both halves sit in registers (J = 16 at compile
//   time, the prototype's only width).
// - The branch vectors go to shared memory in natural order, padded by
//   one float2 every 32 so that stride-32 accesses hit distinct banks.
// - FFT for power-of-two C: a mixed-radix Stockham FFT whose passes are
//   radix 32 (the last one 2-32), each a DFT of R points held in one
//   thread's registers (radix-2 stages with constant twiddles). At
//   C = 1024 that is two passes (32 x 32): one exchange through shared
//   memory instead of the ten of a radix-2 FFT. Pass p > 0 multiplies by
//   exp(-2 pi i (j mod Ns) r / (Ns R)) from a table laid out [R][Ns]
//   (pfb._fft_plan builds it from the C-point twiddles), so the 32
//   lanes of a warp read 32 neighbouring entries.
// - The last pass writes the hop rotation's sign and the [M, C]
//   time-major rows straight to device memory, lanes on neighbouring
//   channels. Even C that is not a power of two takes a direct DFT
//   against the C-point table (correctness only: no caller uses one).
// - TM = 8 frames for C <= 1024, 4 up to 2048 and 2 up to 4096, so a
//   block stages TM * C <= 8192 complex values (67.6 KB with padding:
//   dynamic shared memory) and each radix-32 pass but the last has at
//   most one item a thread.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kJ = 16;                  // taps a branch
constexpr int kMaxC = 4096;
constexpr int kMaxPass = 4;

struct Plan {
  int n_pass;                           // 0: direct DFT (C not 2^n)
  int radix[kMaxPass];
  int tw_off[kMaxPass];                 // float2 offset of pass p's table
};

__host__ __device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__host__ __device__ constexpr int brev(int i, int bits) {
  int r = 0;
  for (int b = 0; b < bits; ++b) r |= ((i >> b) & 1) << (bits - 1 - b);
  return r;
}

template <int R>
struct Log2 {
  static constexpr int v = 1 + Log2<R / 2>::v;
};
template <>
struct Log2<1> {
  static constexpr int v = 0;
};

// radix-2 stage of span LEN on t (bit-reversed input order), then the
// next; the loop bounds are template constants, so every index below
// is a constant once unrolled and t stays in registers
template <int R, int LEN>
__device__ __forceinline__ void dit_stages(float2 (&t)[R]) {
  // cos, sin (2 pi e / 32), e = 0..15
  const float kc[16] = {
      1.000000000e+00f, 9.807852507e-01f, 9.238795042e-01f,
      8.314695954e-01f, 7.071067691e-01f, 5.555702448e-01f,
      3.826834261e-01f, 1.950903237e-01f, 0.0f, -1.950903237e-01f,
      -3.826834261e-01f, -5.555702448e-01f, -7.071067691e-01f,
      -8.314695954e-01f, -9.238795042e-01f, -9.807852507e-01f};
  const float ks[16] = {
      0.0f, 1.950903237e-01f, 3.826834261e-01f, 5.555702448e-01f,
      7.071067691e-01f, 8.314695954e-01f, 9.238795042e-01f,
      9.807852507e-01f, 1.000000000e+00f, 9.807852507e-01f,
      9.238795042e-01f, 8.314695954e-01f, 7.071067691e-01f,
      5.555702448e-01f, 3.826834261e-01f, 1.950903237e-01f};
#pragma unroll
  for (int g = 0; g < R; g += LEN) {
#pragma unroll
    for (int q = 0; q < LEN / 2; ++q) {
      const int e = q * (32 / LEN);
      const float2 a = t[g + q], b = t[g + q + LEN / 2];
      float2 bw;
      if (e == 0) {
        bw = b;
      } else if (e == 8) {
        bw = make_float2(b.y, -b.x);
      } else {
        bw = make_float2(fmaf(b.x, kc[e], b.y * ks[e]),
                         fmaf(b.y, kc[e], -(b.x * ks[e])));
      }
      t[g + q] = make_float2(a.x + bw.x, a.y + bw.y);
      t[g + q + LEN / 2] = make_float2(a.x - bw.x, a.y - bw.y);
    }
  }
  if constexpr (LEN < R) dit_stages<R, 2 * LEN>(t);
}

// v[q] <- sum_r v[r] exp(-2 pi i r q / R), in registers: radix-2
// decimation in time on the bit-reversed input, twiddles constant
template <int R>
__device__ __forceinline__ void dft_reg(float2 (&v)[R]) {
  if constexpr (R > 1) {
    float2 t[R];
#pragma unroll
    for (int i = 0; i < R; ++i) t[brev(i, Log2<R>::v)] = v[i];
    dit_stages<R, 2>(t);
#pragma unroll
    for (int i = 0; i < R; ++i) v[i] = t[i];
  }
}

// one Stockham pass over the block's frames: item (f, j) reads points
// j + r*C/R of frame f, twiddles them (p > 0), transforms them and
// writes them to (j / Ns)*Ns*R + j % Ns + r*Ns: back to shared memory
// in place (every item of a pass but the last is one thread's, so all
// reads precede all writes), or for the last pass to the outputs with
// the hop rotation's sign
template <int R>
__device__ __forceinline__ void fft_pass(float2* sm, int Cp, int C, int nf,
                                         int Ns, const float2* tw, bool last,
                                         int m0, float* yr, float* yi) {
  const int per = C / R;
  const int n_items = nf * per;
  float2 v[R];
  for (int idx = threadIdx.x; idx < (last ? n_items : kThreads);
       idx += kThreads) {
    const bool act = idx < n_items;
    const int f = idx / per, j = idx - f * per;
    const float2* fr = sm + f * Cp;
    if (act) {
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = fr[pad(j + r * per)];
      if (Ns > 1) {
        const int i = j & (Ns - 1);
#pragma unroll
        for (int r = 1; r < R; ++r) {
          const float2 w = __ldg(tw + r * Ns + i);
          v[r] = make_float2(fmaf(v[r].x, w.x, v[r].y * w.y),
                             fmaf(v[r].y, w.x, -(v[r].x * w.y)));
        }
      }
      dft_reg<R>(v);
    }
    const int d = (j / Ns) * Ns * R + (j & (Ns - 1));
    if (last) {
      const int m = m0 + f;
      float* orow = yr + (size_t)m * C;
      float* irow = yi + (size_t)m * C;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int c = d + r * Ns;
        const float sg = ((m & c) & 1) ? -1.f : 1.f;
        orow[c] = sg * v[r].x;
        irow[c] = sg * v[r].y;
      }
    } else {
      __syncthreads();
      if (act) {
        float2* fw = sm + f * Cp;
#pragma unroll
        for (int r = 0; r < R; ++r) fw[pad(d + r * Ns)] = v[r];
      }
      __syncthreads();
    }
  }
}

template <int TM>
__global__ void __launch_bounds__(kThreads, 2)
pfb_wola_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                const float* __restrict__ h, const float2* __restrict__ tw,
                const float* __restrict__ twc, const float* __restrict__ tws,
                float* __restrict__ yr, float* __restrict__ yi, int M, int C,
                const Plan plan) {
  extern __shared__ float2 sm[];
  const int hop = C / 2;
  const int Cp = pad(C);
  const int m0 = blockIdx.x * TM;
  const int nf = min(TM, M - m0);
  const int n_rows = M + 2 * kJ - 1;    // hop rows the frames read

  // window: thread column k of u, all TM frames in registers
  for (int k = threadIdx.x; k < hop; k += kThreads) {
    float hl[kJ], hh[kJ];
#pragma unroll
    for (int j = 0; j < kJ; ++j) {
      hl[j] = __ldg(h + j * C + k);
      hh[j] = __ldg(h + j * C + hop + k);
    }
    float lr[TM], li[TM], ur[TM], ui[TM];
#pragma unroll
    for (int f = 0; f < TM; ++f) lr[f] = li[f] = ur[f] = ui[f] = 0.f;
#pragma unroll
    for (int r = 0; r < TM + 2 * kJ - 1; ++r) {
      float a = 0.f, b = 0.f;
      if (m0 + r < n_rows) {
        const size_t o = (size_t)(m0 + r) * hop + k;
        a = __ldg(xr + o);
        b = __ldg(xi + o);
      }
#pragma unroll
      for (int f = 0; f < TM; ++f) {
        const int d = r - f;             // 2j (lo) or 2j + 1 (hi)
        if (d >= 0 && d < 2 * kJ) {
          if ((d & 1) == 0) {
            lr[f] = fmaf(a, hl[d / 2], lr[f]);
            li[f] = fmaf(b, hl[d / 2], li[f]);
          } else {
            ur[f] = fmaf(a, hh[d / 2], ur[f]);
            ui[f] = fmaf(b, hh[d / 2], ui[f]);
          }
        }
      }
    }
#pragma unroll
    for (int f = 0; f < TM; ++f) {
      if (f < nf) {
        sm[f * Cp + pad(k)] = make_float2(lr[f], li[f]);
        sm[f * Cp + pad(k + hop)] = make_float2(ur[f], ui[f]);
      }
    }
  }
  __syncthreads();

  if (plan.n_pass == 0) {
    // direct DFT for even C that is not a power of two
    for (int idx = threadIdx.x; idx < nf * C; idx += kThreads) {
      const int f = idx / C, c = idx - f * C;
      const int m = m0 + f;
      float ar = 0.f, ai = 0.f;
      int e = 0;
      for (int k = 0; k < C; ++k) {
        const float2 b = sm[f * Cp + pad(k)];
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
    return;
  }
  int Ns = 1;
  for (int p = 0; p < plan.n_pass; ++p) {
    const int R = plan.radix[p];
    const bool last = p == plan.n_pass - 1;
    const float2* twp = tw + plan.tw_off[p];
    switch (R) {
      case 32: fft_pass<32>(sm, Cp, C, nf, Ns, twp, last, m0, yr, yi); break;
      case 16: fft_pass<16>(sm, Cp, C, nf, Ns, twp, last, m0, yr, yi); break;
      case 8: fft_pass<8>(sm, Cp, C, nf, Ns, twp, last, m0, yr, yi); break;
      case 4: fft_pass<4>(sm, Cp, C, nf, Ns, twp, last, m0, yr, yi); break;
      default: fft_pass<2>(sm, Cp, C, nf, Ns, twp, last, m0, yr, yi); break;
    }
    Ns *= R;
  }
}

// the FFT's passes for C: radix 32 while 32 divides what is left, then
// the rest (2..16); tables of passes p > 0 laid out [R][Ns], one after
// another (pfb._fft_plan builds the same). n_pass 0 for C not 2^n.
Plan make_plan(int C) {
  Plan p{};
  if (C & (C - 1)) return p;
  int n = C, Ns = 1, off = 0;
  while (n > 1) {
    const int R = n % 32 == 0 ? 32 : n;
    p.radix[p.n_pass] = R;
    p.tw_off[p.n_pass] = off;
    if (p.n_pass > 0) off += R * Ns;
    ++p.n_pass;
    Ns *= R;
    n /= R;
  }
  return p;
}

int frames_per_block(int C) { return C <= 1024 ? 8 : C <= 2048 ? 4 : 2; }

template <int TM>
int launch(const float* xr, const float* xi, const float* h,
           const float2* tw, const float* twc, const float* tws, float* yr,
           float* yi, int M, int C, const Plan& plan, cudaStream_t stream) {
  const size_t smem = (size_t)TM * pad(C) * sizeof(float2);
  int rc = (int)cudaFuncSetAttribute(pfb_wola_kernel<TM>,
                                     cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
  if (rc) return rc;
  const int grid = (M + TM - 1) / TM;
  pfb_wola_kernel<TM><<<grid, kThreads, smem, stream>>>(
      xr, xi, h, tw, twc, tws, yr, yi, M, C, plan);
  return (int)cudaGetLastError();
}

}  // namespace

// xr, xi: [T] float32 planes with T >= (M - 1) * C/2 + J * C;
// h: [J*C] prototype; tw: the FFT's pass tables (pfb._fft_plan, float2;
// unused when C is not a power of two); twc, tws: [C] cos/sin(2 pi e/C);
// yr, yi: [M, C] outputs. J must be 16; C even, 2..4096.
extern "C" int tt_pfb_wola(const void* xr, const void* xi, const void* h,
                           const void* tw, const void* twc, const void* tws,
                           void* yr, void* yi, int M, int C, int J,
                           void* stream) {
  if (C < 2 || (C & 1) || C > kMaxC || J != kJ)
    return (int)cudaErrorInvalidValue;
  if (M <= 0) return 0;
  const Plan plan = make_plan(C);
  const auto* a = (const float*)xr;
  const auto* b = (const float*)xi;
  const auto* hh = (const float*)h;
  const auto* t = (const float2*)tw;
  const auto* c = (const float*)twc;
  const auto* s = (const float*)tws;
  auto* o = (float*)yr;
  auto* q = (float*)yi;
  const auto st = (cudaStream_t)stream;
  switch (frames_per_block(C)) {
    case 8: return launch<8>(a, b, hh, t, c, s, o, q, M, C, plan, st);
    case 4: return launch<4>(a, b, hh, t, c, s, o, q, M, C, plan, st);
    default: return launch<2>(a, b, hh, t, c, s, o, q, M, C, plan, st);
  }
}

// out[0..3]: resident blocks per SM, registers per thread, shared bytes
// per block (static + the dynamic stage), threads per block, for the
// instantiation that C takes.
extern "C" int tt_pfb_wola_occupancy(int C, int* out) {
  if (C < 2 || (C & 1) || C > kMaxC) return (int)cudaErrorInvalidValue;
  const int tm = frames_per_block(C);
  const void* k = tm == 8   ? (const void*)pfb_wola_kernel<8>
                  : tm == 4 ? (const void*)pfb_wola_kernel<4>
                            : (const void*)pfb_wola_kernel<2>;
  const size_t smem = (size_t)tm * pad(C) * sizeof(float2);
  int rc = (int)cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc) return rc;
  cudaFuncAttributes attr;
  rc = (int)cudaFuncGetAttributes(&attr, k);
  if (rc) return rc;
  int blocks = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k,
                                                          kThreads, smem);
  if (rc) return rc;
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = (int)(attr.sharedSizeBytes + smem);
  out[3] = kThreads;
  return 0;
}
