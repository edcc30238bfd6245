// Mixer-bank channelizer (kernel M1 of the port): every carrier's
// oscillator mix, 127-tap low-pass FIR and rational polyphase resampler
// to the demod rate in one launch, for both planes.
//
// Replaces no TPU kernel: tetra_tpu/phy/channelizer.py runs this as XLA
// ops, and the port's plain path (phy/channelizer.py: _mix_ri, then
// dqpsk._fir_real as a cuDNN grouped convolution, then
// _resample_ri_one's block matmul) wrote a float64 phase plane and four
// float32 [C, T] planes per call and filtered every input sample, while
// the resampler reads 8 FIR outputs per output (8 of every 50 at
// 1.8 MS/s). M1 computes only the outputs.
//
// Function (channelizer.channelize_ri for a rational fs/36k = L/M):
// output m = q*M + r of carrier c reads FIR outputs o = p + k, k < 8,
// p = q*L + b[r], with the resampler's weights h_r[k] (column r of the
// block plan's W), the FIR output index clamped to the feed's ends (the
// plain path's replicated edges), the FIR's input zero outside [0, T),
// and the mix at absolute index n = base + i:
//   x[i] (re + j im) * exp(-j 2 pi ((f*n) mod fs) / fs).
// The mix commutes with the filters: for s = max(p, 0) - pad (pad =
// ntaps / 2), output m is
//   exp(-j phase(base + s)) * sum_{i < K} G[c][i] * x[s + i],
//   G[c][i] = g[i] * exp(-j phase(i)),  K = ntaps + 7,
// where g is h_r composed with the FIR's taps (the edge outputs, p < 0,
// carry their clamped composition as filters of their own). The host
// builds G in float64 once per (fs, offsets, ntaps) and keeps it on the
// card (channelizer._fused_tables); the float64 oscillator is evaluated
// once per output here, as _mix_ri evaluates it (fmod, the sign of fs,
// the product by 2 pi / fs, cos and sin in float64, cast to float32).
//
// What bounds it on an H100: 4 f32 multiply-adds per tap and output
// (K = 134 complex taps) against 8 bytes of input per sample and 8 of
// output per output: ~670 flops per output byte, so the f32 pipes bound
// it, with one float64 oscillator per output beside them. Tensor cores do
// not apply: TF32 keeps ~3 digits, outside the 1e-5 the port holds M1 to
// (the benchmark's TF32 control reads 2.5e-3).
//
// Design:
// - A block owns 32 carriers (one a lane) x a tile of QB q-blocks x RB
//   phases (channelizer._fused_shape: 64 x 1 at 1.8 MS/s, 8 x 9 at
//   2.048 MS/s). The tile's input window of both planes, zero outside
//   [0, T), goes to shared memory once as float2 (26 KB at 1.8 MS/s) and
//   is shared by all carriers: every window read is a broadcast.
// - A warp sums groups of kRO = 8 outputs of its 32 carriers, ordered
//   phase-major, so a group shares one filter: each tap of G is one
//   coalesced 256-byte read (L1-resident, [NF][K][Cp] with carriers
//   innermost) for 8 outputs, 32 multiply-adds per lane. A group with
//   more than one filter (the edge outputs, ragged tiles) sums output by
//   output in the same order, so an output's value does not depend on
//   its group: a chunked stream equals a whole one bit for bit.
// - The outputs go through a transposed shared tile [2][32][TP], TP odd,
//   and each carrier's run of outputs is stored along time.
// Registers, shared bytes and blocks per SM: tt_mixer_bank_occupancy.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCT = 32;                 // carriers of a block, one a lane
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRO = 8;                  // outputs a lane sums at once
constexpr int kSmemMax = 227 * 1024;

struct Args {
  const float* re;
  const float* im;
  long long T;                          // feed samples
  const float2* G;                      // [NF][K][Cp] composed taps
  const double* f;                      // [Cp] offsets, Hz
  const int32_t* b;                     // [M] first FIR output of phase r
  int K, pad, Cp, C, L, M, E, n_out;
  long long base;                       // absolute index of re[0]
  double fs, w;                         // w = 2 pi / fs, as _mix_ri's
  int QB, RB, SPAN, TP;                 // tile shape (_fused_shape)
  int n_q, n_rt, n_ct;
  float* yr;                            // [C, n_out]
  float* yi;
};

__device__ __forceinline__ void cmac(float2& acc, float2 g, float2 x) {
  acc.x = fmaf(g.x, x.x, acc.x);
  acc.x = fmaf(-g.y, x.y, acc.x);
  acc.y = fmaf(g.x, x.y, acc.y);
  acc.y = fmaf(g.y, x.x, acc.y);
}

// (cos, sin) of 2 pi ((f*n) mod fs) / fs, as _mix_ri computes them:
// torch.remainder is fmod moved to the sign of fs
__device__ __forceinline__ float2 osc(double f, long long n, double fs,
                                      double w) {
  double r = fmod(__dmul_rn(f, (double)n), fs);
  if (r < 0.0) r += fs;
  const double ph = __dmul_rn(r, w);
  return make_float2((float)cos(ph), (float)sin(ph));
}

__global__ void __launch_bounds__(kThreads) mixer_bank_kernel(const Args a) {
  extern __shared__ __align__(16) float2 win[];      // [SPAN]
  float* tile = reinterpret_cast<float*>(win + a.SPAN);  // [2][kCT][TP]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x / a.n_ct;
  const int c0 = (blockIdx.x - t * a.n_ct) * kCT, c = c0 + lane;
  const int qt = t / a.n_rt;
  const int Q0 = qt * a.QB, R0 = (t - qt * a.n_rt) * a.RB;
  const int Qn = min(a.QB, a.n_q - Q0), Rn = min(a.RB, a.M - R0);
  // the first output's window starts first: p rises with q and r
  const long long ws =
      max((long long)Q0 * a.L + __ldg(a.b + R0), 0LL) - a.pad;
  for (int i = tid; i < a.SPAN; i += kThreads) {
    const long long n = ws + i;
    win[i] = (n >= 0 && n < a.T)
                 ? make_float2(__ldg(a.re + n), __ldg(a.im + n))
                 : make_float2(0.f, 0.f);
  }
  __syncthreads();

  const double f = __ldg(a.f + c);
  const size_t fstride = (size_t)a.K * a.Cp;
  const int n_tile = Qn * Rn;
  for (int g = warp; g * kRO < n_tile; g += kWarps) {
    int off[kRO], fi[kRO], u[kRO];      // window offset, filter, tile col
    int f0 = -1;
    bool uniform = true;
#pragma unroll
    for (int j = 0; j < kRO; ++j) {
      const int l = g * kRO + j;
      const int rr = l / Qn, qq = l - rr * Qn;      // phase-major
      const int q = Q0 + qq, r = R0 + rr;
      const long long m = (long long)q * a.M + r;
      off[j] = 0;
      fi[j] = -1;
      u[j] = qq * Rn + rr;
      if (l < n_tile && m < a.n_out) {
        const long long p = (long long)q * a.L + __ldg(a.b + r);
        off[j] = (int)(max(p, 0LL) - a.pad - ws);
        fi[j] = m < a.E ? a.M + (int)m : r;
        if (f0 < 0) f0 = fi[j];
        uniform = uniform && fi[j] == f0;
      }
    }
    if (f0 < 0) continue;
    float2 acc[kRO];
#pragma unroll
    for (int j = 0; j < kRO; ++j) acc[j] = make_float2(0.f, 0.f);
    if (uniform) {
      const float2* gp = a.G + f0 * fstride + c;
#pragma unroll 2
      for (int i = 0; i < a.K; ++i) {
        const float2 gv = __ldg(gp + (size_t)i * a.Cp);
#pragma unroll
        for (int j = 0; j < kRO; ++j) cmac(acc[j], gv, win[off[j] + i]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kRO; ++j) {
        if (fi[j] < 0) continue;
        const float2* gp = a.G + fi[j] * fstride + c;
        for (int i = 0; i < a.K; ++i)
          cmac(acc[j], __ldg(gp + (size_t)i * a.Cp), win[off[j] + i]);
      }
    }
#pragma unroll
    for (int j = 0; j < kRO; ++j) {
      if (fi[j] < 0) continue;
      // (cos - j sin)(acc): the mix at the window's first sample
      const float2 o = osc(f, a.base + ws + off[j], a.fs, a.w);
      tile[lane * a.TP + u[j]] = fmaf(o.x, acc[j].x, o.y * acc[j].y);
      tile[(kCT + lane) * a.TP + u[j]] = fmaf(o.x, acc[j].y,
                                              -o.y * acc[j].x);
    }
  }
  __syncthreads();
  // tile row h: plane h / kCT, carrier c0 + h % kCT; column v: q-major
  for (int h = warp; h < 2 * kCT; h += kWarps) {
    const int cc = c0 + (h & (kCT - 1));
    if (cc >= a.C) continue;
    float* y = (h < kCT ? a.yr : a.yi) + (size_t)cc * a.n_out;
    const float* src = tile + h * a.TP;
    for (int v = lane; v < n_tile; v += 32) {
      const int qq = v / Rn;
      const long long m = (long long)(Q0 + qq) * a.M + R0 + (v - qq * Rn);
      if (m < a.n_out) y[m] = src[v];
    }
  }
}

int smem_of(int SPAN, int TP) {
  return SPAN * (int)sizeof(float2) + 2 * kCT * TP * (int)sizeof(float);
}

}  // namespace

// re, im: [T] float32 planes; G: [M + E][K][Cp] float2; f: [Cp] float64;
// b: [M] int32; the tile shape (QB, RB, SPAN, TP) from
// channelizer._fused_shape; yr, yi: [C, n_out] float32.
extern "C" int tt_mixer_bank(const void* re, const void* im, long long T,
                             const void* G, const void* f, const void* b,
                             int K, int pad, int Cp, int C, int L, int M,
                             int E, int n_out, long long base, double fs,
                             double w, int QB, int RB, int SPAN, int TP,
                             void* yr, void* yi, void* stream) {
  if (T < 0 || K <= 0 || pad < 0 || Cp <= 0 || Cp % kCT || C < 0 ||
      C > Cp || L <= 0 || M <= 0 || E < 0 || n_out < 0 || QB <= 0 ||
      RB <= 0 || RB > M || SPAN < K || TP < QB * RB || !(fs > 0.0))
    return (int)cudaErrorInvalidValue;
  if ((long long)n_out * C == 0) return 0;
  const int smem = smem_of(SPAN, TP);
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  // set on every launch: the attribute is the kernel's, not the call's
  const int rc = (int)cudaFuncSetAttribute(
      (const void*)mixer_bank_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc) return rc;
  const int n_q = (n_out + M - 1) / M;
  const int n_rt = (M + RB - 1) / RB, n_ct = Cp / kCT;
  const long long grid = (long long)((n_q + QB - 1) / QB) * n_rt * n_ct;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  Args a{(const float*)re, (const float*)im, T, (const float2*)G,
         (const double*)f, (const int32_t*)b, K, pad, Cp, C, L, M, E, n_out,
         base, fs, w, QB, RB, SPAN, TP, n_q, n_rt, n_ct, (float*)yr,
         (float*)yi};
  mixer_bank_kernel<<<(unsigned)grid, kThreads, smem, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}

// out[0..3]: resident blocks per SM, registers per thread, shared bytes
// per block, threads per block at the tile shape (SPAN, TP).
extern "C" int tt_mixer_bank_occupancy(int SPAN, int TP, int* out) {
  const int smem = smem_of(SPAN, TP);
  if (SPAN <= 0 || TP <= 0 || smem > kSmemMax)
    return (int)cudaErrorInvalidValue;
  int rc = (int)cudaFuncSetAttribute(
      (const void*)mixer_bank_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc) return rc;
  int blocks = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, (const void*)mixer_bank_kernel, kThreads, smem);
  if (rc) return rc;
  cudaFuncAttributes attr;
  rc = (int)cudaFuncGetAttributes(&attr, (const void*)mixer_bank_kernel);
  if (rc) return rc;
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = (int)attr.sharedSizeBytes + smem;
  out[3] = kThreads;
  return 0;
}
