// Rational polyphase resampler over time-major channel rows (kernel K3 of
// the port), writing either the same time-major layout or the
// channel-major planes the demodulators read.
//
// Replaces: tetra_tpu/phy/pfb_pallas.py, resample_rows_pallas (Pallas
// body _make_resample_kernel, matrix _resample_A): the 50 -> 36 kHz
// (L = 25, M = 18) resampler of every channel, with rows outside the
// input read as zero (pfb_pallas.py:279-286). Output q*M + r of a channel
// is the dot of column r of channelizer._resample_block_plan's W with
// input rows q*L + bmin + w; only the NT live taps of each column are
// used (taps [M, NT], off [M]: pfb._live_taps).
//
// What bounds it on an H100: each output costs 2*NT = 16 flops a plane
// and each input row is needed by about M*NT/L = 5.8 outputs, so at
// ~2 flops a byte the kernel is bound by device memory: every input
// element has to cross it once and every output once. Tensor cores do
// not apply: the intensity is two orders below the bf16 ridge, and TF32
// (the only f32 route into them) keeps ~3 digits, outside the 1e-4
// tolerance the port holds K3 to.
//
// Design:
// - A work item is a tile of kCT = 32 channels x one stage of SQ
//   q-blocks (SQ*M outputs a channel; SQ 4 at L 25, M 18). Its input is
//   the window of R = (SQ-1)*L + width rows starting at q0*L + bmin, for
//   both planes: 32 channels x 106 rows x 2 planes = 27 KB.
// - A block owns a run of kRun = 2 consecutive stages of one channel
//   tile (32 channels x 144 outputs at L 25, M 18; 2,080 blocks at
//   prod-1024's 13,000 rows x 1024). The second stage's window is copied
//   to shared memory (cp.async, 16 bytes a copy where rows are 16-byte
//   aligned and no channel subset is read, else 4; double buffer) while
//   the first is summed; blocks run by the tile fastest, so the 6 halo
//   rows between runs are read by neighbours at about the same time and
//   come from L2: each input element crosses device memory about once.
//   Runs of 2 beat runs of 1, 4 and 8 and a persistent grid in
//   throwaway builds on the H100, channel-major at prod-1024's and
//   wide-512's shapes.
// - Rows outside [0, n_in) and channels past the tile's end are copied
//   with src-size 0, which fills zeros: no padded copy of the input.
// - The taps and row offsets sit in shared memory; a warp computes one
//   output phase for its 32 channels (one channel a lane), so every tap
//   is a broadcast and every window read hits 32 distinct banks.
// - Time-major [n_out, Csel]: a warp stores 32 neighbouring channels of
//   one output (128 bytes). Channel-major [Csel, n_out]: the stage's
//   outputs go through a transposed shared tile [2][32][TP], TP = SQ*M
//   rounded up to odd (73), so the lanes writing one output at 32
//   channels and the lanes reading one channel at 32 outputs both hit
//   distinct banks, and a warp stores a channel's run of outputs along
//   time. The front end reads this layout directly: no transpose after.
// - channel_idx (int32 or int64, channel-major only): the window copies
//   read those columns of the input rows in place (4 bytes a copy); no
//   gathered copy of the rows.
// Registers, shared bytes and blocks per SM: tt_resample_rows_occupancy
// (73,608 B and 3 blocks of 256 per SM channel-major at L 25, M 18, NT
// 8; 54,920 B time-major).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCT = 32;                 // channels of a tile, one a lane
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStageQ = 4;              // q-blocks of a stage, at most
constexpr int kRun = 2;                 // stages of a block
constexpr int kSmemTarget = 76 * 1024;  // 3 blocks per SM at SQ = 4
constexpr int kSmemMax = 227 * 1024;

struct Args {
  const float* xr;
  const float* xi;
  const void* idx;                      // channel_idx [Csel] or null
  int idx64;                            // idx is int64 (else int32)
  int n_in, C, Csel;                    // input rows, row stride, outputs
  const float* taps;                    // [M, NT]
  const int32_t* off;                   // [M], first row of a column
  int NT, L, M, bmin, width;
  int SQ, R, TP;                        // stage shape (shape_of)
  float* yr;
  float* yi;
  int n_out, n_tiles, n_stages;
};

struct Shape {
  int SQ, R, TP;
  int smem;                             // bytes, 0 when nothing fits
};

// stage shape: the most q-blocks (<= kStageQ) whose double window, tile
// and tap table fit kSmemTarget; one q-block if only kSmemMax holds it
Shape shape_of(int L, int M, int NT, int width, bool cm) {
  for (int SQ = kStageQ; SQ >= 1; --SQ) {
    Shape s;
    s.SQ = SQ;
    s.R = (SQ - 1) * L + width;
    s.TP = (SQ * M) | 1;
    const long long floats = 4LL * s.R * kCT + (cm ? 2LL * kCT * s.TP : 0) +
                             (long long)M * NT + M;
    s.smem = (int)(floats * 4);
    if (floats * 4 <= kSmemTarget || (SQ == 1 && floats * 4 <= kSmemMax))
      return s;
  }
  return Shape{0, 0, 0, 0};
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

// the window of `item` into dst ([2 planes][R][kCT]): row j holds input
// row q0*L + bmin + j, zero outside [0, n_in) and past Csel. VEC: 4
// channels a copy (C % 4 == 0, 16-byte aligned rows, no subset), so a
// copy lies wholly inside or outside the tile's live channels.
template <bool VEC>
__device__ __forceinline__ void load_window(const Args& a, float* dst,
                                            int item, int tid) {
  const int c0 = (item % a.n_tiles) * kCT;
  const int g0 = (item / a.n_tiles) * a.SQ * a.L + a.bmin;
  float* di = dst + a.R * kCT;
  if (VEC) {
    const int cq = (tid & 7) * 4;
    const bool cin = c0 + cq < a.Csel;
    for (int j = tid >> 3; j < a.R; j += kThreads / 8) {
      const int g = g0 + j;
      const bool in = cin && g >= 0 && g < a.n_in;
      const size_t s = in ? (size_t)g * a.C + c0 + cq : 0;
      copy<4>(dst + j * kCT + cq, a.xr + s, in);
      copy<4>(di + j * kCT + cq, a.xi + s, in);
    }
  } else {
    const int ch = tid & 31;
    const int cc = c0 + ch;
    const bool cin = cc < a.Csel;
    long long col = cc;
    if (a.idx != nullptr && cin)
      col = a.idx64 ? __ldg((const long long*)a.idx + cc)
                    : (long long)__ldg((const int*)a.idx + cc);
    for (int j = tid >> 5; j < a.R; j += kThreads / 32) {
      const int g = g0 + j;
      const bool in = cin && g >= 0 && g < a.n_in;
      const size_t s = in ? (size_t)g * a.C + col : 0;
      copy<1>(dst + j * kCT + ch, a.xr + s, in);
      copy<1>(di + j * kCT + ch, a.xi + s, in);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <bool VEC, bool CM>
__global__ void __launch_bounds__(kThreads)
resample_kernel(const Args a) {
  extern __shared__ __align__(16) float sm[];
  const int win = a.R * kCT;              // floats of one plane's window
  float* buf = sm;                        // [2 buffers][2 planes][R][kCT]
  float* tile = sm + 4 * win;             // [2 planes][kCT][TP] (CM)
  float* s_taps = tile + (CM ? 2 * kCT * a.TP : 0);
  int* s_off = (int*)(s_taps + a.M * a.NT);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < a.M * a.NT; i += kThreads) s_taps[i] = a.taps[i];
  for (int i = tid; i < a.M; i += kThreads) s_off[i] = a.off[i] - a.bmin;

  const int n_q = a.SQ * a.M;             // outputs of a channel a stage
  const int s0 = (blockIdx.x / a.n_tiles) * kRun;
  const int n_run = min(kRun, a.n_stages - s0);
  int item = s0 * a.n_tiles + blockIdx.x % a.n_tiles;
  load_window<VEC>(a, buf, item, tid);
  for (int k = 0; k < n_run; ++k, item += a.n_tiles) {
    // the next stage's copies run while this one is summed; its buffer
    // was last read before the previous stage's closing barrier
    if (k + 1 < n_run)
      load_window<VEC>(a, buf + ((k + 1) & 1) * 2 * win, item + a.n_tiles,
                       tid);
    else
      asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group 1;\n" ::);
    __syncthreads();

    const int c0 = (item % a.n_tiles) * kCT;
    const int o0 = (item / a.n_tiles) * n_q;
    const float* wr = buf + (k & 1) * 2 * win;
    const float* wi = wr + win;
    const int c = c0 + lane;
    for (int ol = warp; ol < n_q; ol += kWarps) {
      const int q = ol / a.M, r = ol - q * a.M;
      const int base = (q * a.L + s_off[r]) * kCT + lane;
      const float* tp = s_taps + r * a.NT;
      float ar = 0.f, ai = 0.f;
#pragma unroll 8
      for (int t = 0; t < a.NT; ++t) {
        ar = fmaf(tp[t], wr[base + t * kCT], ar);
        ai = fmaf(tp[t], wi[base + t * kCT], ai);
      }
      if (CM) {
        tile[lane * a.TP + ol] = ar;
        tile[(kCT + lane) * a.TP + ol] = ai;
      } else if (o0 + ol < a.n_out && c < a.Csel) {
        const size_t o = (size_t)(o0 + ol) * a.Csel + c;
        a.yr[o] = ar;
        a.yi[o] = ai;
      }
    }
    if (CM) {
      __syncthreads();
      const int n_valid = min(n_q, a.n_out - o0);
      // tile row h: plane h / kCT, channel c0 + h % kCT
      for (int h = warp; h < 2 * kCT; h += kWarps) {
        const int cc = c0 + (h & (kCT - 1));
        if (cc >= a.Csel) continue;
        float* y = (h < kCT ? a.yr : a.yi) + (size_t)cc * a.n_out + o0;
        const float* src = tile + h * a.TP;
        for (int j = lane; j < n_valid; j += 32) y[j] = src[j];
      }
    }
    __syncthreads();
  }
}

using Kernel = void (*)(const Args);

Kernel pick(bool vec, bool cm) {
  return vec ? (cm ? resample_kernel<true, true> : resample_kernel<true, false>)
             : (cm ? resample_kernel<false, true>
                   : resample_kernel<false, false>);
}

// the dynamic shared bytes kernel k may use
int allow_smem(Kernel k, int smem) {
  return (int)cudaFuncSetAttribute(
      (const void*)k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// xr, xi: [n_in, C] float32 rows; idx: null, or [Csel] int32 (idx64 0)
// or int64 (idx64 1) columns of xr/xi in [0, C) (channel-major only);
// Csel: C without idx; taps: [M, NT]; off: [M] first input row of each
// column relative to q*L, every tap row inside [bmin, bmin + width);
// yr, yi: [n_out, Csel] (chan_major 0) or [Csel, n_out] (1).
extern "C" int tt_resample_rows(const void* xr, const void* xi, int n_in,
                                int C, const void* idx, int idx64, int Csel,
                                const void* taps, const void* off, int NT,
                                int L, int M, int bmin, int width,
                                int chan_major, void* yr, void* yi,
                                int n_out, void* stream) {
  if (C <= 0 || NT <= 0 || L <= 0 || M <= 0 || width < NT || n_in < 0 ||
      Csel < 0 || n_out < 0 || (idx != nullptr && !chan_major) ||
      (idx == nullptr && Csel != C))
    return (int)cudaErrorInvalidValue;
  if ((size_t)n_out * Csel == 0) return 0;
  const bool cm = chan_major != 0;
  const Shape s = shape_of(L, M, NT, width, cm);
  if (s.smem == 0) return (int)cudaErrorInvalidValue;
  const bool vec = idx == nullptr && C % 4 == 0 &&
                   (((uintptr_t)xr | (uintptr_t)xi) & 15) == 0;
  const Kernel k = pick(vec, cm);
  const int rc = allow_smem(k, s.smem);
  if (rc) return rc;
  const int n_q = (n_out + M - 1) / M;
  const int n_tiles = (Csel + kCT - 1) / kCT;
  const int n_stages = (n_q + s.SQ - 1) / s.SQ;
  const long long grid = (long long)((n_stages + kRun - 1) / kRun) * n_tiles;
  if (grid > 0x7fffffff) return (int)cudaErrorInvalidValue;
  Args a{(const float*)xr, (const float*)xi, idx, idx64, n_in, C, Csel,
         (const float*)taps, (const int32_t*)off, NT, L, M, bmin, width,
         s.SQ, s.R, s.TP, (float*)yr, (float*)yi, n_out, n_tiles, n_stages};
  k<<<(unsigned)grid, kThreads, s.smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// out[0..3]: resident blocks per SM, registers per thread, shared bytes
// per block, threads per block of the 16-byte-copy instantiation at
// (L, M, NT, width) in the given layout.
extern "C" int tt_resample_rows_occupancy(int L, int M, int NT, int width,
                                          int chan_major, int* out) {
  const bool cm = chan_major != 0;
  const Shape s = shape_of(L, M, NT, width, cm);
  if (s.smem == 0 || NT <= 0 || L <= 0 || M <= 0)
    return (int)cudaErrorInvalidValue;
  const Kernel k = pick(true, cm);
  int rc = allow_smem(k, s.smem);
  if (rc) return rc;
  int blocks = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, (const void*)k, kThreads, s.smem);
  if (rc) return rc;
  cudaFuncAttributes attr;
  rc = (int)cudaFuncGetAttributes(&attr, (const void*)k);
  if (rc) return rc;
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = (int)attr.sharedSizeBytes + s.smem;
  out[3] = kThreads;
  return 0;
}
