// 16-state radix-2 Viterbi over float soft values: kernels K4 (segmented)
// and K6 (unsegmented) of the port.
//
// K4 replaces tetra_tpu/ops/viterbi_pallas.py, decode_segmented_pallas
// (Pallas bodies _make_segmented_kernel16, taken by the soft path with
// f32 input, and _make_segmented_kernel16g, _make_segmented_kernel4,
// _make_segmented_kernel): 16-state Viterbi with per-row trellis restarts
// at up to three boundaries, soft f32 [B, n_sym*N] -> bits [B, n_sym].
// K6 replaces tetra_tpu/ops/viterbi_pallas.py, decode_pallas (Pallas body
// _make_kernel): the same decode with no restarts, for any n_sym (the TPU
// routes even n_sym to K4's radix-4 body only for its matrix unit; here
// K6 keeps its own radix-2 body and takes both parities). Its path is
// the TCH/S voice decode (rate 1/3, n_sym 112 and 72).
//
// What bounds them on an H100: the add-compare-select recursion is serial
// in time (n_sym steps) and rows are independent, so the work is float
// ALU work whose latency chain runs through every step; device memory
// moves 4*N bytes per step per row in and one byte per step out. At
// K4's soft-path shape (21,504 rows x 288 steps x N 4: 99 MB in, 6 MB
// out) the bytes bind: 0.031 ms at 3.35 TB/s, against 0.021 ms of f32
// add, compare and select at one per lane and clock.
//
// K4's first CUDA body ran one thread per row on time-major input: the
// wrapper transposed soft [B, 1152] to [1152, B] (a second 99 MB read
// and write per call, inside the kernel's time) so that a warp's 32 rows
// read 32 consecutive floats; 64 rows and 36 KB of shared decisions per
// block left ~5 warps per SM. It took 0.62-0.71 ms, 20x its bound.
//
// K4's body now (viterbi_group.cuh): a group of 16 lanes per row, one
// per state, 16 rows per block of 256 threads, reading row-major input
// with no transpose.
// - Input: the group loads its row 16 steps at a time, lane j step
//   16c + j. At N = 4 that is one 16-byte load per lane, 256 contiguous
//   bytes per group; the chunk goes to shared memory, and each step's N
//   values come back to all 16 lanes as one broadcast load. The next
//   chunk's loads are in flight while the current one is decoded.
// - Step: two shuffles for the predecessor metrics; each lane forms its
//   two branch metrics in generator order from constant +-1 signs (an
//   fma by +-1 rounds exactly as the add of +-x does), adds them to the
//   predecessor metrics and keeps the larger; the ballot of the 16
//   decisions is the step's decision word, and lane 0 stores four
//   steps' words at once. Where n_sym or a boundary is not a multiple
//   of 4 the body checks for a boundary at every step (Q = 1) instead
//   of every fourth.
// - Metrics start at 0 for state 0 and -1e6 for the others, at t = 0
//   and at every restart, as the JAX scan does. On the soft path the
//   values are integers (|v| <= 124*127, <= 432 nonzero positions per
//   row), so every metric stays below 2^24 and every add is exact:
//   decisions are bit-identical to the plain version. A restart at the
//   boundary reduces (metric, state) to the lowest-index argmax by
//   shuffles; all-erasure rows are pure ties and decode to zeros.
// - The code is an argument: pat[2*p + b] has bit n set where output n
//   of the edge (state p, input b) is 1, for N <= 4 generators.
// - Epilogue: the first warp walks the block's 16 tracebacks, one lane
//   per row, four steps per 16-byte load of decision words, and the
//   block stores its [16, n_sym] bits in 4-byte words.
//
// K6 keeps the one-thread-per-row body (time-major input from its
// wrapper, 32 rows per block, decision words [step][thread] in shared
// memory); its redesign is queued. kMaxSym = 292 covers TCH/4.8.
#include <cuda_runtime.h>
#include <stdint.h>

#include "viterbi_group.cuh"

namespace {

using vg::kMaxSym;
using vg::kRows;
using vg::kThreads;
constexpr int kTpbDec = 32;       // K6 rows per block: 292*32*2 B = 18.7 KB
constexpr int kChunk = 16;        // K4 steps per staged chunk
constexpr float kNeg = -1e6f;

// ---------------------------------------------------------------- K4

// Dynamic shared memory of K4: decisions [kRows/2][dec_stride] uint32,
// the staged chunks [kRows][kChunk*N] f32, the bits [kRows][bits_stride].
__host__ __device__ inline int k4_smem(int N, int n_sym) {
  return 4 * (kRows / 2) * vg::dec_stride(n_sym) + 4 * kRows * kChunk * N +
         kRows * vg::bits_stride(n_sym);
}

template <int N, int Q>
__global__ void __launch_bounds__(kThreads)
viterbi_segmented_kernel(const float* __restrict__ soft, int ld, bool vec,
                         const int32_t* __restrict__ pat,
                         const int8_t* __restrict__ rmask, int nb,
                         int b0, int b1, int b2,
                         int8_t* __restrict__ bits, int B, int n_sym) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int bst_s[kRows][4];  // per row: best state at b0..b2, end
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 4, s = lane & 15;
  const int r = 2 * warp + grp;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - row0);
  const bool valid = r < rows;
  const int ds = vg::dec_stride(n_sym);
  const int bs = vg::bits_stride(n_sym);
  const uint32_t* dec0 = reinterpret_cast<uint32_t*>(smem);
  uint32_t* dec = reinterpret_cast<uint32_t*>(smem) + warp * ds;
  float* chunks = reinterpret_cast<float*>(smem + 4 * (kRows / 2) * ds);
  float* chunk = chunks + r * kChunk * N;
  uint8_t* bits_s = reinterpret_cast<uint8_t*>(chunks + kRows * kChunk * N);
  const int bnd[3] = {b0, b1, b2};

  // the two edges into state s: (s>>1, s&1) and ((s>>1)|8, s&1)
  const int e0 = __ldg(pat + 2 * (s >> 1) + (s & 1));
  const int e1 = __ldg(pat + 2 * ((s >> 1) | 8) + (s & 1));
  float sa[N], sb[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    sa[n] = (e0 >> n) & 1 ? -1.f : 1.f;
    sb[n] = (e1 >> n) & 1 ? -1.f : 1.f;
  }

  // lane s's share of chunk c: step kChunk*c + s (N floats) with 16-byte
  // loads, or floats kChunk*c*N + s + 16j; the same layout either way
  const float* xr = soft + (size_t)(valid ? row0 + r : 0) * ld;
  const int n_val = n_sym * N;
  float v[N];
  auto load = [&](int c) {
    if constexpr (N == 4) {
      if (vec) {
        const int t = kChunk * c + s;
        float4 q = make_float4(0.f, 0.f, 0.f, 0.f);
        if (valid && t < n_sym)
          q = __ldg(reinterpret_cast<const float4*>(xr) + t);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
        return;
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) {
      const int i = kChunk * c * N + s + kChunk * j;
      v[j] = valid && i < n_val ? __ldg(xr + i) : 0.f;
    }
  };
  auto stage = [&]() {
    if constexpr (N == 4) {
      if (vec) {
        reinterpret_cast<float4*>(chunk)[s] = make_float4(v[0], v[1], v[2],
                                                          v[3]);
        return;
      }
    }
#pragma unroll
    for (int j = 0; j < N; ++j) chunk[s + kChunk * j] = v[j];
  };

  const int src0 = (lane & 16) | (s >> 1), src1 = src0 | 8;
  const float init = s == 0 ? 0.f : kNeg;
  float m = init;
  // one step on staged step k of the chunk; returns the ballot word
  auto step = [&](int k) -> unsigned {
    float x[N];
    if constexpr (N == 4) {
      const float4 q = reinterpret_cast<const float4*>(chunk)[k];
      x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
    } else {
#pragma unroll
      for (int n = 0; n < N; ++n) x[n] = chunk[k * N + n];
    }
    float bm0 = sa[0] * x[0], bm1 = sb[0] * x[0];
#pragma unroll
    for (int n = 1; n < N; ++n) {
      bm0 = fmaf(sa[n], x[n], bm0);
      bm1 = fmaf(sb[n], x[n], bm1);
    }
    const float c0 = __shfl_sync(vg::kFull, m, src0) + bm0;
    const float c1 = __shfl_sync(vg::kFull, m, src1) + bm1;
    const bool d = c1 > c0;
    m = d ? c1 : c0;
    return __ballot_sync(vg::kFull, d);
  };
  int bi = 0;
  int lim = nb > 0 ? b0 : n_sym;  // next boundary, or the end
  // at a boundary: the group's best state, then the row's restart
  auto boundary = [&]() {
    const int best = vg::group_argmax_low(m, s);
    if (s == 0) bst_s[r][bi] = best;
    if (valid && rmask[(size_t)(row0 + r) * nb + bi] != 0) m = init;
    ++bi;
    lim = bi < nb ? (bi == 1 ? b1 : b2) : n_sym;
  };
  const int n_ch = (n_sym + kChunk - 1) / kChunk;
  load(0);
  for (int c = 0; c < n_ch; ++c) {
    __syncwarp();
    stage();
    __syncwarp();
    if (c + 1 < n_ch) load(c + 1);
    if constexpr (Q == 4) {
#pragma unroll
      for (int k4 = 0; k4 < kChunk; k4 += 4) {
        const int t4 = kChunk * c + k4;
        if (t4 >= n_sym) break;
        if (t4 == lim) boundary();
        const unsigned w0 = step(k4), w1 = step(k4 + 1);
        const unsigned w2 = step(k4 + 2), w3 = step(k4 + 3);
        if (lane == 0)
          *reinterpret_cast<uint4*>(dec + t4) = make_uint4(w0, w1, w2, w3);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kChunk; ++k) {
        const int t = kChunk * c + k;
        if (t == lim) {
          if (t >= n_sym) break;
          boundary();
        }
        const unsigned w = step(k);
        if (lane == 0) dec[t] = w;
      }
    }
  }
  const int end_state = vg::group_argmax_low(m, s);
  if (s == 0) bst_s[r][nb] = end_state;
  __syncthreads();

  // traceback: one lane per row, on the first warp
  if (tid < rows) {
    bool rst[3];
    int bst[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      rst[i] = i < nb && rmask[(size_t)(row0 + tid) * nb + i] != 0;
      bst[i] = bst_s[tid][i];
    }
    vg::traceback_row<Q>(bst_s[tid][nb], dec0 + (tid >> 1) * ds,
                         16 * (tid & 1), n_sym, nb, bnd, rst, bst,
                         bits_s + tid * bs);
  }
  __syncthreads();
  vg::store_rows(bits + (size_t)row0 * n_sym, bits_s, rows, n_sym);
}

template <int Q>
const void* k4_kernel(int n_out) {
  switch (n_out) {
    case 1: return (const void*)viterbi_segmented_kernel<1, Q>;
    case 2: return (const void*)viterbi_segmented_kernel<2, Q>;
    case 3: return (const void*)viterbi_segmented_kernel<3, Q>;
    case 4: return (const void*)viterbi_segmented_kernel<4, Q>;
    default: return nullptr;
  }
}

template <int Q>
void launch_k4(int n_out, dim3 grid, int bytes, cudaStream_t st,
               const float* x, int ld, bool vec, const int32_t* p,
               const int8_t* r, int nb, int b0, int b1, int b2, int8_t* o,
               int B, int n_sym) {
  switch (n_out) {
    case 1: viterbi_segmented_kernel<1, Q><<<grid, kThreads, bytes, st>>>(x, ld, vec, p, r, nb, b0, b1, b2, o, B, n_sym); break;
    case 2: viterbi_segmented_kernel<2, Q><<<grid, kThreads, bytes, st>>>(x, ld, vec, p, r, nb, b0, b1, b2, o, B, n_sym); break;
    case 3: viterbi_segmented_kernel<3, Q><<<grid, kThreads, bytes, st>>>(x, ld, vec, p, r, nb, b0, b1, b2, o, B, n_sym); break;
    default: viterbi_segmented_kernel<4, Q><<<grid, kThreads, bytes, st>>>(x, ld, vec, p, r, nb, b0, b1, b2, o, B, n_sym); break;
  }
}

// ---------------------------------------------------------------- K6

__device__ __forceinline__ int argmax_low(const float (&m)[16]) {
  int best = 0;
  float bv = m[0];
#pragma unroll
  for (int s = 1; s < 16; ++s) {
    if (m[s] > bv) { bv = m[s]; best = s; }
  }
  return best;
}

// one thread per row, input time-major [n_sym*N, B]
template <int N>
__global__ void __launch_bounds__(kTpbDec)
viterbi_decode_kernel(const float* __restrict__ soft_tm,
                      const int32_t* __restrict__ pat_in,
                      int8_t* __restrict__ bits, int B, int n_sym) {
  __shared__ uint16_t dec[kMaxSym * kTpbDec];
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kTpbDec + tid;
  if (row >= B) return;

  int pat[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) pat[i] = __ldg(pat_in + i);

  float m[16];
#pragma unroll
  for (int s = 0; s < 16; ++s) m[s] = s == 0 ? 0.f : kNeg;

  for (int t = 0; t < n_sym; ++t) {
    float x[N];
#pragma unroll
    for (int n = 0; n < N; ++n)
      x[n] = __ldg(soft_tm + (size_t)(t * N + n) * B + row);
    // branch metric of every edge, summed in generator order
    float bm[32];
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      float acc = (pat[e] & 1) ? -x[0] : x[0];
#pragma unroll
      for (int n = 1; n < N; ++n) acc += ((pat[e] >> n) & 1) ? -x[n] : x[n];
      bm[e] = acc;
    }
    float nm[16];
    unsigned word = 0;
#pragma unroll
    for (int ns = 0; ns < 16; ++ns) {
      const int p0 = ns >> 1, p1 = (ns >> 1) | 8, b = ns & 1;
      const float c0 = m[p0] + bm[2 * p0 + b];
      const float c1 = m[p1] + bm[2 * p1 + b];
      const bool d = c1 > c0;
      nm[ns] = d ? c1 : c0;
      word |= (unsigned)d << ns;
    }
#pragma unroll
    for (int s = 0; s < 16; ++s) m[s] = nm[s];
    dec[t * kTpbDec + tid] = (uint16_t)word;
  }

  int state = argmax_low(m);
  int8_t* out = bits + (size_t)row * n_sym;
  for (int t = n_sym - 1; t >= 0; --t) {
    out[t] = (int8_t)(state & 1);
    const int took = (dec[t * kTpbDec + tid] >> state) & 1;
    state = (state >> 1) | (took << 3);
  }
}

}  // namespace

// K4: up to three restart boundaries; soft is row-major [B, ld] f32.
extern "C" int tt_viterbi_segmented(const void* soft, int ld, const void* pat,
                                    int n_out, const void* rmask, int nb,
                                    int b0, int b1, int b2, void* bits,
                                    int B, int n_sym, void* stream) {
  const bool quads = vg::quads_ok(nb, b0, b1, b2, n_sym);
  const void* kernel = quads ? k4_kernel<4>(n_out) : k4_kernel<1>(n_out);
  if (!kernel || n_sym <= 0 || n_sym > kMaxSym || ld < n_sym * n_out ||
      !vg::boundaries_ok(nb, b0, b1, b2, n_sym))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int bytes = k4_smem(n_out, n_sym);
  int rc = vg::allow_smem(kernel, bytes);
  if (rc) return rc;
  const bool vec = ((uintptr_t)soft & 15) == 0 && (ld & 3) == 0;
  const dim3 grid((B + kRows - 1) / kRows);
  cudaStream_t st = (cudaStream_t)stream;
  auto* launch = quads ? launch_k4<4> : launch_k4<1>;
  launch(n_out, grid, bytes, st, (const float*)soft, ld, vec,
         (const int32_t*)pat, (const int8_t*)rmask, nb, b0, b1, b2,
         (int8_t*)bits, B, n_sym);
  return (int)cudaGetLastError();
}

// out[0..3]: resident blocks per SM, registers per thread, shared bytes
// per block, threads per block, for a K4 launch at (n_out, n_sym) with
// restarts at multiples of 4.
extern "C" int tt_viterbi_segmented_occupancy(int n_out, int n_sym,
                                              int* out) {
  const void* kernel =
      (n_sym & 3) == 0 ? k4_kernel<4>(n_out) : k4_kernel<1>(n_out);
  if (!kernel || n_sym <= 0 || n_sym > kMaxSym)
    return (int)cudaErrorInvalidValue;
  return vg::occupancy(kernel, k4_smem(n_out, n_sym), out);
}

// K6: the unsegmented decode, soft time-major [n_sym*N, B].
extern "C" int tt_viterbi_decode(const void* soft_tm, const void* pat,
                                 int n_out, void* bits, int B, int n_sym,
                                 void* stream) {
  if (n_sym > kMaxSym || n_sym <= 0) return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int grid = (B + kTpbDec - 1) / kTpbDec;
  cudaStream_t s = (cudaStream_t)stream;
  const float* x = (const float*)soft_tm;
  const int32_t* p = (const int32_t*)pat;
  int8_t* o = (int8_t*)bits;
  switch (n_out) {
    case 1: viterbi_decode_kernel<1><<<grid, kTpbDec, 0, s>>>(x, p, o, B, n_sym); break;
    case 2: viterbi_decode_kernel<2><<<grid, kTpbDec, 0, s>>>(x, p, o, B, n_sym); break;
    case 3: viterbi_decode_kernel<3><<<grid, kTpbDec, 0, s>>>(x, p, o, B, n_sym); break;
    case 4: viterbi_decode_kernel<4><<<grid, kTpbDec, 0, s>>>(x, p, o, B, n_sym); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
