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
// sends even n_sym to decode_segmented_pallas with no boundaries and
// keeps _make_kernel for odd n_sym; here both parities take K4's body).
// Its path is the TCH/S voice decode (rate 1/3, n_sym 112 and 72).
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
// - Epilogue: the first warp walks the block's tracebacks, one lane per
//   row, four steps per 16-byte load of decision words, and the block
//   stores its [rows, n_sym] bits in 4-byte words.
//
// K6 is the same body with no boundaries (nb = 0, no restart mask), at
// kRowsK6 = 8 rows per block: its voice-path launches hold ~300-2,500
// rows each (one chunk's full frames or NDB halves), where 16-row blocks
// leave most SMs one or two blocks and the step chain's latency exposed;
// 8-row blocks spread the same rows over twice the blocks. Its bound
// (~1 us at these shapes) is below one launch's latency. Its first CUDA
// body ran one thread per row on input its wrapper had transposed to
// time-major (a second read and write of every byte): 3,072 rows of n112
// made 96 warps for 132 SMs and took 0.075 ms, 58x its bound. kMaxSym =
// 292 covers TCH/4.8.
#include <cuda_runtime.h>
#include <stdint.h>

#include "viterbi_group.cuh"

namespace {

using vg::kMaxSym;
constexpr int kRowsK4 = vg::kRows;  // 16 rows, 256 threads
constexpr int kRowsK6 = 8;          // 8 rows, 128 threads
constexpr int kChunk = 16;          // steps per staged chunk
constexpr float kNeg = -1e6f;

// Dynamic shared memory of a block of R rows: decisions [R/2][dec_stride]
// uint32, the staged chunks [R][kChunk*N] f32, the bits [R][bits_stride].
__host__ __device__ inline int smem_bytes(int R, int N, int n_sym) {
  return 4 * (R / 2) * vg::dec_stride(n_sym) + 4 * R * kChunk * N +
         R * vg::bits_stride(n_sym);
}

// R rows per block of R * 16 threads; nb restart boundaries (0 for K6,
// whose rmask is then never read).
template <int N, int Q, int R>
__global__ void __launch_bounds__(R * vg::kGroup)
viterbi_segmented_kernel(const float* __restrict__ soft, int ld, bool vec,
                         const int32_t* __restrict__ pat,
                         const int8_t* __restrict__ rmask, int nb,
                         int b0, int b1, int b2,
                         int8_t* __restrict__ bits, int B, int n_sym) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int bst_s[R][4];  // per row: best state at b0..b2, end
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int grp = lane >> 4, s = lane & 15;
  const int r = 2 * warp + grp;
  const int row0 = blockIdx.x * R;
  const int rows = min(R, B - row0);
  const bool valid = r < rows;
  const int ds = vg::dec_stride(n_sym);
  const int bs = vg::bits_stride(n_sym);
  const uint32_t* dec0 = reinterpret_cast<uint32_t*>(smem);
  uint32_t* dec = reinterpret_cast<uint32_t*>(smem) + warp * ds;
  float* chunks = reinterpret_cast<float*>(smem + 4 * (R / 2) * ds);
  float* chunk = chunks + r * kChunk * N;
  uint8_t* bits_s = reinterpret_cast<uint8_t*>(chunks + R * kChunk * N);
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

template <int Q, int R>
const void* kernel_q(int n_out) {
  switch (n_out) {
    case 1: return (const void*)viterbi_segmented_kernel<1, Q, R>;
    case 2: return (const void*)viterbi_segmented_kernel<2, Q, R>;
    case 3: return (const void*)viterbi_segmented_kernel<3, Q, R>;
    case 4: return (const void*)viterbi_segmented_kernel<4, Q, R>;
    default: return nullptr;
  }
}

template <int R>
const void* kernel_for(int n_out, bool quads) {
  return quads ? kernel_q<4, R>(n_out) : kernel_q<1, R>(n_out);
}

// Checks the arguments, opts into the shared memory, launches R rows per
// block; returns the CUDA error code.
template <int R>
int launch(const void* soft, int ld, const void* pat, int n_out,
           const void* rmask, int nb, int b0, int b1, int b2, void* bits,
           int B, int n_sym, void* stream) {
  const bool quads = vg::quads_ok(nb, b0, b1, b2, n_sym);
  const void* kernel = kernel_for<R>(n_out, quads);
  if (!kernel || n_sym <= 0 || n_sym > kMaxSym || ld < n_sym * n_out ||
      !vg::boundaries_ok(nb, b0, b1, b2, n_sym))
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int bytes = smem_bytes(R, n_out, n_sym);
  int rc = vg::allow_smem(kernel, bytes);
  if (rc) return rc;
  const bool vec = ((uintptr_t)soft & 15) == 0 && (ld & 3) == 0;
  const float* x = (const float*)soft;
  const int32_t* p = (const int32_t*)pat;
  const int8_t* rm = (const int8_t*)rmask;
  int8_t* o = (int8_t*)bits;
  void* args[] = {&x, &ld, (void*)&vec, &p, &rm, &nb, &b0, &b1, &b2, &o, &B,
                  &n_sym};
  return (int)cudaLaunchKernel(kernel, dim3((B + R - 1) / R),
                               dim3(R * vg::kGroup), args, bytes,
                               (cudaStream_t)stream);
}

template <int R>
int occupancy(int n_out, int n_sym, int* out) {
  const void* kernel = kernel_for<R>(n_out, (n_sym & 3) == 0);
  if (!kernel || n_sym <= 0 || n_sym > kMaxSym)
    return (int)cudaErrorInvalidValue;
  return vg::occupancy(kernel, smem_bytes(R, n_out, n_sym), out,
                       R * vg::kGroup);
}

__global__ void empty_kernel() {}

}  // namespace

// K4: up to three restart boundaries; soft is row-major [B, ld] f32.
extern "C" int tt_viterbi_segmented(const void* soft, int ld, const void* pat,
                                    int n_out, const void* rmask, int nb,
                                    int b0, int b1, int b2, void* bits,
                                    int B, int n_sym, void* stream) {
  return launch<kRowsK4>(soft, ld, pat, n_out, rmask, nb, b0, b1, b2, bits,
                         B, n_sym, stream);
}

// out[0..3]: resident blocks per SM, registers per thread, shared bytes
// per block, threads per block, for a K4 launch at (n_out, n_sym) with
// restarts at multiples of 4.
extern "C" int tt_viterbi_segmented_occupancy(int n_out, int n_sym,
                                              int* out) {
  return occupancy<kRowsK4>(n_out, n_sym, out);
}

// K6: the unsegmented decode; soft is row-major [B, ld] f32.
extern "C" int tt_viterbi_decode(const void* soft, int ld, const void* pat,
                                 int n_out, void* bits, int B, int n_sym,
                                 void* stream) {
  return launch<kRowsK6>(soft, ld, pat, n_out, nullptr, 0, -1, -1, -1, bits,
                         B, n_sym, stream);
}

// K6's launch shape at (n_out, n_sym), as tt_viterbi_segmented_occupancy.
extern "C" int tt_viterbi_decode_occupancy(int n_out, int n_sym, int* out) {
  return occupancy<kRowsK6>(n_out, n_sym, out);
}

// An empty kernel on `stream`: the launch floor recorded beside K6, whose
// bound is below one launch's latency.
extern "C" int tt_empty_launch(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
