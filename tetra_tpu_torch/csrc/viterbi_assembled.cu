// Assembled segmented Viterbi + CRC16 (kernel K1 of the port).
//
// Replaces: tetra_tpu/ops/viterbi_pallas.py, decode_assembled_pallas
// (Pallas body _make_fused_kernel16): FEC assembly prologue, 16-state
// segmented Viterbi with per-slot trellis restarts, CRC16 epilogue.
//
// What bounds it on an H100: the add-compare-select recursion is serial
// in time (288, 144 or 80 steps) and the slots are independent, so the
// work is integer ALU work whose latency chain runs through every step;
// device memory moves only ~0.5 KB of input signs, n_sym output bits and
// a few flags per slot. Counted as chip_smoke.py counts it (16 ACS of 4
// int32 ops and 16 branch metrics per step) the bound is 0.039 ms at
// 20,000 slots x 288 steps and 0.51 ms at 262,144. There is no matrix
// product worth a tensor core: the TPU kernel spreads the descrambled
// signs into mother order with a one-hot s8 matmul only because its MXU
// is the fastest unit it has.
//
// The first CUDA body ran one thread per slot, 64 slots and 36 KB of
// shared decisions per block: 313 blocks at 20,000 slots (~5 warps per
// SM), and at 262,144 slots the shared memory held each SM to 12 warps.
// Each step gathered 4 pidx entries and then 4 bytes of x from device
// memory, every thread in its own row (uncoalesced, two dependent
// latencies), and the traceback stored one byte at a time at stride
// n_sym. It took 0.50 ms at 20,000 slots (13x the bound) and 3.49 ms at
// 262,144 (6.8x), latency-bound at ~3,000 cycles a step.
//
// This body (viterbi_group.cuh) gives each slot a group of 16 lanes,
// one per state: 16 slots per block of 256 threads, so 20,000 slots
// are 10,000 warps and occupancy is set by registers and shared memory.
// - Prologue: the block copies its slots' rows of x and the whole pidx
//   table into shared memory with 16-byte loads, then gathers each
//   step's four mother-order signs into one packed int8x4 word per slot
//   and step (sv, shared memory). The tables are then dead and their
//   space holds the decision words.
// - Step: the step's word (one 16-byte shared load serves four steps,
//   the same address for the 16 lanes), two shuffles for the
//   predecessor metrics, and each candidate as one __dp4a: the word
//   dotted with the lane's constant +-1 signs of that edge, plus the
//   predecessor metric. int32 metrics keep every tie exact; the ballot
//   of the 16 decisions is the step's decision word, and lane 0 stores
//   four steps' words at once. Nine instructions a step, no branch.
// - Restarts cut the step loop into segments at b0 < b1 < b2; at each
//   the group reduces (metric, state) to the lowest-index argmax by
//   shuffles and, where the slot restarts, resets its metrics. Where
//   n_sym or a boundary is not a multiple of 4 the body steps one at a
//   time (template Q = 1); the decode is the same.
// - Epilogue: the first warp walks the block's 16 tracebacks, one lane
//   per slot, four steps per 16-byte load of decision words (padded so
//   the lanes hit distinct banks), writing the bits to shared memory.
//   The CRC16 of each segment is order-free (XOR of the crc16_matrix
//   rows of the set bits): lane j of the group takes steps j, j+16, ...
//   reading crcw through __ldg (3.5 KB, cached), and a shuffle
//   reduction ends it. The block then stores its bits [16, n_sym] in
//   4-byte words.
#include <cuda_runtime.h>
#include <stdint.h>

#include "viterbi_group.cuh"

namespace {

using vg::kRows;
using vg::kThreads;
constexpr int kMaxSeg = 8;
constexpr int kNeg = -(1 << 27);

// CCH mother code generators as state-bit masks: taps d -> bit d-1
// (tetra_tpu.constants.CONV_GENERATORS_CCH = (1,4) (2,3,4) (1,2,4) (1,3,4))
__host__ __device__ constexpr int gen_mask(int n) {
  return n == 0 ? 0x9 : n == 1 ? 0xE : n == 2 ? 0xB : 0xD;
}

__host__ __device__ constexpr int parity4(int v) {
  return (v ^ (v >> 1) ^ (v >> 2) ^ (v >> 3)) & 1;
}

// int8x4 signs of the edge (state p, input bit b): byte n is -1 where
// generator n emits a 1 on that edge, else +1
__device__ __forceinline__ int edge_signs(int p, int b) {
  unsigned w = 0;
#pragma unroll
  for (int n = 0; n < 4; ++n)
    w |= ((parity4(p & gen_mask(n)) ^ b) ? 0xFFu : 0x01u) << (8 * n);
  return (int)w;
}

__host__ __device__ constexpr int round16(int v) { return (v + 15) & ~15; }

// Dynamic shared memory: sv [kRows][ns4] int32 (rows padded to whole
// quads of steps; after the forward pass the bits [kRows][bits_stride]
// reuse it), then the staging area (pidx table, then the block's rows of
// x, each offset by its source's misalignment), which the decisions
// [kRows/2][dec_stride] uint32 reuse.
struct Layout {
  int ns4, sv, pidx, x, total;
  __host__ __device__ Layout(int K, int n_tab, int n_sym) {
    ns4 = (n_sym + 3) & ~3;
    sv = 4 * kRows * ns4;
    const int bits = kRows * vg::bits_stride(n_sym);
    if (bits > sv) sv = bits;
    pidx = round16(8 * n_tab * n_sym + 16);
    x = round16(kRows * K + 16);
    const int dec = 4 * (kRows / 2) * vg::dec_stride(n_sym);
    total = sv + (pidx + x > dec ? pidx + x : dec);
  }
};

template <int Q>
__global__ void __launch_bounds__(kThreads)
viterbi_assembled_kernel(const int8_t* __restrict__ x, int K,
                         const int16_t* __restrict__ pidx, int n_tab,
                         const int32_t* __restrict__ tab,
                         const int8_t* __restrict__ rmask, int nb,
                         int b0, int b1, int b2,
                         const int32_t* __restrict__ crcw,
                         const int32_t* __restrict__ crct, int n_seg,
                         int8_t* __restrict__ bits, int8_t* __restrict__ ok,
                         int B, int n_sym) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int tab_s[kRows];
  __shared__ int bst_s[kRows][4];  // per row: best state at b0..b2, end
  const Layout L(K, n_tab, n_sym);
  int32_t* sv = reinterpret_cast<int32_t*>(smem);
  uint8_t* stage = smem + L.sv;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int row0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - row0);
  const int ds = vg::dec_stride(n_sym);
  const int bs = vg::bits_stride(n_sym);
  const int bnd[3] = {b0, b1, b2};

  // prologue: stage pidx and the block's rows of x, then gather
  const uint8_t* pg = reinterpret_cast<const uint8_t*>(pidx);
  const uint8_t* xg = reinterpret_cast<const uint8_t*>(x) + (size_t)row0 * K;
  uint8_t* p_s = stage + ((uintptr_t)pg & 15);
  uint8_t* x_s = stage + L.pidx + ((uintptr_t)xg & 15);
  if (tid < rows) tab_s[tid] = tab[row0 + tid];
  vg::stage_bytes(p_s, pg, 8 * n_tab * n_sym);
  vg::stage_bytes(x_s, xg, rows * K);
  __syncthreads();
  const int16_t* ps = reinterpret_cast<const int16_t*>(p_s);
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int r = 2 * warp + g;
    for (int t = lane; t < L.ns4; t += 32) {
      unsigned w = 0;
      if (r < rows && t < n_sym) {
        const int16_t* pr = ps + (size_t)tab_s[r] * 4 * n_sym + 4 * t;
        const uint8_t* xr = x_s + r * K;
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          const int src = pr[n];
          w |= (src >= 0 ? (unsigned)xr[src] : 0u) << (8 * n);
        }
      }
      sv[r * L.ns4 + t] = (int32_t)w;
    }
  }
  __syncthreads();

  // forward: lane s of the group is new state s
  {
    uint32_t* dec = reinterpret_cast<uint32_t*>(stage) + warp * ds;
    const int grp = lane >> 4, s = lane & 15;
    const int r = 2 * warp + grp;
    const bool valid = r < rows;
    const int32_t* svr = sv + r * L.ns4;
    const int src0 = (lane & 16) | (s >> 1), src1 = src0 | 8;
    const int sg0 = edge_signs(s >> 1, s & 1);
    const int sg1 = edge_signs((s >> 1) | 8, s & 1);
    const int init = s == 0 ? 0 : kNeg;
    int m = init;
    auto step = [&](int w) -> unsigned {
      const int c0 = __dp4a(w, sg0, __shfl_sync(vg::kFull, m, src0));
      const int c1 = __dp4a(w, sg1, __shfl_sync(vg::kFull, m, src1));
      const bool d = c1 > c0;
      m = d ? c1 : c0;
      return __ballot_sync(vg::kFull, d);
    };
    int start = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i > nb) break;
      const int end = i < nb ? bnd[i] : n_sym;
      if constexpr (Q == 4) {
        for (int t4 = start; t4 < end; t4 += 4) {
          const int4 q = *reinterpret_cast<const int4*>(svr + t4);
          const unsigned w0 = step(q.x), w1 = step(q.y);
          const unsigned w2 = step(q.z), w3 = step(q.w);
          if (lane == 0)
            *reinterpret_cast<uint4*>(dec + t4) = make_uint4(w0, w1, w2, w3);
        }
      } else {
#pragma unroll 4
        for (int t = start; t < end; ++t) {
          const unsigned w = step(svr[t]);
          if (lane == 0) dec[t] = w;
        }
      }
      const int best = vg::group_argmax_low(m, s);
      if (s == 0) bst_s[r][i] = best;
      if (i < nb && valid && rmask[(size_t)(row0 + r) * nb + i] != 0)
        m = init;
      start = end;
    }
  }
  __syncthreads();  // decisions complete, sv dead: the bits reuse it

  // traceback: one lane per row, on the first warp
  uint8_t* bits_s = smem;
  if (tid < rows) {
    const int r = tid;
    bool rst[3];
    int bst[3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      rst[i] = i < nb && rmask[(size_t)(row0 + r) * nb + i] != 0;
      bst[i] = bst_s[r][i];
    }
    vg::traceback_row<Q>(bst_s[r][nb], reinterpret_cast<const uint32_t*>(stage)
                         + (r >> 1) * ds, 16 * (r & 1), n_sym, nb, bnd, rst,
                         bst, bits_s + r * bs);
  }
  __syncthreads();

  // CRC16 per segment over the group's lanes
  {
    const int grp = lane >> 4, s = lane & 15;
    const int r = 2 * warp + grp;
    const uint8_t* br = bits_s + r * bs;
    unsigned acc[kMaxSeg];
#pragma unroll
    for (int k = 0; k < kMaxSeg; ++k) acc[k] = 0;
    if (r < rows) {
      for (int t = s; t < n_sym; t += 16) {
        if (br[t]) {
#pragma unroll
          for (int k = 0; k < kMaxSeg; ++k)
            if (k < n_seg) acc[k] ^= (unsigned)__ldg(crcw + k * n_sym + t);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kMaxSeg; ++k) {
      if (k < n_seg) {
        unsigned a = acc[k];
#pragma unroll
        for (int off = 8; off > 0; off >>= 1)
          a ^= __shfl_xor_sync(vg::kFull, a, off);
        if (s == 0 && r < rows)
          ok[(size_t)(row0 + r) * n_seg + k] =
              a == (unsigned)__ldg(crct + k) ? 1 : 0;
      }
    }
  }
  vg::store_rows(bits + (size_t)row0 * n_sym, bits_s, rows, n_sym);
}

int check_args(int K, int n_tab, int nb, int b0, int b1, int b2, int n_seg,
               int n_sym) {
  if (n_sym <= 0 || n_sym > vg::kMaxSym || n_seg < 0 || n_seg > kMaxSeg ||
      K <= 0 || n_tab <= 0 || !vg::boundaries_ok(nb, b0, b1, b2, n_sym))
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" int tt_viterbi_assembled(const void* x, int K, const void* pidx,
                                    int n_tab, const void* tab,
                                    const void* rmask, int nb, int b0, int b1,
                                    int b2, const void* crcw, const void* crct,
                                    int n_seg, void* bits, void* ok, int B,
                                    int n_sym, void* stream) {
  int rc = check_args(K, n_tab, nb, b0, b1, b2, n_seg, n_sym);
  if (rc || B <= 0) return rc;
  const Layout L(K, n_tab, n_sym);
  const bool quads = vg::quads_ok(nb, b0, b1, b2, n_sym);
  auto kernel = quads ? viterbi_assembled_kernel<4> : viterbi_assembled_kernel<1>;
  rc = vg::allow_smem((const void*)kernel, L.total);
  if (rc) return rc;
  const int grid = (B + kRows - 1) / kRows;
  kernel<<<grid, kThreads, L.total, (cudaStream_t)stream>>>(
      (const int8_t*)x, K, (const int16_t*)pidx, n_tab, (const int32_t*)tab,
      (const int8_t*)rmask, nb, b0, b1, b2, (const int32_t*)crcw,
      (const int32_t*)crct, n_seg, (int8_t*)bits, (int8_t*)ok, B, n_sym);
  return (int)cudaGetLastError();
}

// out[0..3]: resident blocks per SM, registers per thread, shared bytes
// per block, threads per block, for a launch at (K, n_tab, n_sym) with
// restarts at multiples of 4.
extern "C" int tt_viterbi_assembled_occupancy(int K, int n_tab, int n_sym,
                                              int* out) {
  const int rc = check_args(K, n_tab, 0, -1, -1, -1, 0, n_sym);
  if (rc) return rc;
  const void* kernel = (n_sym & 3) == 0
                           ? (const void*)viterbi_assembled_kernel<4>
                           : (const void*)viterbi_assembled_kernel<1>;
  return vg::occupancy(kernel, Layout(K, n_tab, n_sym).total, out);
}

extern "C" const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
