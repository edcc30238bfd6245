// Lane-group layout shared by the 16-state Viterbi kernels K1
// (viterbi_assembled.cu), K4 and K6 (viterbi_segmented.cu).
//
// A row (one slot's trellis) is decoded by a group of 16 lanes, one per
// trellis state, so a warp decodes two rows and a block of 256 threads
// sixteen (K6 runs blocks of 128 threads, eight rows). At each step lane
// s (new state s) fetches the metrics of its two predecessors, states
// s>>1 and (s>>1)|8, from the lanes that hold them with __shfl_sync,
// computes its two candidates and keeps the larger. The step's 32
// decisions (two rows x 16 states) come from one __ballot_sync: row g of
// the warp owns bits 16g..16g+15. Lane 0 stores the words to shared
// memory, four steps per 16-byte store, and the whole block's traceback
// then runs on one warp, one lane per row: a traceback step is a few
// dependent integer operations, and walking it on every lane of the group
// would spend 16 issue slots on one row.
//
// Tie rules of the radix-2 reference (ops/viterbi.py): a decision takes
// the upper predecessor only when c1 > c0; every argmax (at a restart
// boundary and at the end) keeps the lowest state among equal metrics.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace vg {

constexpr int kGroup = 16;                  // lanes per row: one per state
constexpr int kRows = 16;                   // rows per block
constexpr int kThreads = kRows * kGroup;    // 256: eight warps of two rows
constexpr int kMaxSym = 292;                // TCH/4.8, the longest decode
constexpr unsigned kFull = 0xffffffffu;

// Lowest-index state holding the group's largest metric. Lane s of the
// group passes its own metric; every lane of the group gets the answer.
// The xor offsets stay inside the 16-lane half of the warp.
template <typename T>
__device__ __forceinline__ int group_argmax_low(T m, int s) {
  int bi = s;
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) {
    const T om = __shfl_xor_sync(kFull, m, off);
    const int oi = __shfl_xor_sync(kFull, bi, off);
    if (om > m || (om == m && oi < bi)) {
      m = om;
      bi = oi;
    }
  }
  return bi;
}

// Decision words of a block: [kRows/2 warps][dec_stride] uint32. The
// stride is 4 (mod 32) words, so that the traceback lanes' reads of the
// eight warps' words at one step fall in distinct banks, and a multiple
// of 4, so that four steps' words store and load as one 16-byte access.
__host__ __device__ inline int dec_stride(int n_sym) {
  return ((n_sym + 31) & ~31) + 4;
}

// Decoded bits of a block: [kRows][bits_stride] bytes. stride / 4 is
// odd, so the 16 traceback lanes' 4-byte stores fall in distinct banks.
__host__ __device__ inline int bits_stride(int n_sym) {
  return ((n_sym + 15) & ~15) + 4;
}

// Walks one row's decisions back from its end state: one lane per row.
// dec[t] is the ballot word of step t of the row's warp and sh = 16 *
// (row's half of that warp). Restarts split the row into segments
// [bnd[i-1], bnd[i]); on leaving a restarted segment backwards the path
// enters bst[i-1], the state that held the best metric just before the
// restart. With Q = 4 (n_sym and the boundaries multiples of 4) four
// steps share one 16-byte load and one 4-byte store of their bits;
// with Q = 1 each step loads its word and stores its byte.
template <int Q>
__device__ __forceinline__ void traceback_row(int state, const uint32_t* dec,
                                              int sh, int n_sym, int nb,
                                              const int (&bnd)[3],
                                              const bool (&rst)[3],
                                              const int (&bst)[3],
                                              uint8_t* out) {
  int end = n_sym;
#pragma unroll
  for (int i = 3; i >= 0; --i) {
    if (i > nb) continue;
    const int start = i > 0 ? bnd[i - 1] : 0;
    if constexpr (Q == 4) {
      for (int t4 = end - 4; t4 >= start; t4 -= 4) {
        const uint4 q = *reinterpret_cast<const uint4*>(dec + t4);
        const uint32_t w[4] = {q.x, q.y, q.z, q.w};
        uint32_t b = 0;
#pragma unroll
        for (int k = 3; k >= 0; --k) {
          b |= (uint32_t)(state & 1) << (8 * k);
          state = (state >> 1) | (int)(((w[k] >> (state + sh)) & 1) << 3);
        }
        *reinterpret_cast<uint32_t*>(out + t4) = b;
      }
    } else {
      for (int t = end - 1; t >= start; --t) {
        out[t] = (uint8_t)(state & 1);
        state = (state >> 1) | (int)(((dec[t] >> (state + sh)) & 1) << 3);
      }
    }
    if (i > 0 && rst[i - 1]) state = bst[i - 1];
    end = start;
  }
}

// Copies the block's bits [rows][bits_stride] (shared memory) to out
// [rows, n_sym]: 4-byte words where n_sym allows, else bytes.
__device__ __forceinline__ void store_rows(int8_t* out, const uint8_t* bits,
                                           int rows, int n_sym) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const int bs = bits_stride(n_sym);
  if ((n_sym & 3) == 0 && ((uintptr_t)out & 3) == 0) {
    const int nq = n_sym >> 2;
    for (int i = tid; i < rows * nq; i += nt) {
      const int r = i / nq, q = i - r * nq;
      reinterpret_cast<uint32_t*>(out + (size_t)r * n_sym)[q] =
          reinterpret_cast<const uint32_t*>(bits + r * bs)[q];
    }
  } else {
    for (int i = tid; i < rows * n_sym; i += nt) {
      const int r = i / n_sym, t = i - r * n_sym;
      out[(size_t)r * n_sym + t] = (int8_t)bits[r * bs + t];
    }
  }
}

// True where four steps can go together: n_sym and every boundary are
// multiples of 4.
inline bool quads_ok(int nb, int b0, int b1, int b2, int n_sym) {
  const int b[3] = {b0, b1, b2};
  bool ok = (n_sym & 3) == 0;
  for (int i = 0; i < nb; ++i) ok = ok && (b[i] & 3) == 0;
  return ok;
}

// Copies n bytes from device memory to shared memory with 16-byte loads
// where it can. dst must equal src modulo 16 (the caller offsets its
// shared buffer by src's misalignment); the head and tail go bytewise.
__device__ __forceinline__ void stage_bytes(uint8_t* dst, const uint8_t* src,
                                            int n) {
  const int tid = threadIdx.x, nt = blockDim.x;
  int head = (int)((16 - ((uintptr_t)src & 15)) & 15);
  if (head > n) head = n;
  const int n16 = (n - head) >> 4;
  const uint4* s4 = reinterpret_cast<const uint4*>(src + head);
  uint4* d4 = reinterpret_cast<uint4*>(dst + head);
  for (int i = tid; i < n16; i += nt) d4[i] = __ldg(s4 + i);
  for (int i = tid; i < head; i += nt) dst[i] = src[i];
  for (int i = head + 16 * n16 + tid; i < n; i += nt) dst[i] = src[i];
}

// Checks the restart boundaries the segment loops rely on: nb <= 3 and
// 0 <= b0 < b1 < b2 < n_sym for the first nb of them.
inline bool boundaries_ok(int nb, int b0, int b1, int b2, int n_sym) {
  if (nb < 0 || nb > 3) return false;
  const int b[3] = {b0, b1, b2};
  int prev = -1;
  for (int i = 0; i < nb; ++i) {
    if (b[i] <= prev || b[i] >= n_sym) return false;
    prev = b[i];
  }
  return true;
}

// Opts a kernel into `bytes` of dynamic shared memory where that is
// above the default 48 KB; returns the CUDA error code.
inline int allow_smem(const void* kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Occupancy of a kernel at `bytes` of dynamic shared memory and
// `threads` per block: out[0] resident blocks per SM, out[1] registers
// per thread, out[2] shared bytes per block (static + dynamic), out[3]
// threads per block.
inline int occupancy(const void* kernel, int bytes, int* out,
                     int threads = kThreads) {
  int rc = allow_smem(kernel, bytes);
  if (rc) return rc;
  cudaFuncAttributes attr;
  rc = (int)cudaFuncGetAttributes(&attr, kernel);
  if (rc) return rc;
  int blocks = 0;
  rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                          threads, bytes);
  if (rc) return rc;
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = (int)attr.sharedSizeBytes + bytes;
  out[3] = threads;
  return 0;
}

}  // namespace vg
