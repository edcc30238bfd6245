// Assembled segmented Viterbi + CRC16 (kernel K1 of the port).
//
// Replaces: tetra_tpu/ops/viterbi_pallas.py, decode_assembled_pallas
// (Pallas body _make_fused_kernel16): FEC assembly prologue, 16-state
// segmented Viterbi with per-slot trellis restarts, CRC16 epilogue.
//
// What bounds it on an H100: the add-compare-select recursion is
// serial in time (288 or 80 steps) and each slot is independent, so the
// work is latency-bound integer ALU work per slot; device memory moves
// only ~0.5 KB of input signs, n_sym output bits and a few flags per
// slot. There is no matrix product worth a tensor core: the TPU kernel
// spreads the descrambled signs into mother order with a one-hot s8
// matmul only because its MXU is the fastest unit it has.
//
// Design: one thread per slot. The 16 path metrics are int32 registers
// (loops fully unrolled so they never leave the register file), which
// makes ties exact and the decisions bit-identical to the radix-2
// reference (decision c1 > c0, lowest-index argmax at restarts and at
// the end). The deinterleave + depuncture spread is an index gather
// pidx[tab][m] -> source column of x (-1 = erasure) instead of the
// one-hot matmul. Decision words (16 bits per step) sit in shared
// memory in a [step][thread] layout, so a warp's 32 threads touch
// consecutive halfwords. The traceback emits bits in reverse order;
// the CRC of each segment is order-free: XOR the crc16_matrix row of
// every set bit into a 16-bit register and compare with the target.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSym = 288;
constexpr int kTpb = 64;          // slots per block: 288*64*2 B = 36 KB smem
constexpr int kMaxSeg = 8;
constexpr int kNeg = -(1 << 27);

// CCH mother code generators as state-bit masks: taps d -> bit d-1
// (tetra_tpu.constants.CONV_GENERATORS_CCH = (1,4) (2,3,4) (1,2,4) (1,3,4))
constexpr int kG0 = 0x9, kG1 = 0xE, kG2 = 0xB, kG3 = 0xD;

__host__ __device__ constexpr int parity4(int v) {
  return (v ^ (v >> 1) ^ (v >> 2) ^ (v >> 3)) & 1;
}

// branch metric of predecessor state p with input bit 0; input bit 1
// flips every output bit, so its metric is the negation
__device__ __forceinline__ int bm0(int p, int s0, int s1, int s2, int s3) {
  return (parity4(p & kG0) ? -s0 : s0) + (parity4(p & kG1) ? -s1 : s1) +
         (parity4(p & kG2) ? -s2 : s2) + (parity4(p & kG3) ? -s3 : s3);
}

__device__ __forceinline__ int argmax_low(const int (&m)[16]) {
  int best = 0;
  int bv = m[0];
#pragma unroll
  for (int s = 1; s < 16; ++s) {
    if (m[s] > bv) { bv = m[s]; best = s; }
  }
  return best;
}

__global__ void __launch_bounds__(kTpb)
viterbi_assembled_kernel(const int8_t* __restrict__ x, int K,
                         const int16_t* __restrict__ pidx,
                         const int32_t* __restrict__ tab,
                         const int8_t* __restrict__ rmask, int nb,
                         int b0, int b1, int b2,
                         const int32_t* __restrict__ crcw,
                         const int32_t* __restrict__ crct, int n_seg,
                         int8_t* __restrict__ bits, int8_t* __restrict__ ok,
                         int B, int n_sym) {
  __shared__ uint16_t dec[kMaxSym * kTpb];
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kTpb + tid;
  if (row >= B) return;

  const int8_t* xr = x + (size_t)row * K;
  const int16_t* pr = pidx + (size_t)tab[row] * 4 * n_sym;
  const int bnd[3] = {b0, b1, b2};
  bool rst[3] = {false, false, false};
  for (int i = 0; i < nb; ++i) rst[i] = rmask[(size_t)row * nb + i] != 0;
  int bst[3] = {0, 0, 0};

  int m[16];
#pragma unroll
  for (int s = 0; s < 16; ++s) m[s] = s == 0 ? 0 : kNeg;

  for (int t = 0; t < n_sym; ++t) {
    for (int i = 0; i < nb; ++i) {
      if (t == bnd[i]) {
        bst[i] = argmax_low(m);
        if (rst[i]) {
#pragma unroll
          for (int s = 0; s < 16; ++s) m[s] = s == 0 ? 0 : kNeg;
        }
      }
    }
    int sv[4];
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const int src = __ldg(pr + 4 * t + n);
      sv[n] = src >= 0 ? (int)__ldg(xr + src) : 0;
    }
    int bm[16];
#pragma unroll
    for (int p = 0; p < 16; ++p) bm[p] = bm0(p, sv[0], sv[1], sv[2], sv[3]);
    int nm[16];
    unsigned word = 0;
#pragma unroll
    for (int ns = 0; ns < 16; ++ns) {
      const int p0 = ns >> 1, p1 = (ns >> 1) | 8;
      const int sgn = (ns & 1) ? -1 : 1;
      const int c0 = m[p0] + sgn * bm[p0];
      const int c1 = m[p1] + sgn * bm[p1];
      const bool d = c1 > c0;
      nm[ns] = d ? c1 : c0;
      word |= (unsigned)d << ns;
    }
#pragma unroll
    for (int s = 0; s < 16; ++s) m[s] = nm[s];
    dec[t * kTpb + tid] = (uint16_t)word;
  }

  int state = argmax_low(m);
  unsigned acc[kMaxSeg];
  for (int s = 0; s < kMaxSeg; ++s) acc[s] = 0;
  int8_t* out = bits + (size_t)row * n_sym;
  for (int t = n_sym - 1; t >= 0; --t) {
    const int bit = state & 1;
    out[t] = (int8_t)bit;
    if (bit) {
      for (int s = 0; s < n_seg; ++s) acc[s] ^= (unsigned)__ldg(crcw + s * n_sym + t);
    }
    const int took = (dec[t * kTpb + tid] >> state) & 1;
    state = (state >> 1) | (took << 3);
    for (int i = 0; i < nb; ++i) {
      if (t == bnd[i] && rst[i]) state = bst[i];
    }
  }
  for (int s = 0; s < n_seg; ++s)
    ok[(size_t)row * n_seg + s] = acc[s] == (unsigned)__ldg(crct + s) ? 1 : 0;
}

}  // namespace

extern "C" int tt_viterbi_assembled(const void* x, int K, const void* pidx,
                                    const void* tab, const void* rmask,
                                    int nb, int b0, int b1, int b2,
                                    const void* crcw, const void* crct,
                                    int n_seg, void* bits, void* ok, int B,
                                    int n_sym, void* stream) {
  if (n_sym > kMaxSym || n_seg > kMaxSeg || nb > 3 || n_sym <= 0)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int grid = (B + kTpb - 1) / kTpb;
  viterbi_assembled_kernel<<<grid, kTpb, 0, (cudaStream_t)stream>>>(
      (const int8_t*)x, K, (const int16_t*)pidx, (const int32_t*)tab,
      (const int8_t*)rmask, nb, b0, b1, b2, (const int32_t*)crcw,
      (const int32_t*)crct, n_seg, (int8_t*)bits, (int8_t*)ok, B, n_sym);
  return (int)cudaGetLastError();
}

extern "C" const char* tt_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
