// 16-state radix-2 Viterbi over float soft values: kernels K4 (segmented)
// and K6 (unsegmented) of the port, one trellis body.
//
// K4 replaces tetra_tpu/ops/viterbi_pallas.py, decode_segmented_pallas
// (Pallas bodies _make_segmented_kernel16, taken by the soft path with
// f32 input, and _make_segmented_kernel16g, _make_segmented_kernel4,
// _make_segmented_kernel): 16-state Viterbi with per-row trellis restarts
// at up to three boundaries, soft f32 [B, n_sym*N] -> bits [B, n_sym].
// K6 replaces tetra_tpu/ops/viterbi_pallas.py, decode_pallas (Pallas body
// _make_kernel): the same decode with no restarts, for any n_sym (the TPU
// routes even n_sym to K4's radix-4 body only for its matrix unit; here
// both bodies are this radix-2 chain, so K6 takes both parities). Its
// path is the TCH/S voice decode (rate 1/3, n_sym 112 and 72).
//
// What bounds it on an H100: the add-compare-select recursion is serial
// in time (n_sym steps) and rows are independent, so the work is
// latency-bound float ALU work per row; device memory moves 4*N floats
// per step per row in and one byte per step out. At K6's voice shape
// (~3,070 rows x n112 x N 3) that is ~4.5 MB, ~1.3 us at 3.35 TB/s, and
// the ACS arithmetic is of the same order at 67 TFLOP/s f32: the time is
// set by the 112-step dependent chain per thread and by occupancy
// (3,070 rows are ~96 warps for 132 SMs). The TPU kernel fuses four
// steps per iteration (radix 16) because its matrix unit computes the
// 256 four-step branch metrics in one pass, and ranks tied candidates so
// that its decisions equal the radix-2 chain's. On this card the radix-2
// chain itself is cheap: one thread per row, 16 float metrics in
// registers, 32 branch metrics per step.
//
// Design:
// - Input is time-major [n_sym*N, B] (the wrapper transposes), so at
//   every step a warp reads 32 consecutive floats per generator.
// - Metrics start at 0 for state 0 and -1e6 for the others, at t = 0
//   and at every restart, as the JAX scan does. On the soft path the
//   values are integers (|v| <= 124*127, <= 432 nonzero positions per
//   row), and on the voice path +-127 or 0, so every metric stays below
//   2^24 and every add is exact: decisions are bit-identical to the
//   plain version.
// - Tie rules of the radix-2 reference: a decision takes the upper
//   predecessor only when c1 > c0; at a restart the traceback enters
//   the lowest-index state that held the maximum just before it; the
//   end state is the lowest-index argmax. All-erasure rows are pure
//   ties and decode to zeros.
// - The code is an argument: pat[2*p + b] has bit n set where output n
//   of the edge (state p, input b) is 1, for N <= 4 generators.
// - Decision words (16 bits per step) sit in shared memory in a
//   [step][thread] layout; the traceback runs in the same thread.
// - Template parameters: MAXB restart boundaries (3 for K4, 0 for K6,
//   where the restart code compiles away) and TPB rows per block (K4 64;
//   K6 32, so that its few thousand rows spread over more SMs).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSym = 288;
constexpr int kTpbSeg = 64;       // K4 rows per block: 288*64*2 B = 36 KB smem
constexpr int kTpbDec = 32;       // K6 rows per block: 18 KB smem
constexpr float kNeg = -1e6f;

__device__ __forceinline__ int argmax_low(const float (&m)[16]) {
  int best = 0;
  float bv = m[0];
#pragma unroll
  for (int s = 1; s < 16; ++s) {
    if (m[s] > bv) { bv = m[s]; best = s; }
  }
  return best;
}

template <int N, int MAXB, int TPB>
__global__ void __launch_bounds__(TPB)
viterbi_kernel(const float* __restrict__ soft_tm,
               const int32_t* __restrict__ pat_in,
               const int8_t* __restrict__ rmask, int nb,
               int b0, int b1, int b2,
               int8_t* __restrict__ bits, int B, int n_sym) {
  __shared__ uint16_t dec[kMaxSym * TPB];
  const int tid = threadIdx.x;
  const int row = blockIdx.x * TPB + tid;
  if (row >= B) return;

  int pat[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) pat[i] = __ldg(pat_in + i);
  const int bnd[3] = {b0, b1, b2};
  bool rst[3] = {false, false, false};
  int bst[3] = {0, 0, 0};
  if constexpr (MAXB > 0) {
    for (int i = 0; i < nb; ++i) rst[i] = rmask[(size_t)row * nb + i] != 0;
  }

  float m[16];
#pragma unroll
  for (int s = 0; s < 16; ++s) m[s] = s == 0 ? 0.f : kNeg;

  for (int t = 0; t < n_sym; ++t) {
    if constexpr (MAXB > 0) {
      for (int i = 0; i < nb; ++i) {
        if (t == bnd[i]) {
          bst[i] = argmax_low(m);
          if (rst[i]) {
#pragma unroll
            for (int s = 0; s < 16; ++s) m[s] = s == 0 ? 0.f : kNeg;
          }
        }
      }
    }
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
    dec[t * TPB + tid] = (uint16_t)word;
  }

  int state = argmax_low(m);
  int8_t* out = bits + (size_t)row * n_sym;
  for (int t = n_sym - 1; t >= 0; --t) {
    out[t] = (int8_t)(state & 1);
    const int took = (dec[t * TPB + tid] >> state) & 1;
    state = (state >> 1) | (took << 3);
    if constexpr (MAXB > 0) {
      for (int i = 0; i < nb; ++i) {
        if (t == bnd[i] && rst[i]) state = bst[i];
      }
    }
  }
}

template <int MAXB, int TPB>
int launch(const void* soft_tm, const void* pat, int n_out, const void* rmask,
           int nb, int b0, int b1, int b2, void* bits, int B, int n_sym,
           void* stream) {
  if (n_sym > kMaxSym || n_sym <= 0 || nb < 0 || nb > MAXB)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int grid = (B + TPB - 1) / TPB;
  cudaStream_t s = (cudaStream_t)stream;
  const float* x = (const float*)soft_tm;
  const int32_t* p = (const int32_t*)pat;
  const int8_t* r = (const int8_t*)rmask;
  int8_t* o = (int8_t*)bits;
  switch (n_out) {
    case 1: viterbi_kernel<1, MAXB, TPB><<<grid, TPB, 0, s>>>(x, p, r, nb, b0, b1, b2, o, B, n_sym); break;
    case 2: viterbi_kernel<2, MAXB, TPB><<<grid, TPB, 0, s>>>(x, p, r, nb, b0, b1, b2, o, B, n_sym); break;
    case 3: viterbi_kernel<3, MAXB, TPB><<<grid, TPB, 0, s>>>(x, p, r, nb, b0, b1, b2, o, B, n_sym); break;
    case 4: viterbi_kernel<4, MAXB, TPB><<<grid, TPB, 0, s>>>(x, p, r, nb, b0, b1, b2, o, B, n_sym); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K4: up to three restart boundaries.
extern "C" int tt_viterbi_segmented(const void* soft_tm, const void* pat,
                                    int n_out, const void* rmask, int nb,
                                    int b0, int b1, int b2, void* bits,
                                    int B, int n_sym, void* stream) {
  return launch<3, kTpbSeg>(soft_tm, pat, n_out, rmask, nb, b0, b1, b2,
                            bits, B, n_sym, stream);
}

// K6: the unsegmented decode.
extern "C" int tt_viterbi_decode(const void* soft_tm, const void* pat,
                                 int n_out, void* bits, int B, int n_sym,
                                 void* stream) {
  return launch<0, kTpbDec>(soft_tm, pat, n_out, nullptr, 0, -1, -1, -1,
                            bits, B, n_sym, stream);
}
