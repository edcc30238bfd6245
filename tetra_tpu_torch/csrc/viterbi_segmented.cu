// Segmented 16-state Viterbi over float soft values (kernel K4 of the port).
//
// Replaces: tetra_tpu/ops/viterbi_pallas.py, decode_segmented_pallas
// (Pallas bodies _make_segmented_kernel16, taken by the soft path with
// f32 input, and _make_segmented_kernel16g, _make_segmented_kernel4,
// _make_segmented_kernel): 16-state Viterbi with per-row trellis restarts
// at up to three boundaries, soft f32 [B, n_sym*N] -> bits [B, n_sym].
//
// What bounds it on an H100: the add-compare-select recursion is serial
// in time (n_sym steps) and rows are independent, so the work is
// latency-bound float ALU work per row; device memory moves 4*N floats
// per step per row in and one byte per step out. The TPU kernel fuses
// four steps per iteration (radix 16) because its matrix unit computes
// the 256 four-step branch metrics in one pass, and ranks tied
// candidates so that its decisions equal the radix-2 chain's. On this
// card the radix-2 chain itself is cheap: one thread per row, 16 float
// metrics in registers, 32 branch metrics per step.
//
// Design:
// - Input is time-major [n_sym*N, B] (the wrapper transposes), so at
//   every step a warp reads 32 consecutive floats per generator.
// - Metrics start at 0 for state 0 and -1e6 for the others, at t = 0
//   and at every restart, as the JAX scan does. On the soft path the
//   values are integers (|v| <= 124*127, <= 432 nonzero positions per
//   row), so every metric stays below 2^24 and every add is exact:
//   decisions are bit-identical to the plain version.
// - Tie rules of the radix-2 reference: a decision takes the upper
//   predecessor only when c1 > c0; at a restart the traceback enters
//   the lowest-index state that held the maximum just before it; the
//   end state is the lowest-index argmax.
// - The code is an argument: pat[2*p + b] has bit n set where output n
//   of the edge (state p, input b) is 1, for N <= 4 generators.
// - Decision words (16 bits per step) sit in shared memory in a
//   [step][thread] layout; the traceback runs in the same thread.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSym = 288;
constexpr int kTpb = 64;          // rows per block: 288*64*2 B = 36 KB smem
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

template <int N>
__global__ void __launch_bounds__(kTpb)
viterbi_segmented_kernel(const float* __restrict__ soft_tm,
                         const int32_t* __restrict__ pat_in,
                         const int8_t* __restrict__ rmask, int nb,
                         int b0, int b1, int b2,
                         int8_t* __restrict__ bits, int B, int n_sym) {
  __shared__ uint16_t dec[kMaxSym * kTpb];
  const int tid = threadIdx.x;
  const int row = blockIdx.x * kTpb + tid;
  if (row >= B) return;

  int pat[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) pat[i] = __ldg(pat_in + i);
  const int bnd[3] = {b0, b1, b2};
  bool rst[3] = {false, false, false};
  for (int i = 0; i < nb; ++i) rst[i] = rmask[(size_t)row * nb + i] != 0;
  int bst[3] = {0, 0, 0};

  float m[16];
#pragma unroll
  for (int s = 0; s < 16; ++s) m[s] = s == 0 ? 0.f : kNeg;

  for (int t = 0; t < n_sym; ++t) {
    for (int i = 0; i < nb; ++i) {
      if (t == bnd[i]) {
        bst[i] = argmax_low(m);
        if (rst[i]) {
#pragma unroll
          for (int s = 0; s < 16; ++s) m[s] = s == 0 ? 0.f : kNeg;
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
    dec[t * kTpb + tid] = (uint16_t)word;
  }

  int state = argmax_low(m);
  int8_t* out = bits + (size_t)row * n_sym;
  for (int t = n_sym - 1; t >= 0; --t) {
    out[t] = (int8_t)(state & 1);
    const int took = (dec[t * kTpb + tid] >> state) & 1;
    state = (state >> 1) | (took << 3);
    for (int i = 0; i < nb; ++i) {
      if (t == bnd[i] && rst[i]) state = bst[i];
    }
  }
}

}  // namespace

extern "C" int tt_viterbi_segmented(const void* soft_tm, const void* pat,
                                    int n_out, const void* rmask, int nb,
                                    int b0, int b1, int b2, void* bits,
                                    int B, int n_sym, void* stream) {
  if (n_sym > kMaxSym || n_sym <= 0 || nb < 0 || nb > 3)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return 0;
  const int grid = (B + kTpb - 1) / kTpb;
  cudaStream_t s = (cudaStream_t)stream;
  const float* x = (const float*)soft_tm;
  const int32_t* p = (const int32_t*)pat;
  const int8_t* r = (const int8_t*)rmask;
  int8_t* o = (int8_t*)bits;
  switch (n_out) {
    case 1: viterbi_segmented_kernel<1><<<grid, kTpb, 0, s>>>(x, p, r, nb, b0, b1, b2, o, B, n_sym); break;
    case 2: viterbi_segmented_kernel<2><<<grid, kTpb, 0, s>>>(x, p, r, nb, b0, b1, b2, o, B, n_sym); break;
    case 3: viterbi_segmented_kernel<3><<<grid, kTpb, 0, s>>>(x, p, r, nb, b0, b1, b2, o, B, n_sym); break;
    case 4: viterbi_segmented_kernel<4><<<grid, kTpb, 0, s>>>(x, p, r, nb, b0, b1, b2, o, B, n_sym); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
