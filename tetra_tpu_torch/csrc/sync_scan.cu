// Burst synchroniser step loop (kernel S1 of the port): `steps` feed
// quanta of the reference's burst-lock state machine over every carrier
// of a bit window, in one launch.
//
// Replaces: tetra_tpu/phy/sync_vec.py, sync_scan's lax.scan over steps
// (sync_vec.py:215; XLA compiles it into one on-device loop, not a Pallas
// kernel), whose step is tetra_tpu_torch/phy/sync_vec.py's
// sync_scan_plain loop body, reproduced here exactly: the ring-space
// clamp, the UNLOCKED acquisition, the KNOW_FSTART hand-over, the LOCKED
// three-column search (key q*4+ci, kBig*4 as none), with tol the
// expected-offset override, the bad/lost/emit flags and the advance by
// one slot. All arithmetic is int32, as in the plain version.
//
// Inputs the wrapper (sync_vec.sync_scan) prepares with batched torch
// ops once a call: nm [3, B, L + 1], for each locked column the first
// match at or after each position (L where none, and L at the sentinel
// position L). The visibility rule of the polluted 22-bit prefilter reads
// the bit before a candidate straight from bits [B, L] (int8), and the
// tolerant mode's "column matches at p" is nm[p] == p (p < L).
//
// What bounds it on an H100: a carrier's steps are a chain of dependent
// lookups (next match, the bit before it, the next match after it, twice
// over, for three columns), so one thread per carrier is latency-bound by
// design: every step waits for a few L2 or device-memory round trips, and
// a prod-1024 window gives only 1,024 threads. The function's own bytes
// (bits read once, ten planes written once) and operations are far
// below what those latencies cost.
//
// Design (a simple kernel that is right first):
// - One thread per carrier, 32 threads per block, so the carriers spread
//   over as many SMs as there are warps. The carry (state, buf_start,
//   nbuf, nfs, slot_index) stays in registers across all steps.
// - Every lookup clamps its position to [0, L], as the plain version's
//   gather does: buf_start may be -1 (nfs0 may be -1) and may move
//   backwards at KNOW_FSTART, so no lookup assumes growing positions.
// - The three columns' searches are unrolled so that their independent
//   lookups are in flight together.
// - The UNLOCKED search over [a, a + nbuf) is the LOCKED search's column
//   0: it only counts when the state at the top of the step is UNLOCKED,
//   and then no KNOW_FSTART hand-over ran, so the locked window is the
//   same window.
// - Thread b writes element [t, b] of the ten [steps, B] planes at step
//   t, so a warp's stores of one plane are contiguous. The planes are
//   written in the plain version's types: burst, emit, found, bad and
//   lost as bytes 0/1 (torch.bool), col, slot, found_rel, found_q and
//   bad_rel as int32.
// Left for later: the match maps packed as bitmasks, one warp per
// carrier.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 32;
constexpr int kBig = 1 << 27;   // "no match" (sync_vec._BIG)
constexpr int kCols = 3;        // SYNC, NORM_1, NORM_2 (LOCKED_COLS)

// Protocol constants, the same at every call; tt_sync_scan_constants
// hands them to sync_vec, which checks them against its own once.
constexpr int kTs = 510;        // BITS_PER_TS
constexpr int kRing = 4096;     // RING_BITS
constexpr int kSyncOff = 214;   // SYNC_TRAIN_OFFSET
constexpr int kNormOff = 244;   // NORM_TRAIN_OFFSET
// Column ci's training sequence (y, n, p): its length, its first bit and
// whether its second bit equals the first.
constexpr int kLen0 = 38, kLen1 = 22, kLen2 = 22;
constexpr int kPat0_0 = 1, kPat0_1 = 1, kPat0_2 = 0;
constexpr int kPat1Eq0 = 1, kPat1Eq1 = 1, kPat1Eq2 = 0;

__host__ __device__ constexpr int by_col(int ci, int v0, int v1, int v2) {
  return ci == 0 ? v0 : (ci == 1 ? v1 : v2);
}
__host__ __device__ constexpr int seq_len(int ci) {
  return by_col(ci, kLen0, kLen1, kLen2);
}
__host__ __device__ constexpr int seq_pat0(int ci) {
  return by_col(ci, kPat0_0, kPat0_1, kPat0_2);
}
__host__ __device__ constexpr bool seq_pat1eq(int ci) {
  return by_col(ci, kPat1Eq0, kPat1Eq1, kPat1Eq2) != 0;
}

struct Args {
  const int8_t* bits;     // [B, L]
  const int32_t* nm;      // [3, B, L + 1]
  const int32_t* carry;   // [5, B]: state, buf_start, nbuf, nfs, slot_index
  int B, L, steps, feed;
  bool tol;
  int32_t* carry_out;     // [5, B]
  uint8_t* flags;         // [5, steps, B]: burst, emit, found, bad, lost
  int32_t* ints;          // [5, steps, B]: col, slot, found_rel, found_q,
                          // bad_rel
};

__device__ __forceinline__ int clamp_pos(int p, int L) {
  return min(max(p, 0), L);
}

// The bit before position p as the plain version's viz20 map holds it:
// bits[p - 1] == pat0 for 0 < p < L, (0 == pat0) at p = 0 (the map's zero
// column), False at the sentinel p = L.
__device__ __forceinline__ bool vis20_at(const int8_t* br, int p, int L,
                                         int pat0) {
  if (p >= L) return false;
  const int prev = p > 0 ? (int)br[p - 1] : 0;
  return prev == pat0;
}

// First visible and fitting match of one column in window [a, b), or kBig
// (sync_vec.sync_scan_plain's first_match; phy.sync._find for one
// column): chase polluted-invisible candidates exactly twice.
__device__ __forceinline__ int first_match(const int32_t* nmr,
                                           const int8_t* br, int L, int a,
                                           int b, int len, int pat0,
                                           bool pat1eq) {
  int q = __ldg(nmr + clamp_pos(a, L));
#pragma unroll
  for (int it = 0; it < 2; ++it) {
    const int k = q - a;
    const bool v20 = vis20_at(br, clamp_pos(q, L), L, pat0);
    bool vis = k >= 21 || (k == 20 && v20);
    if (pat1eq) vis = vis || (k == 19 && v20);
    if (q < L && !vis) q = __ldg(nmr + clamp_pos(q + 1, L));
  }
  const bool fit = q + len <= b;
  return (fit && q < L) ? q : kBig;
}

// Tolerant mode: the column matches at p and the sequence fits the
// buffer (the plain version's mcols lookup: False at the sentinel L).
__device__ __forceinline__ bool match_at(const int32_t* nmr, int L, int p,
                                         int len, int blim) {
  const int pc = clamp_pos(p, L);
  return pc < L && __ldg(nmr + pc) == pc && p + len <= blim;
}

__global__ void __launch_bounds__(kThreads)
sync_scan_kernel(const Args a) {
  const int b = blockIdx.x * kThreads + threadIdx.x;
  if (b >= a.B) return;
  const size_t B = (size_t)a.B;
  const int L = a.L;
  const int8_t* br = a.bits + (size_t)b * L;
  const int32_t* nmr[kCols];
#pragma unroll
  for (int ci = 0; ci < kCols; ++ci)
    nmr[ci] = a.nm + ((size_t)ci * B + b) * (size_t)(L + 1);

  int state = a.carry[b];
  int buf_start = a.carry[B + b];
  int nbuf = a.carry[2 * B + b];
  int nfs = a.carry[3 * B + b];
  int slot_index = a.carry[4 * B + b];

  const size_t plane = (size_t)a.steps * B;
  for (int t = 0; t < a.steps; ++t) {
    // make_bitbuf_space + append (tetra_burst_sync.c:38-66)
    const int delta = max(a.feed - (kRing - nbuf), 0);
    nbuf = nbuf + a.feed - delta;
    buf_start = buf_start + delta;
    const int st = state;          // the state at the top of the step
    const int a0 = buf_start;

    // KNOW_FSTART (only pre-existing; a fresh acquisition waits)
    const bool kf = st == 1 && a0 + nbuf >= nfs;
    const int nbuf_u = nbuf;       // the UNLOCKED window's length
    if (kf) {
      nbuf = nbuf - (nfs - a0);
      buf_start = nfs;
    }

    // LOCKED: the three columns' first matches in [slot, blim)
    const int slot = buf_start;
    const int blim = buf_start + nbuf;
    int q[kCols];
#pragma unroll
    for (int ci = 0; ci < kCols; ++ci)
      q[ci] = first_match(nmr[ci], br, L, slot, blim, seq_len(ci),
                          seq_pat0(ci), seq_pat1eq(ci));

    // UNLOCKED: scan for SYNC once >= 2 slots are buffered; counted only
    // when st == 0, where kf is false and [slot, blim) is [a0, a0+nbuf)
    const int q0 = q[0];
    const bool found = st == 0 && nbuf_u >= 2 * kTs && q0 < kBig;
    const int found_rel = found ? q0 - a0 : 0;
    const int state_u = found ? 1 : st;
    const int nfs_u = found ? q0 + (kTs - kSyncOff) : nfs;
    const int nfs_k = kf ? nfs + kTs : nfs_u;
    const int state_k = kf ? 2 : state_u;

    const bool lk = (st == 2 || kf) && nbuf >= kTs;
    int key = kBig * 4;
#pragma unroll
    for (int ci = 0; ci < kCols; ++ci)
      key = min(key, q[ci] < kBig ? q[ci] * 4 + ci : kBig * 4);
    bool has = key < kBig * 4;
    int col = has ? (key & 3) : -1;
    int qw = key >> 2;
    if (a.tol) {
      // the expected offsets win; the first-match scan is the fallback
      const bool e0 = match_at(nmr[0], L, slot + kSyncOff, seq_len(0), blim);
      const bool e1 = match_at(nmr[1], L, slot + kNormOff, seq_len(1), blim);
      const bool e2 = match_at(nmr[2], L, slot + kNormOff, seq_len(2), blim);
      const bool eh = e0 || e1 || e2;
      if (eh) {
        col = e0 ? 0 : (e1 ? 1 : 2);
        qw = e0 ? slot + kSyncOff : slot + kNormOff;
      }
      has = has || eh;
    }
    const int rel = qw - slot;

    const bool is_sync = lk && col == 0;
    const bool sync_ok = is_sync && rel == kSyncOff;
    const bool is_norm = lk && (col == 1 || col == 2);
    const bool norm_ok = is_norm && rel == kNormOff;
    const bool lost = lk && !has;
    const bool bad = (is_sync && !sync_ok) || (is_norm && !norm_ok);
    const bool emit = sync_ok || norm_ok;

    state = ((is_sync && !sync_ok) || lost) ? 0 : state_k;
    slot_index = slot_index + (lk ? 1 : 0);
    const int adv = lk ? kTs : 0;

    const size_t o = (size_t)t * B + b;
    a.flags[o] = lk;
    a.flags[plane + o] = emit;
    a.flags[2 * plane + o] = found;
    a.flags[3 * plane + o] = bad;
    a.flags[4 * plane + o] = lost;
    a.ints[o] = col;
    a.ints[plane + o] = slot;
    a.ints[2 * plane + o] = found_rel;
    a.ints[3 * plane + o] = found ? q0 : 0;
    a.ints[4 * plane + o] = bad ? rel : 0;

    buf_start = buf_start + adv;
    nbuf = nbuf - adv;
    nfs = nfs_k + adv;
  }
  a.carry_out[b] = state;
  a.carry_out[B + b] = buf_start;
  a.carry_out[2 * B + b] = nbuf;
  a.carry_out[3 * B + b] = nfs;
  a.carry_out[4 * B + b] = slot_index;
}

}  // namespace

// Launch S1 on `stream`. Returns cudaGetLastError() after the launch (no
// launch when B or steps is 0).
extern "C" int tt_sync_scan(const void* bits, const void* nm,
                            const void* carry, int B, int L, int steps,
                            int feed, int tol, void* carry_out, void* flags,
                            void* ints, void* stream) {
  if (B < 0 || L < 0 || steps < 0 || feed <= 0)
    return (int)cudaErrorInvalidValue;
  if (B == 0 || steps == 0) return 0;
  Args a{(const int8_t*)bits, (const int32_t*)nm, (const int32_t*)carry,
         B, L, steps, feed, tol != 0,
         (int32_t*)carry_out, (uint8_t*)flags, (int32_t*)ints};
  const unsigned grid = (unsigned)((B + kThreads - 1) / kThreads);
  sync_scan_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The protocol constants S1 was built with, into out[13]: BITS_PER_TS,
// RING_BITS, SYNC_TRAIN_OFFSET, NORM_TRAIN_OFFSET, then per column its
// sequence length, first bit and second-equals-first flag.
extern "C" void tt_sync_scan_constants(int* out) {
  out[0] = kTs;
  out[1] = kRing;
  out[2] = kSyncOff;
  out[3] = kNormOff;
  for (int ci = 0; ci < kCols; ++ci) {
    out[4 + ci] = seq_len(ci);
    out[7 + ci] = seq_pat0(ci);
    out[10 + ci] = seq_pat1eq(ci);
  }
}

// S1's launch shape: resident blocks per SM, registers per thread, shared
// bytes per block, threads per block.
extern "C" int tt_sync_scan_occupancy(int* out) {
  int blocks = 0;
  int rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, (const void*)sync_scan_kernel, kThreads, 0);
  if (rc) return rc;
  cudaFuncAttributes attr;
  rc = (int)cudaFuncGetAttributes(&attr, (const void*)sync_scan_kernel);
  if (rc) return rc;
  out[0] = blocks;
  out[1] = attr.numRegs;
  out[2] = (int)attr.sharedSizeBytes;
  out[3] = kThreads;
  return 0;
}
