"""The least time the card could take for a kernel's function: frozen
copies of chip_smoke.py's bound, k2_bound and sync_bound, with the peaks
of one NVIDIA H100 SXM (NVIDIA's data sheet, dense rates)."""
from __future__ import annotations

import math

HBM_BPS = 3.35e12                 # device memory, bytes/s
F32_FLOPS = 67e12                 # float32 outside the tensor cores
INT32_OPS = F32_FLOPS / 4
# one sync step's int32 operations (chip_smoke.SYNC_STEP_OPS): ring clamp
# and append 6, hand-over 7, per column next set bit 4, visibility 5 and
# fit 2, acquisition 8, key and column 12, offsets and flags 16, the
# tolerant override 6, the carry's advance 8
SYNC_STEP_OPS = 6 + 7 + 3 * (4 + 5 + 2) + 8 + 12 + 16 + 6 + 8
SYNC_SEQ_BIT_OPS = {0: 2, 1: 3, 2: 3}
SYNC_SEQ_BITS = 38 + 22 + 22      # the y, n and p training sequences


def bound(nbytes: float, ops: float, peak: float) -> float:
    """Seconds: the larger of the bytes over the memory rate and the
    operations over `peak`."""
    return max(nbytes / HBM_BPS, ops / peak)


def k2_bound(n_chan: int, T: int, frames: int, J: int = 16) -> float:
    """K2 (the PFB): planes in, prototype and twiddles once, [M, C]
    complex out; per frame and channel a complex window-and-fold over J
    branches (4 ops each) and its share of a C-point FFT (5 log2 C)."""
    return bound(8 * T + 4 * (J * n_chan + 2 * n_chan) + 8 * frames * n_chan,
                 frames * n_chan * (4 * J + 5 * math.log2(n_chan)), F32_FLOPS)


def sync_bound(B: int, L: int, steps: int, tol: int) -> float:
    """A sync_scan call at B carriers, window L, `steps` steps: bits read
    once, the carry read and written (40 B a carrier), ten planes written
    (25 B a carrier and step); a packed match of every sequence bit at
    every position, and the step's own operations, all int32."""
    match_ops = SYNC_SEQ_BIT_OPS[tol] * SYNC_SEQ_BITS * B * L / 32
    return bound(B * L + 40 * B + 25 * B * steps,
                 match_ops + SYNC_STEP_OPS * B * steps, INT32_OPS)
