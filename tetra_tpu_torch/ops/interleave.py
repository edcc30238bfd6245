"""Block interleaver index maps (port of tetra_tpu.ops.interleave tables).

Reference behaviour: src/lower_mac/tetra_interleave.c:36-59 — the
permutation k = 1 + (a*i mod K).
"""
from __future__ import annotations

import functools

import numpy as np

__all__ = ["interleave_indices"]


@functools.lru_cache(maxsize=16)
def interleave_indices(K: int, a: int) -> tuple[np.ndarray, np.ndarray]:
    """(gather_interleave, gather_deinterleave) index arrays of length K.

    k(i) = 1 + (a*i) % K maps input position i-1 -> output position k-1.
    """
    i = np.arange(1, K + 1, dtype=np.int64)
    k = 1 + (a * i) % K
    deint = (k - 1).astype(np.int32)
    intl = np.empty(K, dtype=np.int32)
    intl[k - 1] = i - 1
    return intl, deint
