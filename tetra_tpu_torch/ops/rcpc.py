"""RCPC puncturing index maps (port of tetra_tpu.ops.rcpc tables).

Reference behaviour: src/lower_mac/tetra_conv_enc.c:196-248.
"""
from __future__ import annotations

import functools

import numpy as np

from tetra_tpu.constants import PUNCT_SCHEMES

__all__ = ["puncture_indices"]


@functools.lru_cache(maxsize=32)
def puncture_indices(scheme: str, type3_len: int) -> np.ndarray:
    """k-indices (0-based into the mother sequence) for j = 1..type3_len.

    Implements k = period*((i-1)/t) + P[i - t*((i-1)/t)] with i = i_func(j)
    (reference src/lower_mac/tetra_conv_enc.c:196-248).
    """
    P, t, period, ifunc = PUNCT_SCHEMES[scheme]
    P = np.asarray(P, dtype=np.int64)
    j = np.arange(1, type3_len + 1, dtype=np.int64)
    if ifunc == "eq":
        i = j
    elif ifunc == "292":
        i = j + (j - 1) // 65
    elif ifunc == "148":
        i = j + (j - 1) // 35
    else:
        raise ValueError(ifunc)
    q = (i - 1) // t
    k = period * q + P[i - t * q]
    return (k - 1).astype(np.int32)
