"""Block interleaving (port of tetra_tpu.ops.interleave), EN 300 392-2
Section 8.2.4.1, and the speech matrix interleaver's permutation.

Reference behaviour: src/lower_mac/tetra_interleave.c:36-59 — the
permutation k = 1 + (a*i mod K), applied as one batched gather.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["interleave_indices", "block_interleave", "block_deinterleave",
           "matrix_interleave_indices"]


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


@functools.lru_cache(maxsize=32)
def _gather_on(K: int, a: int, which: int,
               device: torch.device) -> torch.Tensor:
    return torch.as_tensor(interleave_indices(K, a)[which],
                           dtype=torch.int64, device=device)


def block_interleave(K: int, a: int, bits: torch.Tensor) -> torch.Tensor:
    """type-3 -> type-4 over ubits or soft values [..., K]."""
    return bits[..., _gather_on(K, a, 0, bits.device)]


def block_deinterleave(K: int, a: int, bits: torch.Tensor) -> torch.Tensor:
    """type-4 -> type-3 over ubits or soft values [..., K]."""
    return bits[..., _gather_on(K, a, 1, bits.device)]


@functools.lru_cache(maxsize=8)
def matrix_interleave_indices(lines: int, columns: int) -> np.ndarray:
    """Matrix (row-in, column-out) interleaver, EN 300 395-2 Section 5.5.3:
    out[i*lines + j] = in[j*columns + i] (the spec's permutation; the
    reference's tetra_interleave.c:62-82 is buggy and unused)."""
    j, i = np.meshgrid(np.arange(lines), np.arange(columns))
    return (j * columns + i).reshape(-1).astype(np.int32)
