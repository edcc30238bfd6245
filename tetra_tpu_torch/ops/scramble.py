"""TETRA scrambling (port of tetra_tpu.ops.scramble), EN 300 392-2 8.2.5.

Reference behaviour: src/lower_mac/tetra_scramb.c — a 32-tap Fibonacci
LFSR whose output keystream is XORed over the block. The keystream is
linear in the 32 initial state bits, so the host precomputes a GF(2)
matrix M[32, n] and any batch of scrambling codes becomes one small
float32 matmul (exact).

Scrambling codes are uint32 values; torch has no general uint32
arithmetic, so they travel as int64 tensors holding [0, 2^32).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from tetra_tpu_torch.constants import SCRAMB_INIT, SCRAMB_TAPS
from tetra_tpu_torch.utils.bits import gf2_matmul

__all__ = ["keystream_matrix", "keystream_np", "keystream", "scramb_bits",
           "scramb_get_init", "init_to_bits"]


def scramb_get_init(mcc: int, mnc: int, colour: int) -> int:
    """Cell scrambling code (reference src/lower_mac/tetra_scramb.c:87-99)."""
    mcc &= 0x3FF
    mnc &= 0x3FFF
    colour &= 0x3F
    return ((colour | (mnc << 6) | (mcc << 20)) << 2) | SCRAMB_INIT


@functools.lru_cache(maxsize=8)
def keystream_matrix(n: int) -> np.ndarray:
    """M[32, n] over GF(2): keystream = state_bits @ M (state bit j =
    bit j of the uint32 LFSR state, LSB first)."""
    masks = np.left_shift(np.uint64(1), np.arange(32, dtype=np.uint64))
    out = np.zeros((32, n), dtype=np.uint8)
    for i in range(n):
        fb = np.uint64(0)
        for y in SCRAMB_TAPS:
            fb ^= masks[32 - y]
        for j in range(32):
            if fb >> np.uint64(j) & np.uint64(1):
                out[j, i] = 1
        masks[:31] = masks[1:]
        masks[31] = fb
    return out


def keystream_np(init: int, n: int) -> np.ndarray:
    """Host-side keystream for a concrete init (numpy, for tables)."""
    state_bits = np.array([(init >> j) & 1 for j in range(32)], dtype=np.uint8)
    return (state_bits @ keystream_matrix(n)) % 2


@functools.lru_cache(maxsize=16)
def _matrix_on(n: int, device: torch.device) -> torch.Tensor:
    """keystream_matrix(n) as float32 on `device`, copied there once."""
    return torch.as_tensor(keystream_matrix(n), dtype=torch.float32,
                           device=device)


def init_to_bits(init) -> torch.Tensor:
    """Scrambling codes (int64 [...] holding uint32 values, or an int)
    -> LSB-first 32-bit ubits [..., 32] int8."""
    init = torch.as_tensor(init, dtype=torch.int64)
    sh = torch.arange(32, device=init.device)
    return ((init[..., None] >> sh) & 1).to(torch.int8)


def keystream(init: torch.Tensor, n: int) -> torch.Tensor:
    """Keystream [..., n] int8 for int64 scrambling codes init [...]."""
    return gf2_matmul(init_to_bits(init), _matrix_on(n, init.device))


def scramb_bits(init: torch.Tensor, bits: torch.Tensor) -> torch.Tensor:
    """XOR-apply the keystream over ubits [..., n] (both directions,
    reference tetra_scramb.c:77-85)."""
    return bits.to(torch.int8) ^ keystream(init, bits.shape[-1])
