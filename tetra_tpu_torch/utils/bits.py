"""Bit-vector helpers (the numpy part of tetra_tpu.utils.bits).

Bits are "ubits": one bit per element (0/1), MSB first, as in the
reference's one-bit-per-byte buffers (src/tetra_common.c:31-39).
"""
from __future__ import annotations

import numpy as np

__all__ = ["bits_to_uint", "pack_bits"]


def bits_to_uint(bits) -> int:
    """MSB-first bits -> unsigned int (reference src/tetra_common.c:31-39)."""
    out = 0
    for b in np.asarray(bits).reshape(-1):
        out = (out << 1) | int(b & 1)
    return out


def pack_bits(bits) -> bytes:
    """ubits -> packed bytes, MSB first (osmo_ubit2pbit semantics)."""
    arr = np.asarray(bits, dtype=np.uint8).reshape(-1)
    pad = (-len(arr)) % 8
    if pad:
        arr = np.concatenate([arr, np.zeros(pad, dtype=np.uint8)])
    return np.packbits(arr).tobytes()
