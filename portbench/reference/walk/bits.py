"""Bit helpers of the reference walk (copies of the port's
utils.bits.bits_to_uint / pack_bits and ops.crc.fcs32_np)."""
from __future__ import annotations

import numpy as np

FCS32_POLY = 0x04C11DB7


def bits_to_uint(bits) -> int:
    """MSB-first bits -> unsigned int."""
    out = 0
    for b in np.asarray(bits).reshape(-1):
        out = (out << 1) | int(b & 1)
    return out


def pack_bits(bits) -> bytes:
    """ubits -> packed bytes, MSB first."""
    arr = np.asarray(bits, dtype=np.uint8).reshape(-1)
    pad = (-len(arr)) % 8
    if pad:
        arr = np.concatenate([arr, np.zeros(pad, dtype=np.uint8)])
    return np.packbits(arr).tobytes()


def fcs32_np(bits) -> int:
    """LLC FCS-32 of unpacked bits (reference src/tetra_llc_pdu.c:105-126)."""
    bits = np.asarray(bits).reshape(-1)
    n = len(bits)
    crc = 0xFFFFFFFF
    if n < 32:
        crc = (crc << (32 - n)) & 0xFFFFFFFF
    for b in bits:
        bit = (int(b) ^ (crc >> 31)) & 1
        crc = (crc << 1) & 0xFFFFFFFF
        if bit:
            crc ^= FCS32_POLY
    return crc ^ 0xFFFFFFFF
