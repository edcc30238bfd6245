"""CRC16-CCITT over unpacked bits and the LLC FCS-32 (port of
tetra_tpu.ops.crc).

Reference behaviour: src/lower_mac/crc_simple.c:46-106 (init 0xFFFF,
poly 0x1021, MSB first over unpacked bits; check constant 0x1D0F) and
src/tetra_llc_pdu.c:105-126 (FCS-32). The host versions
(`crc16_bits_np`, `fcs32_np`) back crypto.native's fallbacks and the
receiver's CRC log lines.

The CRC of a fixed-length bit vector is affine over GF(2):
crc(x) = x @ M xor C. The host builds (M, C) once per length; the batch
check is one small float32 matmul (exact: sums stay far below 2^24).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from tetra_tpu_torch.constants import (CRC16_POLY, CRC16_INIT, FCS32_POLY,
                                       TETRA_CRC_OK)

__all__ = ["crc16_matrix", "crc16_check", "crc16_tables", "crc16_bits_np",
           "fcs32_np", "TETRA_CRC_OK"]


def crc16_bits_np(bits) -> int:
    """Host CRC16 of unpacked bits (bit 0 of each element): the register
    of the bit-serial loop, as the XOR of crc16_matrix's rows of the set
    bits (tests/test_torch_tables.py holds it to tetra_tpu's loop)."""
    b = (np.asarray(bits).reshape(-1) & 1) != 0
    M, Cc = crc16_matrix(len(b))
    reg = np.bitwise_xor.reduce(M[b], axis=0) ^ Cc
    return int(reg.astype(np.int64) @ (1 << np.arange(15, -1, -1)))


def fcs32_np(bits) -> int:
    """Host FCS-32 of unpacked bits (reference src/tetra_llc_pdu.c:105-126)."""
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


@functools.lru_cache(maxsize=32)
def crc16_matrix(length: int) -> tuple[np.ndarray, np.ndarray]:
    """(M[length,16], C[16]) with crc_bits = bits @ M xor C (MSB-first crc bits).

    Built by symbolic LFSR propagation: each CRC register bit is tracked
    as a GF(2) linear function of the message bits plus a constant.
    """
    masks = [0] * 16
    consts = [(CRC16_INIT >> (15 - r)) & 1 for r in range(16)]
    for i in range(length):
        masks[0] ^= 1 << i
        top_m, top_c = masks[0], consts[0]
        masks = masks[1:] + [0]
        consts = consts[1:] + [0]
        for r in range(16):
            if (CRC16_POLY >> (15 - r)) & 1:
                masks[r] ^= top_m
                consts[r] ^= top_c
    M = np.zeros((length, 16), dtype=np.uint8)
    for r in range(16):
        for i in range(length):
            if (masks[r] >> i) & 1:
                M[i, r] = 1
    C = np.asarray(consts, dtype=np.uint8)
    return M, C


def crc16_check(bits: torch.Tensor) -> torch.Tensor:
    """True where crc16(bits) == TETRA_CRC_OK (reference
    tetra_lower_mac.c:259); bits [..., L] of 0/1."""
    M, C = crc16_matrix(bits.shape[-1])
    Mt = torch.as_tensor(M, dtype=torch.float32, device=bits.device)
    crc = (bits.to(torch.float32) @ Mt).to(torch.int64) & 1
    crc = crc ^ torch.as_tensor(C.astype(np.int64), device=bits.device)
    w = 1 << torch.arange(15, -1, -1, device=bits.device)
    return (crc * w).sum(-1) == TETRA_CRC_OK


@functools.lru_cache(maxsize=8)
def crc16_tables(n_sym: int, crc_segs: tuple) -> tuple[np.ndarray, np.ndarray]:
    """Per-segment CRC16 check tables over a decoded [n_sym] bit row.

    words[s, t]: the 16-bit row of crc16_matrix for bit t of segment s
    (MSB first; 0 outside the segment), so the segment's CRC register
    is the XOR of words[s, t] over the set bits t, in any order.
    target[s]: C xor TETRA_CRC_OK, the value that XOR must equal."""
    words = np.zeros((len(crc_segs), n_sym), np.int32)
    target = np.zeros(len(crc_segs), np.int32)
    w = 1 << np.arange(15, -1, -1)
    for s, (off, ln) in enumerate(crc_segs):
        M, C = crc16_matrix(ln)
        words[s, off:off + ln] = (M.astype(np.int64) * w).sum(-1)
        target[s] = int((C.astype(np.int64) * w).sum()) ^ TETRA_CRC_OK
    return words, target
