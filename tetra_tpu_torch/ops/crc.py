"""CRC16-CCITT over unpacked bits and the LLC FCS-32 (port of
tetra_tpu.ops.crc).

Reference behaviour: src/lower_mac/crc_simple.c:46-106 (init 0xFFFF,
poly 0x1021, MSB first over unpacked bits; check constant 0x1D0F) and
src/tetra_llc_pdu.c:105-126 (FCS-32). The host versions
(`crc16_bits_np`, `fcs32_np`) back crypto.native's fallbacks and the
receiver's CRC log lines; the batched ones (`crc16_bits`, `crc16_value`,
`fcs32`) serve the transmitter.

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
from tetra_tpu_torch.utils.bits import gf2_matmul

__all__ = ["crc16_matrix", "crc16_bits", "crc16_value", "crc16_check",
           "crc16_tables", "crc16_bits_np", "fcs32_np", "fcs32_matrix",
           "fcs32", "TETRA_CRC_OK"]


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


@functools.lru_cache(maxsize=64)
def _affine_on(name: str, length: int, device: torch.device):
    """(M float32 [length, n], C int8 [n]) of crc16_matrix or
    fcs32_matrix on `device`, copied there once."""
    M, Cc = {"crc16": crc16_matrix, "fcs32": fcs32_matrix}[name](length)
    return (torch.as_tensor(M, dtype=torch.float32, device=device),
            torch.as_tensor(Cc.astype(np.int8), device=device))


def _affine_bits(name: str, bits: torch.Tensor) -> torch.Tensor:
    """bits [..., L] @ M xor C over GF(2) -> int8 [..., n]."""
    M, Cc = _affine_on(name, bits.shape[-1], bits.device)
    return gf2_matmul(bits, M) ^ Cc


def crc16_bits(bits: torch.Tensor) -> torch.Tensor:
    """Batched CRC16 over ubits [..., L] -> crc bits [..., 16] int8 (MSB
    first)."""
    return _affine_bits("crc16", bits)


def crc16_value(bits: torch.Tensor) -> torch.Tensor:
    """Batched CRC16 -> int64 value [...]."""
    w = 1 << torch.arange(15, -1, -1, device=bits.device)
    return (crc16_bits(bits).to(torch.int64) * w).sum(-1)


def crc16_check(bits: torch.Tensor) -> torch.Tensor:
    """True where crc16(bits) == TETRA_CRC_OK (reference
    tetra_lower_mac.c:259); bits [..., L] of 0/1."""
    return crc16_value(bits) == TETRA_CRC_OK


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


@functools.lru_cache(maxsize=32)
def fcs32_matrix(length: int) -> tuple[np.ndarray, np.ndarray]:
    """(M[length,32], C[32]) with fcs_bits = bits @ M xor C, MSB-first
    (the register of fcs32_np, final complement in C)."""
    masks = [0] * 32
    init = 0xFFFFFFFF
    if length < 32:
        init = (init << (32 - length)) & 0xFFFFFFFF
    consts = [(init >> (31 - r)) & 1 for r in range(32)]
    for i in range(length):
        top_m = masks[0] ^ (1 << i)   # bit = x_i xor crc_msb
        top_c = consts[0]
        masks = masks[1:] + [0]
        consts = consts[1:] + [0]
        for r in range(32):
            if (FCS32_POLY >> (31 - r)) & 1:
                masks[r] ^= top_m
                consts[r] ^= top_c
    consts = [c ^ 1 for c in consts]
    M = np.zeros((length, 32), dtype=np.uint8)
    for r in range(32):
        for i in range(length):
            if (masks[r] >> i) & 1:
                M[i, r] = 1
    return M, np.asarray(consts, dtype=np.uint8)


def fcs32(bits: torch.Tensor) -> torch.Tensor:
    """Batched FCS-32 over ubits [..., L] -> fcs bits [..., 32] int8
    (MSB first)."""
    return _affine_bits("fcs32", bits)
