"""Shortened (30,14) Reed-Muller code of the AACH broadcast block (port
of tetra_tpu.ops.rm3014).

Reference behaviour: src/lower_mac/tetra_rm3014.c — systematic encode
(14 info bits + 16 parity bits from the Section 8.2.3.2 generator) and
a truncating decode. decode(correct=True) adds single-bit correction
through a syndrome table, as tetra_tpu does. GF(2) products are float32
matmuls of 0/1 values (exact: sums stay below 31).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from tetra_tpu_torch.constants import RM3014_GEN
from tetra_tpu_torch.utils.bits import gf2_matmul

__all__ = ["generator_matrix", "encode", "decode", "encode_uint"]


@functools.lru_cache(maxsize=1)
def generator_matrix() -> np.ndarray:
    """[14, 30] systematic generator: identity(14) || RM3014_GEN."""
    return np.concatenate([np.eye(14, dtype=np.uint8), RM3014_GEN], axis=1)


@functools.lru_cache(maxsize=1)
def _parity_check() -> np.ndarray:
    """[30, 16] parity-check matrix H^T: syndrome = cw @ H^T. For the
    systematic G = [I | P], H^T = [[P], [I16]]."""
    return np.concatenate([RM3014_GEN, np.eye(16, dtype=np.uint8)], axis=0)


@functools.lru_cache(maxsize=1)
def _syndrome_table() -> np.ndarray:
    """16-bit syndrome -> position of the single-bit error that gives
    it, -1 for every other syndrome."""
    Ht = _parity_check()
    table = np.full(1 << 16, -1, dtype=np.int32)
    for pos in range(30):
        syn = 0
        for r in range(16):
            if Ht[pos, r]:
                syn |= 1 << (15 - r)
        table[syn] = pos
    return table


def encode(bits14: torch.Tensor) -> torch.Tensor:
    """ubits [..., 14] -> codeword ubits [..., 30] int8."""
    return gf2_matmul(bits14, generator_matrix())


def encode_uint(value: int) -> int:
    """14-bit uint -> 30-bit codeword (reference tetra_rm3014_compute)."""
    bits = np.array([(value >> (13 - i)) & 1 for i in range(14)], np.uint8)
    out = 0
    for b in (bits @ generator_matrix()) % 2:
        out = (out << 1) | int(b)
    return out


def decode(bits30: torch.Tensor, correct: bool = False):
    """codeword ubits [..., 30] -> (info ubits [..., 14], syndrome_ok
    [...] bool). correct=False is the reference's truncation
    (tetra_rm3014.c:92-96) plus an error-detection flag; correct=True
    fixes single-bit errors first."""
    syn_bits = gf2_matmul(bits30, _parity_check())
    ok = (syn_bits == 0).all(dim=-1)
    if correct:
        w = 1 << torch.arange(15, -1, -1, device=bits30.device)
        syn = (syn_bits.to(torch.int64) * w).sum(-1)
        table = torch.as_tensor(_syndrome_table(), device=bits30.device)
        errpos = table[syn].to(torch.int64)
        pos = torch.arange(30, device=bits30.device)
        flip = (pos == errpos[..., None]) & (errpos[..., None] >= 0)
        bits30 = bits30.to(torch.int8) ^ flip.to(torch.int8)
        ok = ok | (errpos >= 0)
    return bits30[..., :14], ok
