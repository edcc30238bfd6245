"""Bit-vector helpers (port of tetra_tpu.utils.bits).

Bits are "ubits": one bit per element (0/1), MSB first, as in the
reference's one-bit-per-byte buffers (src/tetra_common.c:31-39). The
numpy helpers are the JAX package's; `gf2_matmul` is the batched GF(2)
product on tensors.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["bits_to_uint", "uint_to_bits", "pack_bits", "unpack_bits",
           "gf2_matmul"]


def bits_to_uint(bits) -> int:
    """MSB-first bits -> unsigned int (reference src/tetra_common.c:31-39)."""
    out = 0
    for b in np.asarray(bits).reshape(-1):
        out = (out << 1) | int(b & 1)
    return out


def uint_to_bits(value: int, width: int) -> np.ndarray:
    """Unsigned int -> MSB-first ubit array of length `width`."""
    return np.array([(value >> (width - 1 - i)) & 1 for i in range(width)], dtype=np.uint8)


def pack_bits(bits) -> bytes:
    """ubits -> packed bytes, MSB first (osmo_ubit2pbit semantics)."""
    arr = np.asarray(bits, dtype=np.uint8).reshape(-1)
    pad = (-len(arr)) % 8
    if pad:
        arr = np.concatenate([arr, np.zeros(pad, dtype=np.uint8)])
    return np.packbits(arr).tobytes()


def unpack_bits(data: bytes, nbits: int | None = None) -> np.ndarray:
    """packed bytes -> ubits, MSB first (osmo_pbit2ubit semantics)."""
    arr = np.unpackbits(np.frombuffer(data, dtype=np.uint8))
    return arr[:nbits] if nbits is not None else arr


def gf2_matmul(bits: torch.Tensor, matrix) -> torch.Tensor:
    """GF(2) product of ubits [..., L] with a 0/1 matrix [L, M] (numpy or
    tensor) -> int8 [..., M]: one float32 matmul (exact: the sums stay
    below L < 2^24) and a parity."""
    m = torch.as_tensor(matrix, dtype=torch.float32, device=bits.device)
    return ((bits.to(torch.float32) @ m).to(torch.int64) & 1).to(torch.int8)
