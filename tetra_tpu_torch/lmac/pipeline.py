"""SB1 block decode (port of the K1 branch of tetra_tpu.lmac.pipeline).

Reference behaviour: src/lower_mac/tetra_lower_mac.c:178-186 — SB1 is
descrambled with the predefined BSCH code, deinterleaved, depunctured,
Viterbi-decoded over 80 steps and CRC16-checked over its first 76 bits.
The port runs it through the assembled-decode kernel K1 (one map, no
restarts, one CRC segment), as the TPU path does
(pipeline.py:64-80).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from tetra_tpu import constants as C
from tetra_tpu_torch.ops import interleave, rcpc, scramble
from tetra_tpu_torch.ops.viterbi_assembled import AssembledCode

__all__ = ["BlockResult", "Sb1Decoder", "decode_block"]


class BlockResult(NamedTuple):
    type1: torch.Tensor    # [..., type1_bits] decoded bits
    crc_ok: torch.Tensor   # [...] bool
    type2: torch.Tensor    # [..., type2_bits] (incl. CRC + tail)


@functools.lru_cache(maxsize=8)
def _fec_matrix(kind: str) -> np.ndarray:
    """Composed deinterleave + depuncture + soft map as ONE one-hot
    matrix: mother = sign(type4) @ P with P[deint[j], punct[j]] = 127."""
    n345, n2, _, ia, _ = C.BLOCK_PARAMS[kind]
    punct = rcpc.puncture_indices("2_3", n345)
    _, deint = interleave.interleave_indices(n345, ia)
    P = np.zeros((n345, n2 * 4), np.float32)
    for j in range(n345):
        P[deint[j], punct[j]] = 127.0
    return P


class Sb1Decoder(nn.Module):
    """SB1 tables: the fixed BSCH keystream and the K1 assembly map."""

    def __init__(self):
        super().__init__()
        n345, n2, n1, _, _ = C.BLOCK_PARAMS["SB1"]
        self.n1 = n1
        self.code = AssembledCode([_fec_matrix("SB1").T], n2, (),
                                  ((0, n1 + 16),))
        ks = scramble.keystream_np(C.SCRAMB_INIT, n345).astype(np.int8)
        self.register_buffer("ks", torch.tensor(ks))

    def forward(self, type5: torch.Tensor) -> BlockResult:
        batch = type5.shape[:-1]
        N = int(np.prod(batch)) if batch else 1
        type4 = type5.reshape(N, type5.shape[-1]).to(torch.int8) ^ self.ks
        sgn = (1 - 2 * type4).to(torch.int8)
        tab = torch.zeros(N, dtype=torch.int32, device=sgn.device)
        rmask = torch.zeros((N, 0), dtype=torch.int8, device=sgn.device)
        bits, ok = self.code(sgn, tab, rmask)
        type2 = bits.reshape(*batch, bits.shape[-1])
        return BlockResult(type2[..., :self.n1],
                           (ok[:, 0] != 0).reshape(batch), type2)


@functools.lru_cache(maxsize=4)
def _sb1_decoder(device: torch.device) -> Sb1Decoder:
    return Sb1Decoder().to(device)


def decode_block(kind: str, type5: torch.Tensor) -> BlockResult:
    """Decode CRC16-protected blocks of `kind` [..., 120]. Only SB1 is
    on the ported path (it always uses the BSCH scrambling code,
    tetra_lower_mac.c:178-186)."""
    if kind != "SB1":
        raise NotImplementedError(f"decode_block({kind!r}) is not ported")
    return _sb1_decoder(type5.device)(type5)
