"""Lower-MAC block decode (port of tetra_tpu.lmac.pipeline).

Reference behaviour: src/lower_mac/tetra_lower_mac.c:143-357 — per
block: descramble, deinterleave, depuncture, Viterbi, CRC16, with the
block parameters of tetra_lower_mac.c:55-102. Every CRC-protected kind
(SB1, SB2, NDB, SCH_HU, SCH_F) has an n2 that is a multiple of 4, so
each runs through the assembled-decode kernel K1 in one pass (one
assembly map, no restarts, one CRC segment over n1 + 16 bits), as the
TPU path does (pipeline.py:64-80). Descrambling is a per-row XOR with
the keystream of the row's scrambling code; SB1 always uses the BSCH
code (tetra_lower_mac.c:178-186).

Whole sync and normal bursts decode as a unit (decode_sync_burst,
decode_ndb_burst, decode_schf_burst), mirroring the tp_sap_udata_ind
calls of tetra_burst.c:346-372. Scrambling codes are int64 tensors
holding uint32 values; they broadcast against the block batch.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from tetra_tpu_torch import constants as C
from tetra_tpu_torch.ops import interleave, rcpc, rm3014, scramble
from tetra_tpu_torch.ops.viterbi_assembled import AssembledCode
from tetra_tpu_torch.phy import burst as burst_mod

__all__ = ["BlockResult", "BlockDecoder", "decode_block", "decode_bbk",
           "decode_sync_burst", "decode_ndb_burst", "decode_schf_burst",
           "sb1_sync_fields"]


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


class BlockDecoder(nn.Module):
    """K1 assembly code of one CRC16-protected block kind; SB1's also
    holds the fixed BSCH keystream (tetra_lower_mac.c:178-186)."""

    def __init__(self, kind: str):
        super().__init__()
        n345, n2, n1, _, _ = C.BLOCK_PARAMS[kind]
        self.n345, self.n1 = n345, n1
        self.code = AssembledCode([_fec_matrix(kind).T], n2, (),
                                  ((0, n1 + 16),))
        if kind == "SB1":
            ks = scramble.keystream_np(C.SCRAMB_INIT, n345).astype(np.int8)
            self.register_buffer("ks_bsch", torch.tensor(ks))

    def forward(self, type4: torch.Tensor) -> BlockResult:
        """Descrambled type-4 bits [..., n345] -> decoded block."""
        batch = type4.shape[:-1]
        N = int(np.prod(batch)) if batch else 1
        sgn = (1 - 2 * type4.reshape(N, self.n345).to(torch.int8)) \
            .to(torch.int8)
        tab = torch.zeros(N, dtype=torch.int32, device=sgn.device)
        rmask = torch.zeros((N, 0), dtype=torch.int8, device=sgn.device)
        bits, ok = self.code(sgn.contiguous(), tab, rmask)
        type2 = bits.reshape(*batch, bits.shape[-1])
        return BlockResult(type2[..., :self.n1],
                           (ok[:, 0] != 0).reshape(batch), type2)


@functools.lru_cache(maxsize=16)
def _block_decoder(kind: str, device: torch.device) -> BlockDecoder:
    return BlockDecoder(kind).to(device)


def _inits(scramb_init, device) -> torch.Tensor:
    return torch.as_tensor(scramb_init, dtype=torch.int64, device=device)


def _decode_fec(kind: str, type5: torch.Tensor, scramb_init) -> BlockResult:
    """Shared FEC slice of the CRC-protected kinds: descramble with the
    (broadcast) scrambling codes, or SB1's BSCH keystream, then K1."""
    n345 = C.BLOCK_PARAMS[kind][0]
    if type5.shape[-1] != n345:
        raise ValueError(f"{kind}: expected {n345} bits, got "
                         f"{tuple(type5.shape)}")
    dec = _block_decoder(kind, type5.device)
    if kind == "SB1":
        type4 = type5.to(torch.int8) ^ dec.ks_bsch
    else:
        type4 = scramble.scramb_bits(_inits(scramb_init, type5.device),
                                     type5)
    return dec(type4)


def decode_block(kind: str, type5: torch.Tensor, scramb_init) -> BlockResult:
    """Decode one CRC16-protected block kind (SB1, SB2, NDB, SCH_HU,
    SCH_F) from type-5 bits [..., n345]; scramb_init (int64, broadcast
    against the batch) is ignored for SB1, which always uses the BSCH
    code (tetra_lower_mac.c:178-186)."""
    return _decode_fec(kind, type5, scramb_init)


def decode_bbk(type5: torch.Tensor, scramb_init,
               reference_mode: bool = True) -> BlockResult:
    """AACH broadcast block: descramble + RM(30,14).

    reference_mode=True mirrors tetra_lower_mac.c:268-271 (copy-through
    of the systematic bits, crc_ok always true); False adds the parity
    check and single-bit correction."""
    type4 = scramble.scramb_bits(_inits(scramb_init, type5.device), type5)
    if reference_mode:
        info = type4[..., :14]
        ok = torch.ones(type4.shape[:-1], dtype=torch.bool,
                        device=type4.device)
    else:
        info, ok = rm3014.decode(type4, correct=True)
    return BlockResult(info, ok, type4)


def decode_sync_burst(bursts: torch.Tensor, scramb_init) -> dict:
    """Sync bursts [..., 510] -> {"SB1", "BBK", "SB2"} BlockResults
    (tetra_burst.c:346-352)."""
    sb1_t5, bbk_t5, sb2_t5 = burst_mod.split_sync_burst(bursts)
    return {
        "SB1": _decode_fec("SB1", sb1_t5, None),
        "BBK": decode_bbk(bbk_t5, scramb_init),
        "SB2": _decode_fec("SB2", sb2_t5, scramb_init),
    }


def decode_ndb_burst(bursts: torch.Tensor, scramb_init) -> dict:
    """Normal bursts with two half-slot blocks (training sequence p) ->
    {"BBK", "NDB1", "NDB2"} (tetra_burst.c:354-361)."""
    bbk_t5, blk1_t5, blk2_t5 = burst_mod.split_norm_burst(bursts)
    return {
        "BBK": decode_bbk(bbk_t5, scramb_init),
        "NDB1": _decode_fec("NDB", blk1_t5, scramb_init),
        "NDB2": _decode_fec("NDB", blk2_t5, scramb_init),
    }


def decode_schf_burst(bursts: torch.Tensor, scramb_init) -> dict:
    """Normal bursts carrying one full-slot SCH/F block (training
    sequence n) -> {"BBK", "SCH_F"} (tetra_burst.c:362-372)."""
    bbk_t5, blk1_t5, blk2_t5 = burst_mod.split_norm_burst(bursts)
    return {
        "BBK": decode_bbk(bbk_t5, scramb_init),
        "SCH_F": _decode_fec("SCH_F", torch.cat([blk1_t5, blk2_t5], dim=-1),
                             scramb_init),
    }


def sb1_sync_fields(type1: torch.Tensor) -> dict:
    """SYNC PDU fields of SB1 type-1 bits [..., 60] as int64 tensors
    (offsets of tetra_lower_mac.c:283-310), including the cell
    scrambling code of the following blocks (tetra_lower_mac.c:303)."""
    def u(lo, n):
        b = type1[..., lo:lo + n].to(torch.int64)
        w = 1 << torch.arange(n - 1, -1, -1, device=type1.device)
        return (b * w).sum(-1)

    cc = u(4, 6)
    mcc = u(31, 10)
    mnc = u(41, 14)
    return {
        "system_code": u(0, 4),
        "colour_code": cc,
        "tn": u(10, 2) + 1,
        "fn": u(12, 5),
        "mn": u(17, 6),
        "sharing_mode": u(23, 2),
        "ts_reserved": u(25, 3),
        "mcc": mcc,
        "mnc": mnc,
        "scramb_init": (((mcc << 20) | (mnc << 6) | cc) << 2)
        | C.SCRAMB_INIT,
    }
