"""Transmit/encode chain (port of tetra_tpu.tx): type-1 -> type-5 bits
-> bursts.

Reference behaviour: the canonical encode path of src/conv_enc_test.c
(build_sb / build_ndb_schf): append the complemented CRC16 and 4 tail
bits, rate-1/4 mother encode, puncture to 2/3, block-interleave,
scramble, then assemble continuous downlink bursts
(src/phy/tetra_burst.c:169-267).

`encode_block` and `encode_bbk` run batched on their input tensors'
device; given numpy bits they run on `device` (the card unless the
caller asks for the CPU). The burst builders return numpy bursts, as in
the JAX package; `make_schf_bursts` builds a batch on the device.
Scrambling codes are ints or int64 tensors holding uint32 values.
"""
from __future__ import annotations

import numpy as np
import torch

from tetra_tpu_torch import constants as C
from tetra_tpu_torch.device import resolve_device
from tetra_tpu_torch.ops import crc, interleave, rcpc, rm3014, scramble
from tetra_tpu_torch.phy import burst as burst_mod

__all__ = ["append_crc_tail", "encode_block", "encode_bbk",
           "make_sync_burst", "make_schf_burst", "make_ndb_burst",
           "make_schf_bursts"]


def _bits(x, device) -> torch.Tensor:
    """Tensor bits stay where they are; others go to `device`."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(np.asarray(x), device=resolve_device(device))


def append_crc_tail(type1: torch.Tensor) -> torch.Tensor:
    """type-1 bits [..., L1] -> type-2 bits [..., L1+20] int8: the
    ones-complement CRC16, MSB first (the reference's swap16 +
    little-endian pbit2ubit round trip is an identity,
    conv_enc_test.c:224-231), and 4 zero tail bits."""
    cbits = crc.crc16_bits(type1) ^ 1
    tail = torch.zeros(type1.shape[:-1] + (4,), dtype=torch.int8,
                       device=type1.device)
    return torch.cat([type1.to(torch.int8), cbits, tail], dim=-1)


def encode_block(kind: str, type1, scramb_init, device=None) -> torch.Tensor:
    """Full encode: type-1 bits [..., L1] -> type-5 bits [..., L345]
    int8. SB1 always uses the BSCH code."""
    type1 = _bits(type1, device)
    n345, n2, n1, ia, _ = C.BLOCK_PARAMS[kind]
    if type1.shape[-1] != n1:
        raise ValueError(f"{kind}: expected {n1} type-1 bits, got "
                         f"{tuple(type1.shape)}")
    type2 = append_crc_tail(type1)
    if type2.shape[-1] != n2:
        raise ValueError(f"{kind} has no CRC16-protected encoding")
    mother = rcpc.conv_encode(type2)
    type3 = rcpc.puncture("2_3", mother, n345)
    type4 = interleave.block_interleave(n345, ia, type3)
    if kind == "SB1":
        scramb_init = C.SCRAMB_INIT
    init = torch.as_tensor(scramb_init, dtype=torch.int64,
                           device=type4.device)
    return scramble.scramb_bits(init, type4)


def encode_bbk(bits14, scramb_init, device=None) -> torch.Tensor:
    """AACH: 14 info bits [..., 14] -> scrambled RM(30,14) codeword
    [..., 30] int8."""
    cw = rm3014.encode(_bits(bits14, device))
    init = torch.as_tensor(scramb_init, dtype=torch.int64, device=cw.device)
    return scramble.scramb_bits(init, cw)


def _np(x: torch.Tensor) -> np.ndarray:
    return x.cpu().numpy()


def make_sync_burst(sync_type1, sysinfo_type1, aach_bits14, scramb_init,
                    device=None) -> np.ndarray:
    """510-bit continuous sync downlink burst from type-1 PDUs (build_sb
    of conv_enc_test.c): SB1 = 60-bit SYNC PDU, SB2 = 124-bit SYSINFO
    PDU, BBK = 14-bit ACCESS-ASSIGN."""
    sb = _np(encode_block("SB1", sync_type1, scramb_init, device))
    si = _np(encode_block("SB2", sysinfo_type1, scramb_init, device))
    bb = _np(encode_bbk(aach_bits14, scramb_init, device))
    return burst_mod.build_sync_c_d_burst(sb, bb, si)


def make_schf_burst(schf_type1, aach_bits14, scramb_init,
                    device=None) -> np.ndarray:
    """510-bit normal downlink burst carrying one SCH/F block and the
    ACCESS-ASSIGN broadcast block (build_ndb_schf of conv_enc_test.c),
    training sequence n."""
    t5 = _np(encode_block("SCH_F", schf_type1, scramb_init, device))
    bb = _np(encode_bbk(aach_bits14, scramb_init, device))
    return burst_mod.build_norm_c_d_burst(t5[:216], bb, t5[216:], False)


def make_ndb_burst(blk1_type1, blk2_type1, aach_bits14, scramb_init,
                   device=None) -> np.ndarray:
    """Normal downlink burst with two half-slot NDB blocks (training
    sequence p)."""
    b1 = _np(encode_block("NDB", blk1_type1, scramb_init, device))
    b2 = _np(encode_block("NDB", blk2_type1, scramb_init, device))
    bb = _np(encode_bbk(aach_bits14, scramb_init, device))
    return burst_mod.build_norm_c_d_burst(b1, bb, b2, True)


def make_schf_bursts(schf_type1, aach_bits14, scramb_init,
                     device=None) -> torch.Tensor:
    """make_schf_burst over a batch, on the device: schf_type1 [N, 268],
    aach_bits14 [N, 14] -> bursts [N, 510] int8."""
    t5 = encode_block("SCH_F", schf_type1, scramb_init, device)
    bb = encode_bbk(_bits(aach_bits14, t5.device), scramb_init)
    return burst_mod.build_norm_c_d_bursts(t5[:, :216], bb, t5[:, 216:],
                                           False)
