"""LLC PDU parsing + FCS-32, EN 300 392-2 clause 21.2.

Frozen copy of the port's copy of tetra_tpu.llc.llc_pdu (the benchmark's
reference: it imports nothing of the program). The port's copy is
held to the JAX package's original by the port's CPU tests.

Reference behaviour: src/tetra_llc_pdu.c — 16 PDU types (Table 21.1),
per-type bit parsing with N(R)/N(S)/S(S), a min-length guard table, and
the bitwise FCS-32 with short-frame shift.
"""
from __future__ import annotations

from dataclasses import dataclass
from enum import IntEnum

import numpy as np

from portbench.reference.walk.bits import bits_to_uint
from portbench.reference.walk.bits import fcs32_np

__all__ = ["LlcPduType", "LlcPduDec", "LlcPdu", "parse_llc_pdu", "PDU_DEC_NAMES"]


class LlcPduType(IntEnum):
    """Table 21.1 (reference tetra_llc_pdu.h:9-26)."""
    BL_ADATA = 0
    BL_DATA = 1
    BL_UDATA = 2
    BL_ACK = 3
    BL_ADATA_FCS = 4
    BL_DATA_FCS = 5
    BL_UDATA_FCS = 6
    BL_ACK_FCS = 7
    AL_SETUP = 8
    AL_DATA_FINAL = 9
    AL_UDATA_UFINAL = 10
    AL_ACK_RNR = 11
    AL_RECONNECT = 12
    SUPPL = 13
    L2SIG = 14
    AL_DISC = 15


class LlcPduDec(IntEnum):
    """Decoded PDU kinds (reference tetra_llc_pdu.h:50-70)."""
    UNKNOWN = 0
    BL_ADATA = 1
    BL_DATA = 2
    BL_UDATA = 3
    BL_ACK = 4
    AL_SETUP = 5
    AL_DATA = 6
    AL_FINAL = 7
    AL_UDATA = 8
    AL_UFINAL = 9
    AL_ACK = 10
    AL_RNR = 11
    AL_RECONNECT = 12
    AL_DISC = 13
    ALX_DATA = 14
    ALX_FINAL = 15
    ALX_UDATA = 16
    ALX_UFINAL = 17
    ALX_ACK = 18
    ALX_RNR = 19


PDU_DEC_NAMES = {
    LlcPduDec.BL_ADATA: "BL-ADATA", LlcPduDec.BL_DATA: "BL-DATA",
    LlcPduDec.BL_UDATA: "BL-UDATA", LlcPduDec.BL_ACK: "BL-ACK",
    LlcPduDec.AL_SETUP: "AL-SETUP", LlcPduDec.AL_DATA: "AL-DATA",
    LlcPduDec.AL_FINAL: "AL-FINAL", LlcPduDec.AL_UDATA: "AL-UDATA",
    LlcPduDec.AL_UFINAL: "AL-UFINAL", LlcPduDec.AL_ACK: "AL-ACK",
    LlcPduDec.AL_RNR: "AL-RNR", LlcPduDec.AL_RECONNECT: "AL-RECONNECT",
    LlcPduDec.AL_DISC: "AL-DISC", LlcPduDec.ALX_DATA: "ALX-DATA",
    LlcPduDec.ALX_FINAL: "ALX-FINAL", LlcPduDec.ALX_UDATA: "ALX-UDATA",
    LlcPduDec.ALX_UFINAL: "ALX-UFINAL", LlcPduDec.ALX_ACK: "ALX-ACK",
    LlcPduDec.ALX_RNR: "ALX-RNR", LlcPduDec.UNKNOWN: "UNKNOWN",
}

# minimum parseable length per type (reference tetra_llc_pdu.c:86-103)
MIN_LENGTHS = (6, 5, 4, 5, 6 + 32, 5 + 32, 4 + 32, 5 + 32,
               0, 13, 17, 1, 0, 0, 0, 0)


@dataclass
class LlcPdu:
    pdu_type: LlcPduDec = LlcPduDec.UNKNOWN
    nr: int = 0
    ns: int = 0
    ss: int = 0
    have_fcs: bool = False
    fcs: int = 0
    fcs_invalid: bool = False
    tl_sdu_offset: int = 0     # offset into the input bit buffer
    tl_sdu_len: int = 0        # in bits


def parse_llc_pdu(bits, length: int | None = None) -> LlcPdu:
    """Parse an LLC PDU from ubits (reference tetra_llc_pdu.c:128-307)."""
    bits = np.asarray(bits).astype(np.uint8)
    n = length if length is not None else len(bits)
    lpp = LlcPdu()
    pt = bits_to_uint(bits[0:4])
    pos = 4
    if n < MIN_LENGTHS[pt]:
        lpp.tl_sdu_len = 0
        return lpp

    def fcs_tail(payload_start):
        lpp.tl_sdu_len -= 32
        lpp.have_fcs = True
        lpp.fcs = bits_to_uint(bits[n - 32:n])
        computed = fcs32_np(bits[payload_start:payload_start + lpp.tl_sdu_len])
        lpp.fcs_invalid = computed != lpp.fcs

    if pt in (LlcPduType.BL_ADATA, LlcPduType.BL_ADATA_FCS):
        lpp.nr = int(bits[pos]); pos += 1
        lpp.ns = int(bits[pos]); pos += 1
        lpp.tl_sdu_offset, lpp.tl_sdu_len = pos, n - pos
        lpp.pdu_type = LlcPduDec.BL_ADATA
        if pt == LlcPduType.BL_ADATA_FCS:
            fcs_tail(pos)
    elif pt in (LlcPduType.BL_DATA, LlcPduType.BL_DATA_FCS):
        lpp.ns = int(bits[pos]); pos += 1
        lpp.tl_sdu_offset, lpp.tl_sdu_len = pos, n - pos
        lpp.pdu_type = LlcPduDec.BL_DATA
        if pt == LlcPduType.BL_DATA_FCS:
            fcs_tail(pos)
    elif pt in (LlcPduType.BL_UDATA, LlcPduType.BL_UDATA_FCS):
        lpp.tl_sdu_offset, lpp.tl_sdu_len = pos, n - pos
        lpp.pdu_type = LlcPduDec.BL_UDATA
        if pt == LlcPduType.BL_UDATA_FCS:
            fcs_tail(pos)
    elif pt in (LlcPduType.BL_ACK, LlcPduType.BL_ACK_FCS):
        lpp.nr = int(bits[pos]); pos += 1
        lpp.tl_sdu_offset, lpp.tl_sdu_len = pos, n - pos
        lpp.pdu_type = LlcPduDec.BL_ACK
        if pt == LlcPduType.BL_ACK_FCS:
            fcs_tail(pos)
    elif pt == LlcPduType.AL_SETUP:
        lpp.pdu_type = LlcPduDec.AL_SETUP
        lpp.tl_sdu_offset, lpp.tl_sdu_len = pos, 0
    elif pt == LlcPduType.AL_DATA_FINAL:
        final = int(bits[pos]); pos += 1
        pos += 1  # AR flag (final) / reserved (data)
        lpp.ns = bits_to_uint(bits[pos:pos + 3]); pos += 3
        lpp.ss = bits_to_uint(bits[pos:pos + 8]); pos += 8
        lpp.tl_sdu_offset, lpp.tl_sdu_len = pos, n - pos
        if final:
            lpp.pdu_type = LlcPduDec.AL_FINAL
            lpp.have_fcs = True  # FCS checked after defragmentation
        else:
            lpp.pdu_type = LlcPduDec.AL_DATA
    elif pt == LlcPduType.AL_UDATA_UFINAL:
        ufinal = int(bits[pos]); pos += 1
        lpp.ns = bits_to_uint(bits[pos:pos + 8]); pos += 8
        lpp.ss = bits_to_uint(bits[pos:pos + 8]); pos += 8
        lpp.tl_sdu_offset, lpp.tl_sdu_len = pos, n - pos
        if ufinal:
            lpp.pdu_type = LlcPduDec.AL_UFINAL
            lpp.have_fcs = True
        else:
            lpp.pdu_type = LlcPduDec.AL_UDATA
    elif pt == LlcPduType.AL_ACK_RNR:
        ack = int(bits[pos]); pos += 1
        lpp.pdu_type = LlcPduDec.AL_ACK if ack else LlcPduDec.AL_RNR
        lpp.tl_sdu_offset, lpp.tl_sdu_len = pos, 0
    elif pt == LlcPduType.AL_RECONNECT:
        lpp.pdu_type = LlcPduDec.AL_RECONNECT
        lpp.tl_sdu_offset, lpp.tl_sdu_len = pos, 0
    elif pt == LlcPduType.AL_DISC:
        lpp.pdu_type = LlcPduDec.AL_DISC
        lpp.tl_sdu_offset, lpp.tl_sdu_len = pos, 0
    else:  # SUPPL / L2SIG unimplemented (like the reference)
        lpp.pdu_type = LlcPduDec.UNKNOWN
        lpp.tl_sdu_offset, lpp.tl_sdu_len = pos, 0

    if n < pos:  # truncated PDU guard (tetra_llc_pdu.c:300-304)
        lpp.tl_sdu_len = 0
    return lpp
