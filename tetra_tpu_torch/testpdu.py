"""Synthetic test PDU construction (a copy of tetra_tpu.testpdu, numpy
only; tests/test_torch_tables.py holds its code equal to the original).

Mirrors the role of the reference's src/testpdu.c: bit-exact SYNC /
SYSINFO / ACCESS-ASSIGN / MAC-RESOURCE PDUs for loopback and end-to-end
tests, and whole downlink capture streams.
"""
from __future__ import annotations

import numpy as np

from tetra_tpu_torch import constants as C
from tetra_tpu_torch.utils.bits import uint_to_bits


class BitBuilder:
    def __init__(self):
        self.bits: list[int] = []

    def u(self, value: int, width: int) -> "BitBuilder":
        self.bits.extend(int(b) for b in uint_to_bits(value, width))
        return self

    def raw(self, bits) -> "BitBuilder":
        self.bits.extend(int(b) for b in np.asarray(bits).reshape(-1))
        return self

    def pad_to(self, n: int, value: int = 0) -> "BitBuilder":
        while len(self.bits) < n:
            self.bits.append(value)
        return self

    def array(self, n: int | None = None) -> np.ndarray:
        out = np.asarray(self.bits, dtype=np.int8)
        if n is not None:
            assert len(out) == n, (len(out), n)
        return out


def make_sync_pdu(cc=1, tn=1, fn=1, mn=1, mcc=262, mnc=42) -> np.ndarray:
    """60-bit SYNC PDU, Table 21.73 (reference testpdu.c:40-62)."""
    return (BitBuilder()
            .u(0, 4)            # system code
            .u(cc, 6)           # colour code
            .u(tn - 1, 2)       # timeslot number
            .u(fn, 5)           # frame number
            .u(mn, 6)           # multiframe number
            .u(0, 2)            # sharing mode
            .u(0, 3)            # TS reserved frames
            .u(0, 1)            # DTX
            .u(0, 1)            # frame 18 extension
            .u(0, 1)            # reserved
            .u(mcc, 10)         # D-MLE-SYNC: MCC
            .u(mnc, 14)         # MNC
            .u(0, 2)            # neighbour cell broadcast
            .u(0, 2)            # cell service level
            .u(0, 1)            # late entry
            .array(60))


def make_sysinfo_pdu(main_carrier=3710, freq_band=3, la=1234,
                     subscr_class=0xFFFF, service_details=0x865,
                     hyperframe=0, cck_id=None) -> np.ndarray:
    """124-bit SYSINFO PDU (reference testpdu.c:64-89).

    `cck_id` not None flips the hyperframe/CCK flag so the 16-bit field
    carries the common-cipher-key id instead of the hyperframe number
    (reference macpdu_decode_sysinfo cck_valid_no_hf)."""
    return (BitBuilder()
            .u(2, 2)            # MAC PDU type: broadcast
            .u(0, 2)            # SYSINFO PDU
            .u(main_carrier, 12)
            .u(freq_band, 4)
            .u(0, 2)            # offset
            .u(0, 3)            # duplex spacing
            .u(0, 1)            # reverse operation
            .u(0, 2)            # number of CSCH
            .u(1, 3)            # MS_TXPWR_MAX_CELL
            .u(0, 4)            # RXLEV_ACCESS_MIN
            .u(0, 4)            # ACCESS_PARAMETER
            .u(0, 4)            # RADIO_DOWNLINK_TIMEOUT
            .u(0 if cck_id is None else 1, 1)   # CCK id / hyperframe flag
            .u(hyperframe if cck_id is None else cck_id, 16)
            .u(0, 2)            # optional field: even multiframe
            .u(0, 20)           # TS_COMMON_FRAMES
            .u(la, 14)          # D-MLE-SYSINFO: location area
            .u(subscr_class, 16)
            .u(service_details, 12)
            .array(124))


def make_access_assign_bits(hdr=0, f1=0, f2=0) -> np.ndarray:
    """14-bit ACCESS-ASSIGN (reference testpdu.c:91-98)."""
    return BitBuilder().u(hdr, 2).u(f1, 6).u(f2, 6).array(14)


def make_bl_udata(payload_bits) -> np.ndarray:
    """BL-UDATA LLC PDU: type 2 + TL-SDU."""
    return BitBuilder().u(2, 4).raw(payload_bits).array()


def make_mle_cmce_dsetup() -> np.ndarray:
    """Minimal CMCE D-SETUP TL-SDU (pdisc 2, pdut 7 per the zero-based
    14.8.28 table, reference tetra_cmce_pdu.h:15) + filler."""
    return BitBuilder().u(2, 3).u(7, 5).u(0xAB, 8).u(0xCD, 8).array()


def make_resource_pdu(ssi=0x123456, sdu_bits=None, total_len=268,
                      fill=True) -> np.ndarray:
    """MAC-RESOURCE with SSI address carrying `sdu_bits`, padded with a
    null PDU / fill bits to `total_len` (the SCH/F type-1 size).

    Layout per 21.4.3.1 (reference tetra_mac_pdu.c:183-247).
    """
    sdu_bits = np.asarray(sdu_bits if sdu_bits is not None else [], dtype=np.int8)
    hdr = (BitBuilder()
           .u(0, 2)     # MAC PDU type: RESOURCE
           .u(1 if fill else 0, 1)  # fill bit indication
           .u(0, 1)     # grant position
           .u(0, 2)     # encryption mode
           .u(0, 1)     # random access flag
           )
    # header continues: length (6), addr type (3), ssi (24), power (1),
    # slot granting (1), chan alloc (1)
    fixed_after_len = 3 + 24 + 1 + 1 + 1
    hdr_bits = len(hdr.bits) + 6 + fixed_after_len
    body_len = hdr_bits + len(sdu_bits)
    # length indicator counts octets; round up and pad with fill bits
    li = (body_len + 7) // 8
    pdu_len = li * 8
    assert li <= 0x12, "use extended length encoding for larger PDUs"
    out = (hdr.u(li, 6)
           .u(1, 3)         # addr type SSI
           .u(ssi, 24)
           .u(0, 1)         # power control
           .u(0, 1)         # slot granting
           .u(0, 1)         # chan alloc
           .raw(sdu_bits))
    # fill bits: a single 1 then 0s (so the fill-strip finds the marker)
    if fill and len(out.bits) < pdu_len:
        out.u(1, 1)
    out.pad_to(pdu_len, 0)
    # terminate the slot with a null PDU (addr type 0)
    out.u(0, 2).u(0, 1).u(0, 1).u(0, 2).u(0, 1).u(0, 6).u(0, 3)
    return out.pad_to(total_len, 0).array(total_len)
