"""GSMTAP export of decoded MAC blocks (Wireshark observability).

Copy of tetra_tpu.io.gsmtap, kept in the port so that it imports nothing of
the JAX package; tests/test_torch_tables.py holds it to the original.

Reference behaviour: src/tetra_gsmtap.c — every CRC-OK block is wrapped
in a GSMTAP v2 header (type TETRA_I1, lchan-mapped subtype, flat TDMA
frame number) and sent to a localhost UDP sink.
"""
from __future__ import annotations

import socket
import struct

from tetra_tpu_torch.tdma import TdmaTime
from tetra_tpu_torch.utils.bits import pack_bits

__all__ = ["GsmtapSink", "GSMTAP_PORT", "make_gsmtap_packet"]

GSMTAP_PORT = 4729
GSMTAP_VERSION = 2
GSMTAP_TYPE_TETRA_I1 = 0x05

# libosmocore gsmtap.h TETRA subtypes
GSMTAP_TETRA_BSCH = 0x01
GSMTAP_TETRA_AACH = 0x02
GSMTAP_TETRA_SCH_HU = 0x03
GSMTAP_TETRA_SCH_HD = 0x04
GSMTAP_TETRA_SCH_F = 0x05
GSMTAP_TETRA_BNCH = 0x06
GSMTAP_TETRA_STCH = 0x07
GSMTAP_TETRA_TCH_F = 0x08

# lchan id -> gsmtap subtype (reference tetra_gsmtap.c:19-28)
_LCHAN2GSMTAP = {
    1: GSMTAP_TETRA_SCH_F,   # SCH/F
    2: GSMTAP_TETRA_SCH_HD,
    3: GSMTAP_TETRA_SCH_HU,
    4: GSMTAP_TETRA_STCH,
    8: GSMTAP_TETRA_AACH,
    9: GSMTAP_TETRA_TCH_F,
    10: GSMTAP_TETRA_BSCH,
    11: GSMTAP_TETRA_BNCH,
}


def make_gsmtap_packet(time: TdmaTime, lchan: int, ts: int, ss: int,
                       signal_dbm: int, snr: int, bits) -> bytes | None:
    """GSMTAP v2 packet bytes (reference tetra_gsmtap.c:31-67)."""
    subtype = _LCHAN2GSMTAP.get(lchan)
    if subtype is None:
        return None
    fn = time.time2fn()
    hdr = struct.pack("!BBBBHbBIBBBB",
                      GSMTAP_VERSION, 4, GSMTAP_TYPE_TETRA_I1, ts & 0xFF,
                      0,                      # arfcn
                      signal_dbm, snr, fn, subtype, 0, ss & 0xFF, 0)
    return hdr + pack_bits(bits)


class GsmtapSink:
    """UDP GSMTAP sender (reference tetra_gsmtap.c:69-82)."""

    def __init__(self, host: str = "localhost", port: int = 0):
        self.addr = (host, port or GSMTAP_PORT)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def send(self, time: TdmaTime, lchan: int, ts: int, bits,
             ss: int = 0, signal_dbm: int = 0, snr: int = 0) -> int:
        pkt = make_gsmtap_packet(time, lchan, ts, ss, signal_dbm, snr, bits)
        if pkt is None:
            return 0
        try:
            return self.sock.sendto(pkt, self.addr)
        except OSError:
            return 0

    def close(self):
        self.sock.close()
