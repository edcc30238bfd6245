"""MLE and layer-3 entity dispatch (MM / CMCE / SNDCP / MLE).

Copy of tetra_tpu.mle.mle, kept in the port so that it imports nothing of
the JAX package; tests/test_torch_tables.py holds it to the original.

Reference behaviour: src/tetra_mle.c + the *_pdu.c name tables — a
3-bit protocol discriminator dispatch that prints PDU names and decodes
SNDCP IP header fields inline.
"""
from __future__ import annotations

from enum import IntEnum

import numpy as np

from tetra_tpu_torch.utils.bits import bits_to_uint

__all__ = ["MlePdisc", "rx_tl_sdu", "mle_pdisc_name", "mm_pdut_name",
           "cmce_pdut_name", "sndcp_pdut_name", "mle_pdut_name"]


class MlePdisc(IntEnum):
    """18.5.21 (reference tetra_mle_pdu.h:31-38)."""
    MM = 1
    CMCE = 2
    SNDCP = 4
    MLE = 5
    MGMT = 6
    TEST = 7


_PDISC_NAMES = {1: "MM", 2: "CMCE", 4: "SNDCP", 5: "MLE", 6: "MGMT", 7: "TEST"}

# 16.10.39 / reference tetra_mm_pdu.h
_MM_PDUT_D = {
    0: "D-OTAR", 1: "D-AUTHENTICATION", 2: "D-CK CHANGE DEMAND", 3: "D-DISABLE",
    4: "D-ENABLE", 5: "D-LOCATION UPDATE ACCEPT", 6: "D-LOCATION UPDATE COMMAND",
    7: "D-LOCATION UPDATE REJECT", 9: "D-LOCATION UPDATE PROCEEDING",
    10: "D-ATTACH/DETACH GROUP ID", 11: "D-ATTACH/DETACH GROUP ID ACK",
    12: "D-MM STATUS", 15: "MM PDU/FUNCTION NOT SUPPORTED",
}

# 14.8.28 / reference tetra_cmce_pdu.h:7-25 (the table is ZERO-based:
# D-ALERT = 0x00 .. D-FACILITY = 0x10; pinned against the compiled
# reference by tests/test_ref_parity_upper.py)
_CMCE_PDUT_D = {
    0: "D-ALERT", 1: "D-CALL PROCEEDING", 2: "D-CONNECT", 3: "D-CONNECT ACK",
    4: "D-DISCONNECT", 5: "D-INFO", 6: "D-RELEASE", 7: "D-SETUP",
    8: "D-STATUS", 9: "D-TX CEASED", 10: "D-TX CONTINUE", 11: "D-TX GRANTED",
    12: "D-TX WAIT", 13: "D-TX INTERRUPT", 14: "D-TX CALL RESTORE",
    15: "D-SDS DATA", 16: "D-FACILITY",
}
_CMCE_PDUT_U = {
    0: "U-ALERT", 2: "U-CONNECT", 4: "U-DISCONNECT", 5: "U-INFO",
    6: "U-RELEASE", 7: "U-SETUP", 8: "U-STATUS", 9: "U-TX CEASED",
    10: "U-TX DEMAND", 14: "U-TX CALL RESTORE", 15: "U-SDS DATA",
    16: "U-FACILITY",
}

# 28.4.1 / reference tetra_sndcp_pdu.h
_SNDCP_PDUT = {
    0: "SN-ACTIVATE PDP ACCEPT", 1: "SN-DEACTIVATE PDP ACCEPT",
    2: "SN-DEACTIVATE PDP DEMAND", 3: "SN-ACTIVATE PDP REJECT",
    4: "SN-UNITDATA", 5: "SN-DATA", 6: "SN-DATA TX REQUEST",
    7: "SN-DATA TX RESPONSE", 8: "SN-END OF DATA", 9: "SN-RECONNECT",
    10: "SN-PAGE REQUEST", 11: "SN-NOT SUPPORTED", 12: "SN-DATA PRIORITY",
    13: "SN-MODIFY",
}

# 18.5.20 / reference tetra_mle_pdu.h
_MLE_PDUT_D = {
    0: "D-NEW CELL", 1: "D-PREPARE FAIL", 2: "D-NWRK BROADCAST",
    3: "D-NWRK BROADCAST EXT", 4: "D-RESTORE ACK", 5: "D-RESTORE FAIL",
    6: "D-CHANNEL RESPONSE",
}


def mle_pdisc_name(pdisc: int) -> str:
    return _PDISC_NAMES.get(pdisc, "unknown")


def mm_pdut_name(pdut: int, uplink: int = 0) -> str:
    return _MM_PDUT_D.get(pdut, "unknown")


def cmce_pdut_name(pdut: int, uplink: int = 0) -> str:
    return (_CMCE_PDUT_U if uplink else _CMCE_PDUT_D).get(pdut, "unknown")


def sndcp_pdut_name(pdut: int, uplink: int = 0) -> str:
    return _SNDCP_PDUT.get(pdut, "unknown")


def mle_pdut_name(pdut: int, uplink: int = 0) -> str:
    return _MLE_PDUT_D.get(pdut, "unknown")


def rx_tl_sdu(bits, length: int, log=print) -> dict:
    """Receive a TL-SDU (== MLE PDU), reference tetra_mle.c:20-53.

    Returns {'pdisc', 'pdut', 'name', ...} and prints the reference's
    log lines via `log`.
    """
    bits = np.asarray(bits, dtype=np.uint8)[:length]
    pdisc = bits_to_uint(bits[0:3])
    out = {"pdisc": pdisc, "pdisc_name": mle_pdisc_name(pdisc)}
    dump = "".join(str(int(b)) for b in bits)
    prefix = f"TL-SDU({out['pdisc_name']}): {dump} "
    if pdisc == MlePdisc.MM:
        out["pdut"] = bits_to_uint(bits[3:7])
        out["name"] = mm_pdut_name(out["pdut"])
        log(prefix + out["name"])
    elif pdisc == MlePdisc.CMCE:
        out["pdut"] = bits_to_uint(bits[3:8])
        out["name"] = cmce_pdut_name(out["pdut"])
        log(prefix + out["name"])
    elif pdisc == MlePdisc.SNDCP:
        out["pdut"] = bits_to_uint(bits[3:7])
        out["name"] = sndcp_pdut_name(out["pdut"])
        out["nsapi"] = bits_to_uint(bits[7:11])
        out["pcomp"] = bits_to_uint(bits[11:15])
        out["dcomp"] = bits_to_uint(bits[15:19])
        out["ip_version"] = bits_to_uint(bits[19:23])
        out["ihl"] = 4 * bits_to_uint(bits[23:27])
        if length >= 3 + 4 + 4 + 4 + 4 + 4 + 64 + 8:
            out["proto"] = bits_to_uint(bits[3 + 4 + 4 + 4 + 4 + 4 + 64:
                                             3 + 4 + 4 + 4 + 4 + 4 + 64 + 8])
        log(prefix + f"{out['name']}  NSAPI={out['nsapi']} PCOMP={out['pcomp']}, "
            f"DCOMP={out['dcomp']} V{out['ip_version']}, IHL={out['ihl']}"
            + (f" Proto={out['proto']}" if "proto" in out else ""))
    elif pdisc == MlePdisc.MLE:
        out["pdut"] = bits_to_uint(bits[3:6])
        out["name"] = mle_pdut_name(out["pdut"])
        log(prefix + out["name"])
    else:
        log(prefix)
    return out
