"""LLC layer: TM-SDU receive + advanced-link defragmentation.

Frozen copy of the port's copy of tetra_tpu.llc.llc (the benchmark's
reference: it imports nothing of the program). The port's copy is
held to the JAX package's original by the port's CPU tests.

Reference behaviour: src/tetra_llc.c — BL PDUs dispatch straight to the
MLE; AL/ALX PDUs enter a defragmenter keyed by N(S) with S(S) sequence
checking; on the final fragment the reassembled TL-SDU goes to the MLE
and the SNDCP IP payload (when present) to a TUN sink.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from portbench.reference.walk.llc_pdu import LlcPduDec, parse_llc_pdu, PDU_DEC_NAMES

__all__ = ["LlcState", "rx_tm_sdu"]


@dataclass
class _DefragEntry:
    ns: int
    last_ss: int = 0
    bits: list = field(default_factory=list)


@dataclass
class LlcState:
    defrag: dict = field(default_factory=dict)   # ns -> _DefragEntry
    # sinks
    tl_sdu_cb: Callable | None = None            # fn(bits, length) -> None
    ip_cb: Callable | None = None                # fn(packed_bytes) -> None
    event_cb: Callable | None = None             # fn(tuple) structured events
    log: Callable = print

    def _event(self, *ev):
        if self.event_cb:
            self.event_cb(ev)


def _defrag_in(llcs: LlcState, lpp, sdu_bits):
    dqe = llcs.defrag.get(lpp.ns)
    if dqe is None:
        dqe = _DefragEntry(ns=lpp.ns)
        llcs.defrag[lpp.ns] = dqe
    # first segment or next expected (reference tetra_llc.c:65-77)
    if dqe.last_ss == 0 or dqe.last_ss == lpp.ss - 1:
        llcs.log(f"<<APPEND:{lpp.ss}>> ", end="")
        dqe.last_ss = lpp.ss
        dqe.bits.append(np.asarray(sdu_bits, dtype=np.uint8))
    else:
        llcs.log(f"<<MISS:{dqe.last_ss}-{lpp.ss}>> ", end="")
        llcs._event("MISS", dqe.last_ss, lpp.ss)


def _defrag_out(llcs: LlcState, lpp):
    dqe = llcs.defrag.pop(lpp.ns, None)
    if dqe is None:
        return None
    llcs.log("<<REMOVE>> ", end="")
    tl_sdu = np.concatenate(dqe.bits) if dqe.bits else np.zeros(0, np.uint8)
    if llcs.tl_sdu_cb:
        llcs.tl_sdu_cb(tl_sdu, len(tl_sdu))
    if llcs.ip_cb is not None and len(tl_sdu) > 3 + 16:
        # strip SNDCP header bits (reference tetra_llc.c:98-100)
        payload = tl_sdu[3 + 4 + 4 + 4 + 4:]
        nbytes = len(payload) // 8
        from portbench.reference.walk.bits import pack_bits
        llcs.ip_cb(pack_bits(payload[: nbytes * 8]))
    return tl_sdu


def rx_tm_sdu(llcs: LlcState, bits, length: int):
    """Receive a TM-SDU (== LLC PDU) in ubits (reference tetra_llc.c:111-179).

    Returns the parsed LlcPdu (or None for runt input)."""
    if not length:
        return None
    if length < 4:
        llcs.log(f"WARNING rx_tm_sdu: l2len too small: {length}")
        llcs._event("TMSDU_RUNT", length)
        return None

    bits = np.asarray(bits, dtype=np.uint8)[:length]
    lpp = parse_llc_pdu(bits, length)
    sdu = bits[lpp.tl_sdu_offset: lpp.tl_sdu_offset + lpp.tl_sdu_len]

    msg = f"TM-SDU({PDU_DEC_NAMES[lpp.pdu_type]})"
    if lpp.have_fcs:
        msg += f" fcs={'BAD' if lpp.fcs_invalid else 'OK'} "
    msg += f" l3len={lpp.tl_sdu_len}"
    if lpp.tl_sdu_len:
        msg += " " + "".join(str(int(b)) for b in sdu)
    llcs.log(msg)
    llcs._event("TMSDU", int(lpp.pdu_type), lpp.ns, lpp.ss,
                0 if not lpp.have_fcs else (2 if lpp.fcs_invalid else 1),
                lpp.tl_sdu_len)

    if not lpp.tl_sdu_len:
        return lpp

    t = lpp.pdu_type
    if t in (LlcPduDec.BL_ADATA, LlcPduDec.BL_DATA, LlcPduDec.BL_UDATA,
             LlcPduDec.BL_ACK, LlcPduDec.AL_SETUP, LlcPduDec.AL_ACK,
             LlcPduDec.AL_RNR, LlcPduDec.AL_RECONNECT, LlcPduDec.AL_DISC):
        if llcs.tl_sdu_cb:
            llcs.tl_sdu_cb(sdu, lpp.tl_sdu_len)
    elif t in (LlcPduDec.AL_DATA, LlcPduDec.AL_UDATA,
               LlcPduDec.ALX_DATA, LlcPduDec.ALX_UDATA):
        _defrag_in(llcs, lpp, sdu)
    elif t in (LlcPduDec.AL_FINAL, LlcPduDec.AL_UFINAL,
               LlcPduDec.ALX_FINAL, LlcPduDec.ALX_UFINAL):
        _defrag_in(llcs, lpp, sdu)
        _defrag_out(llcs, lpp)
    return lpp
