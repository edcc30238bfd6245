"""The upper-MAC walk of one carrier, worked out again from the
reference's own synchroniser steps and decoded rows: the TDMA clock
(one slot a processed burst, set by each SYNC block that passes its
CRC), the CRC counts, the cell identity and every TL-SDU, through the
frozen copy of the Python control plane in `walk/` (TetraReceiver's
_walk_slot, tetra_lower_mac.c:115-357); and, where asked, the traffic
slots the walk hands to the dumps (tetra_lower_mac.c:198-241) with
their usage, timeslot and voice keystream (tetra_crypto.c:254-282, as
TetraReceiver._voice_keystream selects it).
"""
from __future__ import annotations

import numpy as np

from portbench.reference.fec import PACK_A, PACK_B, ROW
from portbench.reference.walk.bits import bits_to_uint
from portbench.reference.walk import crypto
from portbench.reference.walk.crypto import CryptoState, load_keystore
from portbench.reference.walk.llc import LlcState
from portbench.reference.walk.tdma import TdmaTime
from portbench.reference.walk.upper_mac import LogicalChannel as LC, UpperMac

_PDUT_WIDTH = {1: 4, 2: 5, 4: 4, 5: 3}


def _quiet(*a, **k):
    return None


def voice_keystream(tcs: CryptoState, time: TdmaTime):
    """A traffic slot's 274 voice keystream bits where a cipher key is
    selected and the cell and clock are complete, else None: the slot's
    voice is clear."""
    key = tcs.cck
    if (key is None or not (1 <= time.tn <= 4 and 1 <= time.fn <= 18
                            and 1 <= time.mn <= 60)
            or tcs.cn < 0 or tcs.la < 0 or tcs.cc < 0
            or key.network_info.ksg_type not in crypto._KSGS):
        return None
    return crypto.generate_keystream(tcs, key, time, 274)


def walk_carrier(burst: np.ndarray, emit: np.ndarray, rows: np.ndarray,
                 kinds: np.ndarray, keystore_path: str | None,
                 traffic: bool = False) -> dict:
    """One carrier: burst, emit [steps] bool, the emitted slots' packed
    rows [n, ROW] and kinds [n] in step order -> {'bursts', 'crc_ok',
    'crc_wrong', 'cell' (colour code, mcc, mnc), 'tl_sdus' [(pdisc,
    pdut, bits)]}. With `traffic` also 'traffic' [(slot j, NDB second
    half, usage, timeslot 0-3, voice keystream)], each slot the walk
    dumps, in order; the keystream is None for clear voice."""
    tcs = CryptoState()
    if keystore_path:
        load_keystore(keystore_path, tcs.db)
    sdus, dumped = [], []

    def on_sdu(bits, n):
        b = np.asarray(bits)[:n]
        pdisc = bits_to_uint(b[:3])
        w = _PDUT_WIDTH.get(pdisc)
        sdus.append((pdisc, -1 if w is None else bits_to_uint(b[3:3 + w]),
                     int(n)))

    llc = LlcState(log=_quiet, tl_sdu_cb=on_sdu, ip_cb=_quiet)
    umac = UpperMac(tcs, llc, gsmtap_cb=None, log=_quiet)
    time = TdmaTime()
    st = {"bursts": 0, "crc_ok": 0, "crc_wrong": 0}
    cell = [0, 0, 0]
    code = 0

    def count(ok):
        st["crc_ok" if ok else "crc_wrong"] += 1

    def dump(j, half):
        if traffic:
            dumped.append((j, half, umac.cur_burst_is_traffic, time.tn - 1,
                           voice_keystream(tcs, time)))

    def dispatch(t1, lchan, ok, blk):
        umac.rx_slot(t1, lchan, bool(ok), time, blk_num=blk,
                     scrambling_code=code)

    j = 0
    for t in range(len(burst)):
        if burst[t]:
            time.add_tn(1)
            st["bursts"] += 1
        if not emit[t]:
            continue
        r, k = rows[j], int(kinds[j])
        j += 1
        okA, okB = bool(r[ROW - 2]), bool(r[ROW - 1])
        bbk = r[PACK_A + PACK_B:PACK_A + PACK_B + 14]
        if k == 0:
            sb1 = r[:60]
            count(okA)
            if okA:
                cc = bits_to_uint(sb1[4:10])
                time.tn = bits_to_uint(sb1[10:12]) + 1
                time.fn = bits_to_uint(sb1[12:17])
                time.mn = bits_to_uint(sb1[17:23])
                mcc, mnc = bits_to_uint(sb1[31:41]), bits_to_uint(sb1[41:55])
                cell = [cc, mcc, mnc]
                code = ((((mcc & 0x3FF) << 20) | ((mnc & 0x3FFF) << 6)
                         | (cc & 0x3F)) << 2) | 3
                tcs.cc = cc
                if tcs.mcc != mcc or tcs.mnc != mnc:
                    tcs.update_current_network(mcc, mnc)
            umac.rx_slot(sb1, LC.BSCH, okA, time, blk_num=1)
            dispatch(bbk, LC.AACH, True, 0)
            bnch = time.fn == 18 and time.tn == 4 - ((time.mn + 3) % 4)
            count(okB)
            dispatch(r[PACK_A:PACK_A + 124], LC.BNCH if bnch else LC.UNKNOWN,
                     okB, 2)
        elif k == 1:
            dispatch(bbk, LC.AACH, True, 0)
            if not umac.cur_burst_is_traffic:
                count(okA)
                dispatch(r[:268], LC.SCH_F, okA, 0)
            else:
                dump(j - 1, False)
        else:
            dispatch(bbk, LC.AACH, True, 0)
            if umac.cur_burst_is_traffic:
                umac.blk1_stolen = True
                count(okA)
                dispatch(r[:124], LC.UNKNOWN, okA, 1)
                if umac.blk2_stolen:
                    count(okB)
                    dispatch(r[PACK_A:PACK_A + 124], LC.UNKNOWN, okB, 2)
                else:
                    dump(j - 1, True)
            else:
                count(okA)
                dispatch(r[:124], LC.UNKNOWN, okA, 1)
                count(okB)
                dispatch(r[PACK_A:PACK_A + 124], LC.UNKNOWN, okB, 2)
    out = {**st, "cell": tuple(cell), "tl_sdus": sdus}
    if traffic:
        out["traffic"] = dumped
    return out
