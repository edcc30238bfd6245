"""Upper MAC: TMV-SAP dispatch, fragment reassembly, broadcast handling.

Frozen copy of the port's copy of tetra_tpu.umac.upper_mac (the benchmark's
reference: it imports nothing of the program). The port's copy is
held to the JAX package's original by the port's CPU tests.

Reference behaviour: src/tetra_upper_mac.c — MAC PDU discrimination
(RESOURCE / FRAG/END / BROADCAST / SUPPL), SYSINFO and ACCESS-ASSIGN
handling, per-timeslot fragment slots with N203 age-out, fill-bit
stripping, the decryption hook, and GSMTAP export of CRC-OK blocks.

Host control plane: consumes batched device-decoded type-1 bits via
TmvUnitdata records (the TMV-SAP UNITDATA.ind analogue,
src/tetra_prim.h:26-36).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from portbench.reference import constants as C
from portbench.reference.walk.tdma import TdmaTime
from portbench.reference.walk import mac_pdu
from portbench.reference.walk.mac_pdu import (MacPduType, AddrType, MACPDU_LEN_2ND_STOLEN,
                                    MACPDU_LEN_START_FRAG)
from portbench.reference.walk.llc import LlcState, rx_tm_sdu
from portbench.reference.walk.crypto import CryptoState, decrypt_mac_element
from portbench.reference.walk.bits import bits_to_uint

__all__ = ["LogicalChannel", "TmvUnitdata", "UpperMac"]

REASSEMBLE_FRAGMENTS = True
FRAGSLOT_NR_SLOTS = 5
N203 = 6


class LogicalChannel:
    """Chapter 22.2.x (reference tetra_common.h:24-40)."""
    UNKNOWN = 0
    SCH_F = 1
    SCH_HD = 2
    SCH_HU = 3
    STCH = 4
    SCH_P8_F = 5
    SCH_P8_HD = 6
    SCH_P8_HU = 7
    AACH = 8
    TCH = 9
    BSCH = 10
    BNCH = 11

    NAMES = {0: "UNKNOWN", 1: "SCH/F", 2: "SCH/HD", 3: "SCH/HU", 4: "STCH",
             5: "SCH-P8/F", 6: "SCH-P8/HD", 7: "SCH-P8/HU", 8: "AACH",
             9: "TCH", 10: "BSCH", 11: "BNCH"}


# SAP names (reference tetra_common.c:96-103 / tetra_prim.h:10-16)
SAP_NAMES = {0: "TP-SAP", 1: "TMV-SAP", 2: "TMA-SAP", 3: "TMB-SAP", 4: "TMD-SAP"}


def sap_name(sap: int) -> str:
    return SAP_NAMES.get(sap, "unknown")


@dataclass
class TmvUnitdata:
    """TMV-SAP UNITDATA.ind parameters (reference tetra_prim.h:26-36)."""
    bits: np.ndarray                    # type-1 ubits
    lchan: int
    crc_ok: bool
    tdma_time: TdmaTime
    blk_num: int = 0                    # BLK_1 / BLK_2 / 0
    scrambling_code: int = 0


@dataclass
class _Fragslot:
    active: bool = False
    age: int = 0
    num_frags: int = 0
    length: int = 0
    encryption: bool = False
    key: object = None
    bits: list = field(default_factory=list)


def _num_fill_bits(bits: np.ndarray) -> int:
    """Fill bits end at the last '1' (reference tetra_upper_mac.c:75-84)."""
    n = len(bits)
    for i in range(1, n):
        if bits[n - i] == 1:
            return i
    return 0


class UpperMac:
    def __init__(self, crypto_state: CryptoState | None = None,
                 llc: LlcState | None = None,
                 gsmtap_cb: Callable | None = None, log: Callable = print):
        self.tcs = crypto_state or CryptoState()
        self.llc = llc or LlcState(log=lambda *a, **k: None)
        self.gsmtap_cb = gsmtap_cb
        self.log = log
        self.fragslots = [_Fragslot() for _ in range(FRAGSLOT_NR_SLOTS)]
        # mac state (reference tetra_common.h:44-63)
        self.cur_burst_is_traffic = 0
        self.blk1_stolen = False
        self.blk2_stolen = False
        self.last_sid: mac_pdu.SysinfoDecoded | None = None
        self.ssi = 0
        self.usage_marker = 0
        self.addr_type = 0
        # event sink for testing/structured consumers
        self.events: list = []

    # ------------- fragment slots -------------

    def _cleanup_fragslot(self, slot: int):
        self.fragslots[slot] = _Fragslot()

    def age_fragslots(self):
        """(reference tetra_upper_mac.c:60-72)."""
        for i, fs in enumerate(self.fragslots):
            if fs.active:
                fs.age += 1
                if fs.age > N203:
                    self.log(f"\nFRAG: aged out old fragments for slot={i} "
                             f"fragments={fs.num_frags} length={fs.length} timer={fs.age}")
                    self.events.append(("FRAG_AGEOUT", i, fs.num_frags,
                                        fs.length))
                    self._cleanup_fragslot(i)

    def _append_frag(self, slot: int, bits):
        fs = self.fragslots[slot]
        fs.bits.append(np.asarray(bits, dtype=np.uint8))
        fs.length += len(bits)
        fs.num_frags += 1
        fs.age = 0

    # ------------- PDU handlers -------------

    def rx_bcast(self, tup: TmvUnitdata) -> int:
        """SYSINFO / broadcast (reference tetra_upper_mac.c:85-133)."""
        sid = mac_pdu.decode_sysinfo(tup.bits)
        tup.tdma_time.hn = sid.hyperframe_number
        dl = C.dl_carrier_hz(sid.freq_band, sid.main_carrier, sid.freq_offset)
        ul = C.ul_carrier_hz(sid.freq_band, sid.main_carrier, sid.freq_offset,
                             sid.duplex_spacing, sid.reverse_operation)
        line = (f"BNCH SYSINFO (DL {dl} Hz, UL {ul} Hz), service_details "
                f"0x{sid.mle_si.bs_service_details:04x} ")
        line += (f"CCK ID {sid.cck_id}" if sid.cck_valid_no_hf
                 else f"Hyperframe {sid.hyperframe_number}")
        self.log(line)
        self.last_sid = sid
        self.events.append(("SYSINFO", sid))
        # crypto state update (tetra_upper_mac.c:119-131)
        self.tcs.la = sid.mle_si.la
        self.tcs.cn = sid.main_carrier
        if sid.cck_valid_no_hf:
            if sid.cck_id != self.tcs.cck_id:
                self.tcs.cck_id = sid.cck_id
                self.tcs.update_current_cck()
        else:
            self.tcs.hn = sid.hyperframe_number
        return -1

    def rx_aach(self, tup: TmvUnitdata):
        """ACCESS-ASSIGN (reference tetra_upper_mac.c:423-455)."""
        aad = mac_pdu.decode_access_assign(tup.bits, tup.tdma_time.fn == 18)
        parts = ["ACCESS-ASSIGN PDU: "]
        if aad.access1 is not None:
            parts.append(f"ACCESS1: {chr(ord('A') + aad.access1.access_code)}"
                         f"/{aad.access1.base_frame_len} ")
        if aad.access2 is not None:
            parts.append(f"ACCESS2: {chr(ord('A') + aad.access2.access_code)}"
                         f"/{aad.access2.base_frame_len} ")
        if aad.dl_usage >= 0:
            parts.append(f"DL_USAGE: {mac_pdu.dl_usage_name(aad.dl_usage)} ")
        if aad.ul_usage >= 0:
            parts.append(f"UL_USAGE: {mac_pdu.ul_usage_name(aad.ul_usage)} ")
        self.log("".join(parts))
        self.events.append(("AACH", aad))
        self.cur_burst_is_traffic = aad.dl_usage if aad.dl_usage > 3 else 0
        self.blk1_stolen = False
        self.blk2_stolen = False

    def rx_resrc(self, tup: TmvUnitdata) -> int:
        """MAC-RESOURCE (reference tetra_upper_mac.c:157-268)."""
        bits = np.asarray(tup.bits, dtype=np.uint8)
        rsd = mac_pdu.decode_resource(bits, 0)
        tmpdu_offset = rsd.bit_len
        key = None

        # eff mirrors the reference's msgb_l1len after truncation; a
        # reserved length field (-22) drives msg->tail BELOW msg->head
        # (tetra_upper_mac.c:177-178), so the reported lengths go
        # NEGATIVE — reproduced signed here, pinned by the compiled
        # oracle in tests/test_ref_parity_upper.py
        eff = len(bits)
        if rsd.macpdu_length == MACPDU_LEN_2ND_STOLEN:
            pdu_bits = -1
            self.blk2_stolen = True
        elif rsd.macpdu_length == MACPDU_LEN_START_FRAG:
            pdu_bits = -1
        else:
            pdu_bits = rsd.macpdu_length * 8
            if 0 < pdu_bits <= len(bits):
                bits = bits[:pdu_bits]
                eff = pdu_bits
            elif pdu_bits <= 0:
                bits = bits[:0]
                eff = pdu_bits

        if rsd.fill_bits and eff > 0:
            nfb = _num_fill_bits(bits)
            bits = bits[:len(bits) - nfb]
            eff -= nfb

        if rsd.is_encrypted and self.tcs.db.keys:
            key = self.tcs.get_ksg_key(rsd.addr.ssi)
            if key is not None:
                second_half = (tup.blk_num == 2 and tup.lchan in
                               (LogicalChannel.SCH_HD, LogicalChannel.UNKNOWN))
                bits, ok = decrypt_mac_element(
                    self.tcs, key, bits, tup.tdma_time, tmpdu_offset,
                    second_half, event_cb=self.events.append)
                rsd.is_encrypted = int(not ok)
                if ok and rsd.chan_alloc_pres:
                    cad = mac_pdu.decode_chan_alloc(bits[tmpdu_offset:])
                    rsd.cad = cad
                    tmpdu_offset += cad.bit_len

        l2len = eff - tmpdu_offset
        line = (f"RESOURCE Encr={rsd.encryption_mode}"
                f"{' DECRYPTED' if rsd.encryption_mode and not rsd.is_encrypted else ''}"
                f" len_field={rsd.macpdu_length} l1_len={eff} l2_len={l2len}"
                f" Addr={rsd.addr.dump()}")
        if rsd.chan_alloc_pres:
            line += (" ChanAlloc=ENCRYPTED" if rsd.is_encrypted
                     else f" ChanAlloc={self._alloc_dump(rsd.cad)}")
        if rsd.slot_granting_pres:
            line += f" SlotGrant={rsd.slot_granting_nr_slots}/{rsd.slot_granting_delay}"
        self.events.append(("RESOURCE", rsd, l2len))

        if rsd.addr.type == AddrType.NULL:
            self.log(line)
            return -1
        self.ssi = rsd.addr.ssi
        self.usage_marker = rsd.addr.usage_marker
        self.addr_type = rsd.addr.type

        if l2len <= 0 or rsd.is_encrypted:
            self.log(line)
            return pdu_bits

        sdu = bits[tmpdu_offset:]
        self.log(line + ": " + "".join(str(int(b)) for b in sdu))
        if rsd.macpdu_length != MACPDU_LEN_START_FRAG or not REASSEMBLE_FRAGMENTS:
            rx_tm_sdu(self.llc, sdu, len(sdu))
        else:
            slot = tup.tdma_time.tn
            fs = self.fragslots[slot]
            if fs.active:
                self.log("\nWARNING: fragment slot still active")
                self.events.append(("FRAG_ACTIVE", slot))
                self._cleanup_fragslot(slot)
            fs = self.fragslots[slot]
            fs.active = True
            fs.encryption = rsd.encryption_mode > 0
            fs.key = key
            self._append_frag(slot, sdu)
            self.log(f"\nFRAG-START slot={slot} len={len(sdu)}")
            self.events.append(("FRAG_START", slot, len(sdu)))
        return pdu_bits

    def rx_macfrag(self, tup: TmvUnitdata) -> int:
        """MAC-FRAG (reference tetra_upper_mac.c:286-321)."""
        bits = np.asarray(tup.bits, dtype=np.uint8)
        slot = tup.tdma_time.tn
        fs = self.fragslots[slot]
        if not fs.active:
            self.log(f"WARNING got fragment without start packet for slot={slot}")
            self.events.append(("FRAG_NOSTART", slot, -1))
            return -1
        n = 2 + 1  # MAC-FRAG/END (01) + MAC-FRAG (0)
        fill = bits[n]
        n += 1
        body = bits[n:]
        if fill:
            body = body[:len(bits) - _num_fill_bits(bits) - n]
        if fs.encryption and fs.key is not None:
            dec, _ = decrypt_mac_element(self.tcs, fs.key,
                                         bits[:n + len(body)], tup.tdma_time,
                                         n, event_cb=self.events.append)
            body = dec[n:]
        self._append_frag(slot, body)
        self.log(f"FRAG-CONT slot={slot} added={len(body)}")
        self.events.append(("FRAG_CONT", slot, len(body)))
        return -1

    def rx_macend(self, tup: TmvUnitdata) -> int:
        """MAC-END (reference tetra_upper_mac.c:323-385)."""
        bits = np.asarray(tup.bits, dtype=np.uint8)
        slot = tup.tdma_time.tn
        fs = self.fragslots[slot]
        n = 2 + 1  # MAC-FRAG/END (01) + MAC-END (1)
        fill = bits[n]; n += 1
        n += 1  # position of grant
        length_ind = bits_to_uint(bits[n:n + 6]); n += 6
        if not fs.active:
            self.log(f"FRAG: got end frag with len {length_ind * 8} without "
                     f"start packet for slot={slot}")
            self.events.append(("FRAG_NOSTART", slot, length_ind * 8))
            self._cleanup_fragslot(slot)
            return length_ind * 8
        slot_granting = bits[n]; n += 1
        if slot_granting:
            n += 8
        chanalloc_present = bits[n]; n += 1
        body_end = min(length_ind * 8, len(bits))
        work = bits[:body_end]
        if fill:
            work = work[:len(work) - _num_fill_bits(work)]
        if fs.encryption and fs.key is not None:
            work, _ = decrypt_mac_element(self.tcs, fs.key, work,
                                          tup.tdma_time, n,
                                          event_cb=self.events.append)
        if chanalloc_present:
            cad = mac_pdu.decode_chan_alloc(work[n:])
            n += cad.bit_len
        body = work[n:]
        self._append_frag(slot, body)
        self.log(f"FRAG-END slot={slot} added={len(body)}")
        self.events.append(("FRAG_END", slot, len(body), fs.length))
        if not fs.encryption or fs.key is not None:
            full = np.concatenate(fs.bits)
            rx_tm_sdu(self.llc, full, fs.length)
        self._cleanup_fragslot(slot)
        return length_ind * 8

    def rx_suppl(self, tup: TmvUnitdata) -> int:
        """MAC-D-BLCK (reference tetra_upper_mac.c:388-415)."""
        bits = np.asarray(tup.bits, dtype=np.uint8)
        slot_granting = bits[17]
        tmpdu_offset = 17 + 1 + (8 if slot_granting else 0)
        self.log("SUPPLEMENTARY MAC-D-BLOCK ")
        sdu = bits[tmpdu_offset:]
        self.events.append(("SUPPL", len(sdu)))
        rx_tm_sdu(self.llc, sdu, min(100, len(sdu)))
        return -1

    def _alloc_dump(self, cad) -> str:
        """(reference tetra_upper_mac.c:136-155)."""
        if cad.ext_carr_pres:
            band, offset = cad.ext_freq_band, cad.ext_freq_offset
        elif self.last_sid is not None:
            band, offset = self.last_sid.freq_band, self.last_sid.freq_offset
        else:
            band, offset = 0, 0
        hz = C.dl_carrier_hz(band, cad.carrier_nr, offset)
        return (f"{mac_pdu.ALLOC_TYPE_NAMES.get(cad.type, '?')} "
                f"(TN{cad.timeslot}/{mac_pdu.UL_DL_NAMES.get(cad.ul_dl, '?')}/{hz}Hz)")

    # ------------- TMV-SAP entry -------------

    def rx_tmv_unitdata(self, tup: TmvUnitdata) -> int:
        """One TMV-UNITDATA.ind (reference tetra_upper_mac.c:457-547).

        Returns parsed PDU length in bits, or -1 when the slot is consumed.
        """
        bits = np.asarray(tup.bits, dtype=np.uint8)
        pdu_type = bits_to_uint(bits[0:2]) if len(bits) >= 2 else 0
        if tup.lchan == LogicalChannel.BSCH:
            pdu_name = "SYNC"
        elif tup.lchan == LogicalChannel.AACH:
            pdu_name = "ACCESS-ASSIGN"
        else:
            pdu_name = mac_pdu.MACPDU_NAMES.get(pdu_type, "unknown")

        self.log(f"TMV-UNITDATA.ind {tup.tdma_time.dump()} "
                 f"{LogicalChannel.NAMES.get(tup.lchan, '?')} "
                 f"CRC={int(tup.crc_ok)} {pdu_name}")
        self.events.append(("TMV", tup.lchan, int(tup.crc_ok), pdu_type))
        if not tup.crc_ok:
            return -1

        if self.gsmtap_cb:
            self.gsmtap_cb(tup)

        if tup.tdma_time.fn == 18 and REASSEMBLE_FRAGMENTS:
            self.age_fragslots()

        if tup.lchan == LogicalChannel.AACH:
            self.rx_aach(tup)
            return -1
        if tup.lchan == LogicalChannel.BSCH:
            return -1
        if tup.lchan in (LogicalChannel.BNCH, LogicalChannel.UNKNOWN,
                         LogicalChannel.SCH_F, LogicalChannel.SCH_HD):
            if pdu_type == MacPduType.BROADCAST:
                return self.rx_bcast(tup)
            if pdu_type == MacPduType.MAC_RESOURCE:
                return self.rx_resrc(tup)
            if pdu_type == MacPduType.MAC_SUPPL:
                return self.rx_suppl(tup)
            if pdu_type == MacPduType.MAC_FRAG_END:
                if REASSEMBLE_FRAGMENTS:
                    if bits[2] == 0:
                        return self.rx_macfrag(tup)
                    return self.rx_macend(tup)
                self.log("FRAG/END (reassembly disabled)")
                return -1
            self.log(f"STRANGE pdu={pdu_type}")
            self.events.append(("STRANGE_PDU", pdu_type))
            return -1
        self.log(f"STRANGE lchan={tup.lchan}")
        self.events.append(("STRANGE_LCHAN", tup.lchan))
        return -1

    def rx_slot(self, type1_bits, lchan: int, crc_ok: bool, time: TdmaTime,
                blk_num: int = 0, scrambling_code: int = 0):
        """Multi-PDU slot loop (reference tetra_lower_mac.c:312-352):
        parse MAC PDUs until one consumes the remainder."""
        bits = np.asarray(type1_bits, dtype=np.uint8)
        total = len(bits)
        offset = 0
        # NB the reference's loop condition (tetra_lower_mac.c:330)
        # compares uint32 offset against (type1_bits - 16), which for the
        # 14-bit AACH block wraps around — so the loop always runs at
        # least once. Replicated with a do-while.
        while True:
            tup = TmvUnitdata(bits=bits[offset:], lchan=lchan, crc_ok=crc_ok,
                              tdma_time=time.copy(), blk_num=blk_num,
                              scrambling_code=scrambling_code)
            pdu_bits = self.rx_tmv_unitdata(tup)
            if pdu_bits <= 0:
                break
            offset += pdu_bits
            if offset >= total - 16:
                break
