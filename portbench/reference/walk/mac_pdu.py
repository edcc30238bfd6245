"""Upper-MAC PDU bit-field codecs (host control plane).

Frozen copy of the port's copy of tetra_tpu.umac.mac_pdu (the benchmark's
reference: it imports nothing of the program). The port's copy is
held to the JAX package's original by the port's CPU tests.

Reference behaviour: src/tetra_mac_pdu.c — SYSINFO, channel-allocation,
MAC-RESOURCE, ACCESS-ASSIGN decoders and name tables. This is branchy,
byte-scale work on ~kbit/s of decoded output per carrier, so it stays on
the host (SURVEY.md §7.1), fed from device-decoded type-1 bits.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np

from portbench.reference.walk.bits import bits_to_uint

__all__ = [
    "MacPduType", "AddrType", "SysinfoDecoded", "ChanAllocDecoded",
    "ResourceDecoded", "AccessAssignDecoded", "decode_sysinfo",
    "decode_chan_alloc", "decode_resource", "decode_access_assign",
    "MACPDU_LEN_2ND_STOLEN", "MACPDU_LEN_START_FRAG",
]

MACPDU_LEN_2ND_STOLEN = -2
MACPDU_LEN_START_FRAG = -1


class MacPduType(IntEnum):
    """Table 21.x (reference tetra_mac_pdu.h:7-12)."""
    MAC_RESOURCE = 0
    MAC_FRAG_END = 1
    BROADCAST = 2
    MAC_SUPPL = 3


class AddrType(IntEnum):
    """(reference tetra_mac_pdu.h:186-195)."""
    NULL = 0
    SSI = 1
    EVENT_LABEL = 2
    USSI = 3
    SMI = 4
    SSI_EVENT = 5
    SSI_USAGE = 6
    SMI_EVENT = 7


ADDR_LEN_BY_TYPE = {
    AddrType.SSI: 24, AddrType.EVENT_LABEL: 10, AddrType.USSI: 24,
    AddrType.SMI: 24, AddrType.SSI_EVENT: 34, AddrType.SSI_USAGE: 30,
    AddrType.SMI_EVENT: 34,
}

MACPDU_NAMES = {0: "RESOURCE", 1: "FRAG/END", 2: "BROADCAST", 3: "SUPPLEMENTARY"}
ADDR_TYPE_NAMES = {
    0: "Null PDU", 1: "SSI", 2: "Event Label",
    3: "USSI (migrading MS un-exchanged)", 4: "SMI (management)",
    5: "SSI + Event Label", 6: "SSI + Usage Marker", 7: "SMI + Event Label",
}
ALLOC_TYPE_NAMES = {0: "Replace", 1: "Additional", 2: "Quit and go", 3: "Replace + Slot1"}
UL_DL_NAMES = {0: "Augmented", 1: "Downlink only", 2: "Uplink only", 3: "Uplink + Downlink"}
BS_SERV_DET_NAMES = {
    1 << 11: "Registration mandatory", 1 << 10: "De-registration mandatory",
    1 << 9: "Priority cell", 1 << 8: "Cell never uses minimum mode",
    1 << 7: "Migration supported", 1 << 6: "Normal mode",
    1 << 5: "Voice service", 1 << 4: "Circuit data",
    1 << 2: "SNDCP data", 1 << 1: "Air encryption", 1 << 0: "Advanced link",
}
DL_USAGE_NAMES = {0: "Unallocated", 1: "Assigned control", 2: "Common control", 3: "Reserved"}


def dl_usage_name(v: int) -> str:
    return DL_USAGE_NAMES.get(v, "Traffic")


def ul_usage_name(v: int) -> str:
    return "Unallocated" if v == 0 else "Traffic"


class _Cursor:
    def __init__(self, bits):
        self.bits = np.asarray(bits).astype(np.uint8)
        self.pos = 0

    def u(self, n: int) -> int:
        v = bits_to_uint(self.bits[self.pos:self.pos + n])
        self.pos += n
        return v

    def skip(self, n: int):
        self.pos += n


@dataclass
class MleSysinfo:
    la: int = 0
    subscr_class: int = 0
    bs_service_details: int = 0


@dataclass
class SysinfoDecoded:
    main_carrier: int = 0
    freq_band: int = 0
    freq_offset: int = 0
    duplex_spacing: int = 0
    reverse_operation: int = 0
    num_of_csch: int = 0
    ms_txpwr_max_cell: int = 0
    rxlev_access_min: int = 0
    access_parameter: int = 0
    radio_dl_timeout: int = 0
    cck_valid_no_hf: int = 0
    cck_id: int = 0
    hyperframe_number: int = 0
    option_field: int = 0
    frame_bitmap: int = 0
    access_code: int = 0
    ext_service: int = 0
    mle_si: MleSysinfo = field(default_factory=MleSysinfo)


def decode_sysinfo(bits) -> SysinfoDecoded:
    """SYSINFO PDU, 21.4.4.1 (reference tetra_mac_pdu.c:43-80)."""
    sid = SysinfoDecoded()
    c = _Cursor(bits)
    c.skip(2)  # broadcast PDU header
    c.skip(2)  # sysinfo PDU header
    sid.main_carrier = c.u(12)
    sid.freq_band = c.u(4)
    sid.freq_offset = c.u(2)
    sid.duplex_spacing = c.u(3)
    sid.reverse_operation = c.u(1)
    sid.num_of_csch = c.u(2)
    sid.ms_txpwr_max_cell = c.u(3)
    sid.rxlev_access_min = c.u(4)
    sid.access_parameter = c.u(4)
    sid.radio_dl_timeout = c.u(4)
    sid.cck_valid_no_hf = c.u(1)
    # NB the reference reads the 16-bit field without advancing (quirk of
    # tetra_mac_pdu.c:62-66: cur not incremented) — replicated exactly.
    val16 = bits_to_uint(np.asarray(bits)[c.pos:c.pos + 16])
    if sid.cck_valid_no_hf:
        sid.cck_id = val16
    else:
        sid.hyperframe_number = val16
    sid.option_field = c.u(2)
    if sid.option_field in (0, 1):
        sid.frame_bitmap = c.u(20)
    elif sid.option_field == 2:
        sid.access_code = c.u(20)
    elif sid.option_field == 3:
        sid.ext_service = c.u(20)
    # TM-SDU (D-MLE-SYSINFO) at fixed offset 124-42 (tetra_mac_pdu.c:79)
    m = _Cursor(np.asarray(bits)[124 - 42:])
    sid.mle_si = MleSysinfo(la=m.u(14), subscr_class=m.u(16), bs_service_details=m.u(12))
    return sid


@dataclass
class ChanAllocDecoded:
    type: int = 0
    timeslot: int = 0
    ul_dl: int = 0
    clch_perm: int = 0
    cell_chg_f: int = 0
    carrier_nr: int = 0
    ext_carr_pres: int = 0
    ext_freq_band: int = 0
    ext_freq_offset: int = 0
    ext_duplex_spc: int = 0
    ext_reverse_oper: int = 0
    monit_pattern: int = 0
    monit_patt_f18: int = 0
    aug: dict = field(default_factory=dict)
    bit_len: int = 0


def decode_chan_alloc(bits) -> ChanAllocDecoded:
    """Channel-allocation element, 21.5.2 (reference tetra_mac_pdu.c:95-136)."""
    cad = ChanAllocDecoded()
    c = _Cursor(bits)
    cad.type = c.u(2)
    cad.timeslot = c.u(4)
    cad.ul_dl = c.u(2)
    cad.clch_perm = c.u(1)
    cad.cell_chg_f = c.u(1)
    cad.carrier_nr = c.u(12)
    cad.ext_carr_pres = c.u(1)
    if cad.ext_carr_pres:
        cad.ext_freq_band = c.u(4)
        cad.ext_freq_offset = c.u(2)
        cad.ext_duplex_spc = c.u(3)
        cad.ext_reverse_oper = c.u(1)
    cad.monit_pattern = c.u(2)
    if cad.monit_pattern == 0:
        cad.monit_patt_f18 = c.u(2)
    if cad.ul_dl == 0:
        # augmented (QAM) channel allocation (tetra_mac_pdu.c:115-134)
        cad.aug = {
            "ul_dl_ass": c.u(2), "bandwidth": c.u(3), "modulation": c.u(3),
            "max_ul_qam": c.u(3),
        }
        c.skip(3)
        cad.aug["conf_chan_stat"] = c.u(3)
        cad.aug["bs_imbalance"] = c.u(4)
        cad.aug["bs_tx_rel"] = c.u(5)
        cad.aug["napping_sts"] = c.u(2)
        if cad.aug["napping_sts"] == 1:
            c.skip(11)
        c.skip(4)
        if c.u(1):
            c.skip(16)
        if c.u(1):
            c.skip(16)
        c.skip(1)
    cad.bit_len = c.pos
    return cad


def _decode_nr_slots(v: int) -> int:
    """Table 21.90 (reference tetra_mac_pdu.c:141-160)."""
    tbl = (0, 1, 2, 3, 4, 5, 6, 8, 10, 13, 17, 24, 34, 51, 68, 0xFF)
    return tbl[v & 0xF]


def _decode_length(li: int) -> int:
    """(reference tetra_mac_pdu.c:162-179)."""
    y2 = z2 = 1
    if li == 0 or li == 0x3B or li == 0x3C:
        return -22  # -EINVAL in the reference
    if li <= 0x12:
        return y2 * li
    if li <= 0x3A:
        return 18 * y2 + (li - 18) * z2
    if li == 0x3E:
        return MACPDU_LEN_2ND_STOLEN
    if li == 0x3F:
        return MACPDU_LEN_START_FRAG
    return -22


@dataclass
class TetraAddr:
    type: int = 0
    mcc: int = 0
    mnc: int = 0
    ssi: int = 0
    event_label: int = 0
    usage_marker: int = 0

    def dump(self) -> str:
        name = ADDR_TYPE_NAMES.get(self.type, "unknown")
        t = AddrType(self.type) if self.type < 8 else None
        if t in (AddrType.SSI, AddrType.USSI, AddrType.SMI):
            return f"{name}({self.ssi})"
        if t in (AddrType.EVENT_LABEL, AddrType.SSI_EVENT, AddrType.SMI_EVENT):
            return f"{name}({self.ssi}/E{self.event_label})"
        if t == AddrType.SSI_USAGE:
            return f"{name}({self.ssi}/U{self.usage_marker})"
        return f"{name}()"


@dataclass
class ResourceDecoded:
    fill_bits: int = 0
    grant_position: int = 0
    encryption_mode: int = 0
    is_encrypted: int = 0
    rand_acc_flag: int = 0
    macpdu_length: int = 0
    addr: TetraAddr = field(default_factory=TetraAddr)
    power_control_pres: int = 0
    slot_granting_pres: int = 0
    slot_granting_nr_slots: int = 0
    slot_granting_delay: int = 0
    chan_alloc_pres: int = 0
    cad: ChanAllocDecoded = field(default_factory=ChanAllocDecoded)
    bit_len: int = 0


def decode_resource(bits, is_decrypted: int = 0) -> ResourceDecoded:
    """MAC-RESOURCE PDU header, 21.4.3.1 (reference tetra_mac_pdu.c:183-247).

    Returns parsed header; bit_len is the TM-SDU offset (0 for null PDU).
    """
    rsd = ResourceDecoded()
    c = _Cursor(bits)
    c.skip(2)
    rsd.fill_bits = c.u(1)
    rsd.grant_position = c.u(1)
    rsd.encryption_mode = c.u(2)
    rsd.is_encrypted = int(rsd.encryption_mode > 0 and not is_decrypted)
    rsd.rand_acc_flag = c.u(1)
    rsd.macpdu_length = _decode_length(c.u(6))
    rsd.addr.type = c.u(3)
    at = rsd.addr.type
    base = c.pos
    if at == AddrType.NULL:
        rsd.bit_len = 0
        return rsd
    if at in (AddrType.SSI, AddrType.USSI, AddrType.SMI):
        rsd.addr.ssi = bits_to_uint(c.bits[base:base + 24])
    elif at == AddrType.EVENT_LABEL:
        rsd.addr.event_label = bits_to_uint(c.bits[base:base + 10])
    elif at in (AddrType.SSI_EVENT, AddrType.SMI_EVENT):
        rsd.addr.ssi = bits_to_uint(c.bits[base:base + 24])
        rsd.addr.event_label = bits_to_uint(c.bits[base + 24:base + 34])
    elif at == AddrType.SSI_USAGE:
        rsd.addr.ssi = bits_to_uint(c.bits[base:base + 24])
        rsd.addr.usage_marker = bits_to_uint(c.bits[base + 24:base + 30])
    else:
        rsd.bit_len = -1
        return rsd
    c.skip(ADDR_LEN_BY_TYPE[AddrType(at)])
    rsd.power_control_pres = c.u(1)
    if rsd.power_control_pres:
        c.skip(4)
    rsd.slot_granting_pres = c.u(1)
    if rsd.slot_granting_pres:
        rsd.slot_granting_nr_slots = _decode_nr_slots(c.u(4))
        rsd.slot_granting_delay = c.u(4)
    rsd.chan_alloc_pres = c.u(1)
    if rsd.chan_alloc_pres and not rsd.is_encrypted:
        cad = decode_chan_alloc(c.bits[c.pos:])
        rsd.cad = cad
        c.skip(cad.bit_len)
    rsd.bit_len = c.pos
    return rsd


@dataclass
class AccessField:
    access_code: int = 0
    base_frame_len: int = 0


@dataclass
class AccessAssignDecoded:
    hdr: int = 0
    dl_usage: int = -1
    ul_usage: int = -1
    access1: AccessField | None = None
    access2: AccessField | None = None


def decode_access_assign(bits, fn18: bool) -> AccessAssignDecoded:
    """ACCESS-ASSIGN PDU, 21.4.7.2 (reference tetra_mac_pdu.c:257-330)."""
    aad = AccessAssignDecoded()
    bits = np.asarray(bits)
    aad.hdr = bits_to_uint(bits[0:2])
    f1 = bits_to_uint(bits[2:8])
    f2 = bits_to_uint(bits[8:14])

    def acc(fld):
        return AccessField(access_code=(fld >> 4) & 3, base_frame_len=fld & 0xF)

    if not fn18:
        if aad.hdr == 0:  # DLCC/ULCO
            aad.access1, aad.access2 = acc(f1), acc(f2)
        elif aad.hdr in (1, 2):  # DLF1/ULCA, DLF1/ULAO
            aad.dl_usage = f1
            aad.access2 = acc(f2)
        else:  # DLF1/ULF1
            aad.dl_usage = f1
            aad.ul_usage = f2
    else:
        if aad.hdr in (0, 1, 2):
            aad.access1, aad.access2 = acc(f1), acc(f2)
        else:  # ULCA2: field1 = traffic usage marker (unhandled like reference)
            aad.access2 = acc(f2)
    return aad
