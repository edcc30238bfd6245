"""Crypto state, keystore, IV construction, keystream service.

Copy of tetra_tpu.crypto.crypto, kept in the port so that it imports nothing of
the JAX package; tests/test_torch_tables.py holds it to the original.

Reference behaviour: src/crypto/tetra_crypto.c — key/network database
with a text keystore format, crypto state tracked from SYNC/SYSINFO,
IV from TDMA time, ECK via TB5, keystream via TEA1/2/3, MAC-element and
voice-timeslot decrypt with the 216-bit second-half-slot skip.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from enum import IntEnum

import numpy as np

from tetra_tpu_torch.crypto import tea, taa1

__all__ = [
    "KeyType", "KsgType", "SecurityClass", "TetraKey", "TetraNetinfo",
    "CryptoState", "CryptoDatabase", "load_keystore", "tea_build_iv",
    "generate_keystream", "decrypt_mac_element", "decrypt_voice_timeslot",
]


class KeyType(IntEnum):
    UNDEFINED = 0
    CCK_SCK = 1
    DCK = 2
    MGCK = 4
    GCK = 8


class KsgType(IntEnum):
    UNKNOWN = 0
    TEA1 = 1
    TEA2 = 2
    TEA3 = 3
    TEA4 = 4
    TEA5 = 5
    TEA6 = 6
    TEA7 = 7
    PROPRIETARY = 8


class SecurityClass(IntEnum):
    UNDEFINED = 0
    CLASS_1 = 1
    CLASS_2 = 2
    CLASS_3 = 3


@dataclass
class TetraNetinfo:
    mcc: int
    mnc: int
    ksg_type: int
    security_class: int


@dataclass
class TetraKey:
    index: int
    mcc: int
    mnc: int
    key_type: int
    key_num: int
    addr: int
    key: bytes                      # 80-bit (10 bytes)
    network_info: TetraNetinfo | None = None


@dataclass
class CryptoDatabase:
    keys: list = field(default_factory=list)
    nets: list = field(default_factory=list)

    def get_network_info(self, mcc: int, mnc: int) -> TetraNetinfo | None:
        for n in self.nets:
            if n.mcc == mcc and n.mnc == mnc:
                return n
        return None


@dataclass
class CryptoState:
    """(reference tetra_crypto.h:94-104 + tetra_crypto.c:92-107)."""
    mnc: int = -1
    mcc: int = -1
    cck_id: int = -1
    hn: int = -1
    la: int = -1
    # the reference's init function skips cn, leaving it 0 from the
    # zeroed allocation (tetra_crypto.c:92-106) — mirrored here so the
    # la/cc guards alone gate TB5, exactly as in decrypt_mac_element
    cn: int = 0
    cc: int = -1
    network: TetraNetinfo | None = None
    cck: TetraKey | None = None
    db: CryptoDatabase = field(default_factory=CryptoDatabase)
    # optional observability hook: called with structured tuples
    # mirroring the reference's tetra_crypto printfs, so differential
    # tests can diff key-selection decisions line by line
    event_cb: object = None

    def update_current_network(self, mcc: int, mnc: int):
        """(reference tetra_crypto.c:416-436)."""
        self.mcc, self.mnc = mcc, mnc
        self.network = self.db.get_network_info(mcc, mnc)
        self.update_current_cck()

    def update_current_cck(self):
        """(reference tetra_crypto.c:438-452)."""
        if self.event_cb:
            self.event_cb(("CCK_INVOKED", self.cck_id, self.mcc, self.mnc))
        self.cck = None
        for key in self.db.keys:
            if (key.mcc == self.mcc and key.mnc == self.mnc
                    and key.key_num == self.cck_id
                    and key.key_type == KeyType.CCK_SCK):
                self.cck = key
                if self.event_cb:
                    self.event_cb(("CCK_SET", key.index))
                break

    def get_ksg_key(self, addr: int) -> TetraKey | None:
        """(reference tetra_crypto.c:395-414)."""
        if not self.network:
            return None
        return self.cck


def load_keystore(path: str, db: CryptoDatabase | None = None) -> CryptoDatabase:
    """Parse the reference's text keystore format (tetra_crypto.c:284-379).

    Lines: '# comment', 'network mcc M mnc N ksg_type K security_class S',
    'key mcc M mnc N addr A key_type T key_num V key <20-hex-digits>'.
    """
    db = db or CryptoDatabase()
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            kv = dict(zip(tok[1::2], tok[2::2]))
            if tok[0] == "network":
                db.nets.append(TetraNetinfo(
                    mcc=int(kv["mcc"]), mnc=int(kv["mnc"]),
                    ksg_type=int(kv["ksg_type"]),
                    security_class=int(kv["security_class"])))
            elif tok[0] == "key":
                db.keys.append(TetraKey(
                    index=len(db.keys), mcc=int(kv["mcc"]), mnc=int(kv["mnc"]),
                    addr=int(kv["addr"]), key_type=int(kv["key_type"]),
                    key_num=int(kv["key_num"]), key=bytes.fromhex(kv["key"])[:10]))
            else:
                raise ValueError(f"keystore: cannot parse line: {line}")
    for key in db.keys:
        ni = db.get_network_info(key.mcc, key.mnc)
        if ni is None:
            raise ValueError(f"keystore: missing network info for MNC {key.mnc}")
        key.network_info = ni
    return db


def tea_build_iv(tn: int, fn: int, mn: int, hn: int, direction: int) -> int:
    """IV from TDMA time (reference tetra_crypto.c:148-156)."""
    assert 1 <= tn <= 4 and 1 <= fn <= 18 and 1 <= mn <= 60
    assert 0 <= direction <= 1
    return ((tn - 1) | (fn << 2) | (mn << 7)
            | ((hn & 0x7FFF) << 13) | (direction << 28))


_KSGS = {KsgType.TEA1: tea.tea1, KsgType.TEA2: tea.tea2, KsgType.TEA3: tea.tea3}


def generate_keystream(tcs: CryptoState, key: TetraKey, time, num_bits: int) -> np.ndarray | None:
    """Keystream ubits for a slot (reference tetra_crypto.c:158-203).

    `time` provides tn/fn/mn attributes (TdmaTime or equivalent).
    """
    if key is None:
        return None
    if tcs.cn < 0 or tcs.la < 0 or tcs.cc < 0:
        return None
    nbytes = (num_bits + 7) // 8
    iv = tea_build_iv(time.tn, time.fn, time.mn, tcs.hn, 0)
    eck = taa1.tb5(tcs.cn & 0xFFF, tcs.la & 0x3FFF, tcs.cc & 0x3F, key.key)
    ksg_type = key.network_info.ksg_type
    if ksg_type not in _KSGS:
        return None
    # native batch core when available (tetra_tpu_torch/crypto/native.py),
    # pure-Python otherwise — bit-identical either way
    from tetra_tpu_torch.crypto import native
    ks_bytes = bytes(native.tea_keystream_batch(
        int(ksg_type), np.asarray([iv], np.uint32),
        np.frombuffer(eck, np.uint8).reshape(1, 10), nbytes)[0])
    return np.unpackbits(np.frombuffer(ks_bytes, dtype=np.uint8))[:num_bits]


def decrypt_mac_element(tcs: CryptoState, key: TetraKey, bits, time,
                        tmpdu_offset: int, lchan_second_half: bool = False,
                        event_cb=None):
    """XOR-decrypt a MAC element in place semantics (returns new array).

    Mirrors tetra_crypto.c:211-252 including the 216-bit keystream skip
    for second-half-slot SCH/HD blocks. Returns (bits, ok).  `event_cb`
    receives structured tuples at exactly the points the reference
    printfs (tetra_crypto.c:217-219, 232, 248-249) for differential
    parity against the compiled reference's stdout.
    """
    bits = np.asarray(bits, dtype=np.uint8).copy()
    l1_len = len(bits)
    ct_len = l1_len - tmpdu_offset
    if key is None or ct_len <= 0:
        return bits, False
    if tcs.cn < 0 or tcs.la < 0 or tcs.cc < 0:
        if event_cb:
            event_cb(("CRYPTO_NOTB5", tcs.cn, tcs.la, tcs.cc))
        return bits, False
    skip = 216 if lchan_second_half else 0
    if skip and event_cb:
        event_cb(("SKIP216",))
    ks = generate_keystream(tcs, key, time, skip + ct_len)
    if ks is None:
        return bits, False
    bits[tmpdu_offset:] ^= ks[skip:skip + ct_len]
    if event_cb:
        event_cb(("DECRYPT", key.addr, key.index, tcs.hn,
                  time.mn, time.fn, time.tn, tmpdu_offset, ct_len))
    return bits, True


def decrypt_voice_timeslot(tcs: CryptoState, time, type1_block):
    """Decrypt two half-slots of voice (reference tetra_crypto.c:254-282).

    type1_block: int16 soft block of 690 (sign-encoded bits); keystream
    bit 1 flips the sign.
    """
    key = tcs.cck
    blk = np.asarray(type1_block).copy()
    if key is None:
        return blk, False
    ks = generate_keystream(tcs, key, time, 137 * 2)
    if ks is None:
        return blk, False
    # XOR over the int16 sign-encoding: the reference XORs the int16
    # values with the 0/1 keystream bits directly
    blk[1:138] ^= ks[:137]
    blk[139:276] ^= ks[137:274]
    return blk, True
