"""TAA1 authentication & key-management algorithm suite.

Frozen copy of the port's copy of tetra_tpu.crypto.taa1 (the benchmark's
reference: it imports nothing of the program). The port's copy is
held to the JAX package's original by the port's CPU tests.

Reference behaviour: src/crypto/taa1.c — the TA11/TA41, TA12/TA22,
TA21, TA31/TA32 (CCK seal), TA51/TA52 (SCK seal), TA71 (MGCK), TA81/82
and TA91/92 (GCK/GSKO seal) primitives, plus the TBx transforms.
TB5 (ECK derivation) is the one used on the receive hot path.
"""
from __future__ import annotations

from portbench.reference.walk import hurdle

__all__ = [
    "ta11_ta41", "ta12_ta22", "ta21", "ta31", "ta32", "ta51", "ta52",
    "ta71", "ta81", "ta82", "ta91", "ta92", "tb4", "tb5", "tb6", "tb7",
]


def _t80_to_120(b: bytes) -> bytearray:
    out = bytearray(15)
    for i in range(5):
        out[3 * i] = (b[i] + b[9 - i]) & 0xFF
        out[3 * i + 1] = b[i]
        out[3 * i + 2] = b[9 - i]
    return out


def _t80_to_128(b: bytes) -> bytes:
    mid = _t80_to_120(b)
    out = bytearray(16)
    out[1:16] = mid
    out[0] = out[1] ^ out[4] ^ out[7] ^ out[10] ^ out[13]
    return bytes(out)


def _t80_to_120_alt(b: bytes) -> bytearray:
    out = bytearray(15)
    for i in range(5):
        out[3 * i] = b[2 * i]
        out[3 * i + 1] = b[2 * i + 1]
        out[3 * i + 2] = b[2 * i] ^ b[2 * i + 1]
    return out


def _t80_to_128_alt(b: bytes) -> bytes:
    out = bytearray(16)
    out[0:15] = _t80_to_120_alt(b)
    out[15] = (out[2] + out[5] + out[8] + out[11] + out[14]) & 0xFF
    return bytes(out)


def _t88_to_120(b: bytes) -> bytes:
    out = bytearray(15)
    out[0], out[1] = b[0], b[1]
    out[2] = b[0] ^ b[1]
    out[3], out[4], out[5] = b[2], b[3], b[4]
    out[6] = b[2] ^ b[3] ^ b[4]
    out[7], out[8], out[9] = b[5], b[6], b[7]
    out[10] = b[5] ^ b[6] ^ b[7]
    out[11], out[12], out[13] = b[8], b[9], b[10]
    out[14] = b[8] ^ b[9] ^ b[10]
    return bytes(out)


def _t120_to_88(b: bytes) -> bytes:
    idx = (0, 1, 3, 4, 5, 7, 8, 9, 11, 12, 13)
    return bytes(b[i] for i in idx)


def _t120_to_80_alt(b: bytes) -> bytes:
    idx = (0, 1, 3, 4, 6, 7, 9, 10, 12, 13)
    return bytes(b[i] for i in idx)


def _steal(ct16: bytes) -> bytes:
    """2-block CBC ciphertext -> 15-byte sealed blob (taa1.c:187-189)."""
    return ct16[0:7] + ct16[8:16]


def ta11_ta41(key_k: bytes, challenge_rs: bytes) -> bytes:
    """KS/KS' derivation (taa1.c:130-135)."""
    return hurdle.enc_cbc(_t80_to_128_alt(challenge_rs), key_k)


def ta12_ta22(key_ks: bytes, rand: bytes) -> tuple[bytes, bytes]:
    """(X)RES + DCK derivation (taa1.c:137-159). Returns (res4, dck10)."""
    ct = hurdle.enc_cbc(_t80_to_128_alt(rand), key_ks)
    res = bytes((ct[0] ^ ct[3], ct[6], ct[9], ct[12] ^ ct[15]))
    dck = bytes((ct[1], ct[2], ct[4], ct[5], ct[7], ct[8], ct[10], ct[11], ct[13], ct[14]))
    return res, dck


def ta21(key_k: bytes, challenge_rs: bytes) -> bytes:
    """KS' from reversed challenge (taa1.c:161-172)."""
    rev = bytes(reversed(challenge_rs[:10]))
    return hurdle.enc_cbc(_t80_to_128_alt(rev), key_k)


def ta31(cck: bytes, cck_id: bytes, dck: bytes) -> bytes:
    """Seal CCK (taa1.c:174-193)."""
    pt = _t80_to_120_alt(cck)
    pt16 = bytes(pt) + b"\x00"
    adj = bytes(dck[i] ^ cck_id[i & 1] for i in range(10))
    return _steal(hurdle.enc_cbc(pt16, _t80_to_128(adj)))


def ta32(sealed: bytes, cck_id: bytes, dck: bytes) -> tuple[bytes, int]:
    """Unseal CCK (taa1.c:195-216). Returns (cck10, manipulation_flag)."""
    adj = bytes(dck[i] ^ cck_id[i & 1] for i in range(10))
    pt = hurdle.dec_cts(sealed, _t80_to_128(adj))
    mf = int(
        ((pt[0] ^ pt[1]) != pt[2]) or ((pt[3] ^ pt[4]) != pt[5]) or
        ((pt[6] ^ pt[7]) != pt[8]) or ((pt[9] ^ pt[10]) != pt[11]) or
        ((pt[12] ^ pt[13]) != pt[14]))
    return _t120_to_80_alt(pt), mf


def ta51(unsealed: bytes, vn: bytes, key: bytes, key_n: int) -> bytes:
    """Seal SCK (taa1.c:218-240)."""
    assert (key_n & 0xE0) == 0
    pt = _t88_to_120(unsealed[:10] + bytes([key_n]))
    pt16 = pt + b"\x00"
    adj = bytes(key[i] ^ vn[i & 1] for i in range(16))
    return _steal(hurdle.enc_cbc(pt16, adj))


def ta52(sealed: bytes, key: bytes, vn: bytes) -> tuple[bytes, int, int]:
    """Unseal SCK (taa1.c:242-265). Returns (sck10, mf, key_n)."""
    adj = bytes(key[i] ^ vn[i & 1] for i in range(16))
    pt = hurdle.dec_cts(sealed, adj)
    un = _t120_to_88(pt)
    mf = int(
        ((pt[0] ^ pt[1]) != pt[2]) or
        ((pt[3] ^ pt[4] ^ pt[5]) != pt[6]) or
        ((pt[7] ^ pt[8] ^ pt[9]) != pt[10]) or
        ((pt[11] ^ pt[12] ^ pt[13]) != pt[14]) or
        bool(un[10] & 0xE0))
    return un[:10], mf, un[10]


def ta71(gck: bytes, cck: bytes) -> bytes:
    """MGCK derivation (taa1.c:299-330)."""
    pt = bytes(gck[i] ^ cck[i] for i in range(10))
    key = bytes(list(gck[0:6])
                + [gck[6 + i] ^ cck[i] for i in range(4)]
                + list(cck[4:10]))
    ct = hurdle.enc_cbc(_t80_to_128_alt(pt), key)
    return ct[3:13]


def ta81(gck: bytes, gck_vn: bytes, gck_n: bytes, key: bytes) -> bytes:
    """Seal GCK (taa1.c:332-361)."""
    pt = bytearray(16)
    pt[0:4] = gck[0:4]
    pt[4] = pt[0] ^ pt[1] ^ pt[2] ^ pt[3]
    pt[5:9] = gck[4:8]
    pt[9] = pt[5] ^ pt[6] ^ pt[7] ^ pt[8]
    pt[10:12] = gck[8:10]
    pt[12:14] = gck_n[0:2]
    pt[14] = pt[10] ^ pt[11] ^ pt[12] ^ pt[13]
    pt[15] = 0
    adj = bytes(key[i] ^ gck_vn[i & 1] for i in range(16))
    return _steal(hurdle.enc_cbc(bytes(pt), adj))


def ta82(sealed: bytes, gck_vn: bytes, key: bytes) -> tuple[bytes, int, bytes]:
    """Unseal GCK (taa1.c:363-366...). Returns (gck10, mf, gck_n2)."""
    adj = bytes(key[i] ^ gck_vn[i & 1] for i in range(16))
    pt = hurdle.dec_cts(sealed, adj)
    gck = bytes(pt[i] for i in (0, 1, 2, 3, 5, 6, 7, 8, 10, 11))
    gck_n = bytes((pt[12], pt[13]))
    mf = int(
        (pt[14] != (pt[10] ^ pt[11] ^ pt[12] ^ pt[13])) or
        (pt[9] != (pt[5] ^ pt[6] ^ pt[7] ^ pt[8])) or
        (pt[4] != (pt[0] ^ pt[1] ^ pt[2] ^ pt[3])))
    return gck, mf, gck_n


def ta91(gsko12: bytes, gsko_vn: bytes, key: bytes) -> bytes:
    """Seal GSKO: TA81 aliased with gsko[10:12] as N (taa1.c:368-371)."""
    return ta81(gsko12[:10], gsko_vn, gsko12[10:12], key)


def ta92(sealed: bytes, gsko_vn: bytes, key: bytes) -> tuple[bytes, int]:
    """Unseal GSKO (taa1.c:374-378). Returns (gsko12, mf)."""
    g, mf, n = ta82(sealed, gsko_vn, key)
    return g + n, mf


def tb4(dck1: bytes, dck2: bytes) -> bytes:
    """DCK combine (taa1.c:423-428)."""
    return bytes(a ^ b for a, b in zip(dck1[:10], dck2[:10]))


def tb5(cn: int, la: int, cc: int, ck: bytes) -> bytes:
    """ECK derivation — the rx hot-path primitive (taa1.c:430-454).

    Overlays [la:14 cn:12 cc:6 cn:12 cc:6 cn:12 cc:6 cn:12] over the
    80-bit CK.
    """
    assert (cn & ~0xFFF) == 0 and (la & ~0x3FFF) == 0 and (cc & ~0x3F) == 0
    ck0 = int.from_bytes(ck[0:2], "big")
    ck1 = int.from_bytes(ck[2:6], "big")
    ck2 = int.from_bytes(ck[6:10], "big")
    m0 = ((la << 2) | (cn >> 10)) & 0xFFFF
    m1 = ((cn << 22) | (cc << 16) | (cn << 4) | (cc >> 2)) & 0xFFFFFFFF
    m2 = ((cc << 30) | (cn << 18) | (cc << 12) | cn) & 0xFFFFFFFF
    return ((ck0 ^ m0).to_bytes(2, "big")
            + (ck1 ^ m1).to_bytes(4, "big")
            + (ck2 ^ m2).to_bytes(4, "big"))


def tb6(sck: bytes, cn: int, ssi: int) -> bytes:
    """ECK from SCK/SSI for DMO (taa1.c:456-...)."""
    s0 = int.from_bytes(sck[0:2], "big")
    s1 = int.from_bytes(sck[2:6], "big")
    s2 = int.from_bytes(sck[6:10], "big")
    m0 = ((cn << 4) | (ssi >> 20)) & 0xFFFF
    m1 = ((ssi << 12) | cn) & 0xFFFFFFFF
    m2 = ((ssi << 8) | (ssi & 0xFF)) & 0xFFFFFFFF
    return ((s0 ^ m0).to_bytes(2, "big")
            + (s1 ^ m1).to_bytes(4, "big")
            + (s2 ^ m2).to_bytes(4, "big"))


def tb7(gsko12: bytes) -> bytes:
    """EGSKO expansion (taa1.c: tb7)."""
    out = bytearray(16)
    for i in range(4):
        out[4 * i:4 * i + 3] = gsko12[3 * i:3 * i + 3]
        out[4 * i + 3] = gsko12[3 * i] ^ gsko12[3 * i + 1] ^ gsko12[3 * i + 2]
    return bytes(out)
