"""Native control-plane executor bindings.

Copy of tetra_tpu.umac.native_exec, kept in the port so that it imports nothing of
the JAX package; tests/test_torch_tables.py holds it to the original.

native/umac_exec.cpp ports the hot upper-MAC / LLC / MLE slot loop
(reference src/tetra_upper_mac.c:457-547 semantics, behaviour mirrored
from tetra_tpu/umac/upper_mac.py) to batch C++: it consumes per-slot
type-1 bit records and emits compact structured events. The Python
implementation stays the semantics reference; tests/test_native_umac.py
differential-tests the two event streams.

Decryption runs on the native hot path (reference
src/tetra_crypto.c:211-252): load a keystore with set_keys and
encrypted MAC elements decrypt in C++ via the batch TEA core — no
Python fallback needed for encrypted carriers.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess

import numpy as np

__all__ = ["available", "NativeControlPlane", "EV", "normalize_py_events",
           "SlotRec"]

_NATIVE_DIR = pathlib.Path(__file__).parent.parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libtetra_native.so"
_lib = None
_tried = False


class EV:
    """Event kinds (mirror of native/umac_exec.cpp EvKind)."""
    TMV = 0
    AACH = 1
    SYSINFO = 2
    RESOURCE = 3
    FRAG_START = 4
    FRAG_CONT = 5
    FRAG_END = 6
    FRAG_AGEOUT = 7
    FRAG_NOSTART = 8
    FRAG_ACTIVE = 9
    SUPPL = 10
    TMSDU = 11
    TLSDU = 12
    STRANGE_PDU = 13
    STRANGE_LCHAN = 14
    MISS = 15
    TMSDU_RUNT = 16
    TRAFFIC = 17
    CRC = 18
    GSMTAP = 19

    NAMES = {0: "TMV", 1: "AACH", 2: "SYSINFO", 3: "RESOURCE",
             4: "FRAG_START", 5: "FRAG_CONT", 6: "FRAG_END",
             7: "FRAG_AGEOUT", 8: "FRAG_NOSTART", 9: "FRAG_ACTIVE",
             10: "SUPPL", 11: "TMSDU", 12: "TLSDU", 13: "STRANGE_PDU",
             14: "STRANGE_LCHAN", 15: "MISS", 16: "TMSDU_RUNT",
             17: "TRAFFIC", 18: "CRC", 19: "GSMTAP"}


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        # make is a fast no-op when the library is current; rebuilds it
        # after source changes or on first use
        subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                       capture_output=True, timeout=180)
    except Exception:
        pass
    if not _LIB_PATH.exists():
        return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    lib.tetra_umac_create.argtypes = [ctypes.c_int]
    lib.tetra_umac_create.restype = ctypes.c_void_p
    lib.tetra_umac_destroy.argtypes = [ctypes.c_void_p]
    lib.tetra_umac_process.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int32)]
    lib.tetra_umac_process.restype = ctypes.c_int64
    lib.tetra_umac_walk.argtypes = lib.tetra_umac_process.argtypes
    lib.tetra_umac_walk.restype = ctypes.c_int64
    lib.tetra_umac_walk2.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.tetra_umac_walk2.restype = ctypes.c_int64
    lib.tetra_umac_payload_bound.argtypes = [ctypes.c_void_p,
                                             ctypes.c_int64]
    lib.tetra_umac_payload_bound.restype = ctypes.c_int64
    lib.tetra_umac_get_states.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32)]
    lib.tetra_umac_get_states.restype = None
    lib.tetra_umac_set_keys.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int32), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.tetra_umac_set_keys.restype = None
    lib.tetra_umac_set_gsmtap.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.tetra_umac_set_gsmtap.restype = None
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def SlotRec(carrier, lchan, crc_ok, blk_num, tn, fn, mn, offset, length):
    """One slot record (9 int32 fields, see umac_exec.cpp)."""
    return (carrier, lchan, crc_ok, blk_num, tn, fn, mn, offset, length)


class NativeControlPlane:
    """Batched upper-MAC/LLC/MLE executor over per-carrier state."""

    def __init__(self, n_carriers: int):
        lib = _load()
        if lib is None:
            raise RuntimeError("native control plane unavailable "
                               "(libtetra_native.so failed to build/load)")
        self._lib = lib
        self._ctx = lib.tetra_umac_create(n_carriers)
        self.n_carriers = n_carriers

    def close(self):
        if self._ctx:
            self._lib.tetra_umac_destroy(self._ctx)
            self._ctx = None

    def set_keys(self, db):
        """Load a crypto.CryptoDatabase into the executor (reference
        keystore database, tetra_crypto.c:284-379): encrypted MAC
        elements then decrypt on the native hot path."""
        nets = np.asarray([(n.mcc, n.mnc, n.ksg_type, n.security_class)
                           for n in db.nets], np.int32).reshape(-1, 4)
        keys = np.asarray([(k.mcc, k.mnc, k.key_type, k.key_num)
                           for k in db.keys], np.int32).reshape(-1, 4)
        keybytes = np.frombuffer(
            b"".join(bytes(k.key[:10]).ljust(10, b"\0") for k in db.keys),
            np.uint8) if db.keys else np.zeros(0, np.uint8)
        nets = np.ascontiguousarray(nets)
        keys = np.ascontiguousarray(keys)
        keybytes = np.ascontiguousarray(keybytes)
        p32 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        p8 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        self._lib.tetra_umac_set_keys(self._ctx, p32(nets), len(nets),
                                      p32(keys), len(keys), p8(keybytes))

    def set_gsmtap(self, on: bool = True):
        """Emit EV.GSMTAP per CRC-OK TMV dispatch (walk2 path); the
        caller packetises via io.gsmtap (reference
        tetra_upper_mac.c:483-488 hook)."""
        self._lib.tetra_umac_set_gsmtap(self._ctx, 1 if on else 0)

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass

    def process(self, bits: np.ndarray, recs, events_per_rec: int = 24):
        """bits: concatenated unpacked type-1 bits (uint8, 1 byte/bit);
        recs: [n, 9] int32 records (see SlotRec). Returns a structured
        dict of event arrays {carrier, kind, a, b, c, d} of length m."""
        return self._run("tetra_umac_process", bits, recs, 9,
                         events_per_rec)

    def walk(self, bits: np.ndarray, recs, events_per_rec: int = 32):
        """Whole-slot walk (rx.py::_walk_slot semantics in C++): recs
        [n, 14] int32 = carrier, kind (0 SYNC/1 SCHF/2 NDB), tn, fn, mn,
        okA, okB, offA, lenA, offBBK, lenBBK, offB, lenB, slot_ref.
        Traffic slots emit EV.TRAFFIC(slot_ref, ndb_flag, usage) for the
        caller to dump; FEC blocks emit EV.CRC for stats."""
        return self._run("tetra_umac_walk", bits, recs, 14, events_per_rec)

    def walk2(self, bits: np.ndarray, recs, tails,
              events_per_rec: int = 32):
        """Self-clocked walk: TDMA time + SYNC side effects run in C++
        (native/umac_exec.cpp::tetra_umac_walk2). bits: concatenated
        408-column packed-decode rows (ubits); recs [n, 7] int32 =
        carrier, kind, okA, okB, burst_delta, row, slot_ref; tails [B]
        per-carrier trailing TDMA advances.

        The returned dict carries a TL-SDU payload arena: every
        EV.TLSDU event's d field is (arena_bit_offset << 1) |
        from_defrag, indexing `payload` ubits of length c — the
        host-side egress surface for TUN (SNDCP IP) and SDS sinks
        (reference tetra_llc.c:81-107)."""
        bits = np.ascontiguousarray(bits, dtype=np.uint8)
        recs = np.ascontiguousarray(recs, dtype=np.int32).reshape(-1, 7)
        tails = np.ascontiguousarray(tails, dtype=np.int32)
        n = len(recs)
        cap = n * events_per_rec + 1024
        car = np.empty(cap, np.int32)
        kind = np.empty(cap, np.int32)
        a = np.empty(cap, np.int64)
        b = np.empty(cap, np.int64)
        c = np.empty(cap, np.int64)
        d = np.empty(cap, np.int64)
        ovf = ctypes.c_int32(0)
        pay_cap = int(self._lib.tetra_umac_payload_bound(
            self._ctx, int(bits.size)))
        pay = np.empty(pay_cap, np.uint8)
        pay_n = ctypes.c_int64(0)
        p8 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        p32 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        p64 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        m = self._lib.tetra_umac_walk2(
            self._ctx, p8(bits), p32(recs), n, p32(tails), len(tails),
            p32(car), p32(kind), p64(a), p64(b), p64(c), p64(d),
            cap, ctypes.byref(ovf), p8(pay), pay_cap,
            ctypes.byref(pay_n))
        if ovf.value & 1:
            raise RuntimeError("native event buffer overflow; raise "
                               "events_per_rec")
        if ovf.value & 2:  # pragma: no cover - bound is provably wide
            raise RuntimeError("native payload arena overflow")
        return {"carrier": car[:m], "kind": kind[:m], "a": a[:m],
                "b": b[:m], "c": c[:m], "d": d[:m],
                "payload": pay[:pay_n.value]}

    def get_states(self) -> np.ndarray:
        """Per-carrier walk2 state [B, 6] int32: tn fn mn colour mcc
        mnc."""
        out = np.zeros((self.n_carriers, 6), np.int32)
        self._lib.tetra_umac_get_states(
            self._ctx, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
        return out

    def _run(self, fn_name, bits, recs, rec_width, events_per_rec):
        bits = np.ascontiguousarray(bits, dtype=np.uint8)
        recs = np.ascontiguousarray(recs, dtype=np.int32).reshape(
            -1, rec_width)
        n = len(recs)
        cap = n * events_per_rec + 1024
        car = np.empty(cap, np.int32)
        kind = np.empty(cap, np.int32)
        a = np.empty(cap, np.int64)
        b = np.empty(cap, np.int64)
        c = np.empty(cap, np.int64)
        d = np.empty(cap, np.int64)
        ovf = ctypes.c_int32(0)
        p8 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        p32 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))
        p64 = lambda x: x.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
        m = getattr(self._lib, fn_name)(
            self._ctx, p8(bits), p32(recs), n,
            p32(car), p32(kind), p64(a), p64(b), p64(c), p64(d),
            cap, ctypes.byref(ovf))
        if ovf.value:
            raise RuntimeError("native event buffer overflow; raise "
                               "events_per_rec")
        return {"carrier": car[:m], "kind": kind[:m], "a": a[:m],
                "b": b[:m], "c": c[:m], "d": d[:m]}

    def events_as_tuples(self, ev) -> list:
        return [(int(ev["carrier"][i]), int(ev["kind"][i]), int(ev["a"][i]),
                 int(ev["b"][i]), int(ev["c"][i]), int(ev["d"][i]))
                for i in range(len(ev["kind"]))]


# ---- Python-side event normalization (for differential testing) ----

def normalize_py_events(carrier: int, events: list) -> list:
    """Convert instrumented Python events (UpperMac.events entries, LLC
    event_cb tuples, and ("TLSDU", pdisc, pdut, len) entries captured by
    the test's tl_sdu_cb) to the native executor's (carrier, kind, a, b,
    c, d) tuples."""
    out = []

    def emit(kind, a=0, b=0, c=0, d=0):
        out.append((carrier, kind, int(a), int(b), int(c), int(d)))

    for e in events:
        tag = e[0]
        if tag == "TMV":
            emit(EV.TMV, e[1], e[2], e[3])
        elif tag == "AACH":
            aad = e[1]
            a1 = ((aad.access1.access_code << 4) | aad.access1.base_frame_len
                  ) if aad.access1 is not None else 255
            a2 = ((aad.access2.access_code << 4) | aad.access2.base_frame_len
                  ) if aad.access2 is not None else 255
            emit(EV.AACH, aad.hdr, aad.dl_usage, aad.ul_usage,
                 (a1 << 8) | a2)
        elif tag == "SYSINFO":
            sid = e[1]
            val16 = sid.cck_id if sid.cck_valid_no_hf else sid.hyperframe_number
            emit(EV.SYSINFO, sid.main_carrier,
                 sid.freq_band * 16 + sid.freq_offset,
                 (sid.cck_valid_no_hf << 32) | val16,
                 (sid.mle_si.la << 12) | sid.mle_si.bs_service_details)
        elif tag == "RESOURCE":
            rsd, l2len = e[1], e[2]
            at = rsd.addr.type
            if at in (1, 3, 4):
                val = rsd.addr.ssi
            elif at == 2:
                val = rsd.addr.event_label
            elif at in (5, 7):
                val = (rsd.addr.ssi << 10) | rsd.addr.event_label
            elif at == 6:
                val = (rsd.addr.ssi << 6) | rsd.addr.usage_marker
            else:
                val = 0
            emit(EV.RESOURCE, at, val, rsd.macpdu_length,
                 (l2len << 1) | rsd.is_encrypted)
        elif tag == "FRAG_START":
            emit(EV.FRAG_START, e[1], e[2])
        elif tag == "FRAG_CONT":
            emit(EV.FRAG_CONT, e[1], e[2])
        elif tag == "FRAG_END":
            emit(EV.FRAG_END, e[1], e[2], e[3])
        elif tag == "FRAG_AGEOUT":
            emit(EV.FRAG_AGEOUT, e[1], e[2], e[3])
        elif tag == "FRAG_NOSTART":
            emit(EV.FRAG_NOSTART, e[1], e[2])
        elif tag == "FRAG_ACTIVE":
            emit(EV.FRAG_ACTIVE, e[1])
        elif tag == "SUPPL":
            emit(EV.SUPPL, e[1])
        elif tag == "TMSDU":
            emit(EV.TMSDU, e[1], (e[2] << 8) | e[3], e[4], e[5])
        elif tag == "TMSDU_RUNT":
            emit(EV.TMSDU_RUNT, e[1])
        elif tag == "MISS":
            emit(EV.MISS, e[1], e[2])
        elif tag == "TLSDU":
            emit(EV.TLSDU, e[1], e[2], e[3])
        elif tag == "STRANGE_PDU":
            emit(EV.STRANGE_PDU, e[1])
        elif tag == "STRANGE_LCHAN":
            emit(EV.STRANGE_LCHAN, e[1])
        elif tag in ("DECRYPT", "SKIP216", "CRYPTO_NOTB5", "CCK_INVOKED",
                     "CCK_SET"):
            pass  # crypto observability events (ref-parity only)
        else:  # pragma: no cover
            raise ValueError(f"unknown python event {tag}")
    return out
