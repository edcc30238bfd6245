"""TETRA receiver: bits in -> decoded PDUs out, the `tetra-rx` analogue
(port of tetra_tpu.rx), plus the per-slot result packing and the
traffic writer of the fast path.

Reference behaviour: src/tetra-rx.c + the per-slot callback chain
(tetra_burst_sync.c -> tetra_burst.c -> tetra_lower_mac.c -> upper MAC).

The stream is processed in large chunks:
1. one batched training-sequence correlation pass over the whole chunk
   (device) + a host walk for slot alignment (phy.sync.align_stream),
2. batched FEC decode of all aligned slots (decode_slots_multi, device:
   every SB1 first with kernel K1 at 80 steps on a card, since its
   decode reveals the cell scrambling code, which is forward-filled per
   slot; then every slot in one kind-compacted pass, K1 at 288 steps),
3. a host walk in stream order reproducing the reference's per-slot
   upper-MAC processing (umac.upper_mac, llc, mle, crypto), logging,
   GSMTAP export and traffic dumps, with the log lines, stats, TMV
   records and files of tetra_tpu's TetraReceiver.

The traffic writer (tetra_lower_mac.c:198-241, tetra_llc.c:93-101): per
traffic slot a 690-int16 soft block appended to traffic_<usage>_<tsn>.out,
the SSI to traffic_<usage>_<tsn>.txt and, with voice decode, the two
137-bit ACELP codec frames (decrypted when a keystream is known) packed
to 35 bytes in voice_<usage>_<tsn>.cod. The TCH/S decode runs kernel K6
on a card; the fast path decodes a chunk's slots in one batch per row
length (`voice_frames`). An NDB slot's 216-bit traffic row is dumped
and decoded with erasures where the JAX writer raises (`dump_blocks`).

CLI: python -m tetra_tpu_torch.rx [-f bits|float|iq] [-d DIR] [-k KEYS]
[-g [HOST]] [--voice] [--device DEV] capture
"""
from __future__ import annotations

import functools
import os
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tetra_tpu_torch import constants as C
from tetra_tpu_torch.crypto.crypto import CryptoState, generate_keystream, \
    load_keystore
from tetra_tpu_torch.device import resolve_device
from tetra_tpu_torch.io.gsmtap import GsmtapSink
from tetra_tpu_torch.llc.llc import LlcState
from tetra_tpu_torch.lmac import pipeline
from tetra_tpu_torch.lmac.fused import decode_slots_fused
from tetra_tpu_torch.lmac.steady import _bucket
from tetra_tpu_torch.mle.mle import rx_tl_sdu
from tetra_tpu_torch.ops import acelp
from tetra_tpu_torch.ops.crc import crc16_bits_np
from tetra_tpu_torch.ops.scramble import scramb_bits, scramb_get_init
from tetra_tpu_torch.phy import sync as sync_mod
from tetra_tpu_torch.phy.burst import split_norm_burst
from tetra_tpu_torch.tdma import TdmaTime
from tetra_tpu_torch.umac.upper_mac import LogicalChannel, TmvUnitdata, \
    UpperMac
from tetra_tpu_torch.utils import trace
from tetra_tpu_torch.utils.bits import bits_to_uint

__all__ = ["TetraReceiver", "RxStats", "is_bsch", "is_bnch",
           "decode_slots_multi", "main", "_pack_selected", "_PACK_BITS",
           "dump_blocks", "voice_frames", "append_files"]


def is_bsch(tm: TdmaTime) -> bool:
    """(reference tetra_lower_mac.c:115-120)."""
    return tm.fn == 18 and tm.tn == 4 - ((tm.mn + 1) % 4)


def is_bnch(tm: TdmaTime) -> bool:
    """(reference tetra_lower_mac.c:122-127)."""
    return tm.fn == 18 and tm.tn == 4 - ((tm.mn + 3) % 4)


@dataclass
class RxStats:
    slots: int = 0
    crc_ok: int = 0
    crc_wrong: int = 0
    bursts: int = 0


_PACK_A, _PACK_B, _PACK_BBK = 268, 124, 14
_PACK_BITS = _PACK_A + _PACK_B + _PACK_BBK          # 406 payload columns
_PACK_W = _PACK_BITS + 2                            # + okA, okB flags

# 690-int16 dump block: six sync markers 0x6B21 + i every 115 words and
# the type-4 bits as -127 (bit 1) / 127 (bit 0) in four spans (dst, src,
# n) (reference tetra_lower_mac.c:204-239)
_DUMP_SPANS = ((1, 0, 114), (116, 114, 114), (231, 228, 114), (346, 342, 90))


@functools.lru_cache(maxsize=4)
def _dump_index(width: int) -> tuple[np.ndarray, np.ndarray]:
    """(block positions, row positions) of the bits a `width`-bit row
    has."""
    pairs = [(d + i, s + i) for d, s, n in _DUMP_SPANS for i in range(n)
             if s + i < width]
    return np.asarray(pairs).T


def dump_blocks(type4: np.ndarray) -> np.ndarray:
    """Slots' type-4 bits [n, L] -> their 690-int16 dump blocks [n, 690].
    A 216-bit row (an NDB slot's second half) fills the positions it
    has; the rest stay 0 (erasure), as in its voice decode.
    (tetra_tpu.rx raises ValueError on such a row.)"""
    dst, src = _dump_index(type4.shape[1])
    block = np.zeros((type4.shape[0], 690), dtype=np.int16)
    block[:, 0:690:115] = 0x6B21 + np.arange(6)
    block[:, dst] = np.where(type4[:, src] != 0, -127, 127)
    return block


def voice_frames(rows: torch.Tensor, keystream: np.ndarray) -> np.ndarray:
    """Type-4 rows [n, L] (L = 432, or 216 for NDB halves; never mixed,
    since a pad bit would decode as +127 where the row has an erasure)
    -> the .cod bytes [n, 35]: the TCH/S decode (K6 on a card), the codec
    reordering to two 137-bit ACELP frames, XOR with keystream [n, 274]
    (zeros where the slot has none) and packing."""
    c0, c1, c2, _, _ = acelp.tch_s_decode(rows[:, :432])
    line = torch.cat([c0.to(torch.int8), c1, c2], dim=-1)
    codec = acelp.type2_to_codec(line).cpu().numpy().astype(np.uint8)
    return np.packbits(codec ^ keystream, axis=1)


def append_files(parts: dict) -> None:
    """{path: [bytes, ...]} -> each list appended to its file in order,
    one open per file."""
    for path, chunks in parts.items():
        fd = os.open(path, os.O_WRONLY | os.O_APPEND | os.O_CREAT, 0o644)
        try:
            data = memoryview(b"".join(chunks))
            while data:
                data = data[os.write(fd, data):]
        finally:
            os.close(fd)


def _pack_selected(res: dict, kinds: torch.Tensor) -> torch.Tensor:
    """Kind-select each slot's decoded blocks into ONE [n, 408] int8
    row: [A-block type1 (sb1/schf/ndb1, zero-padded to 268) | B-block
    type1 (sb2/-/ndb2, 124) | BBK type1 (14) | okA | okB]."""
    kk = kinds[:, None]

    def pad(x, w):
        return F.pad(x.to(torch.int8), (0, w - x.shape[-1]))

    zero = torch.zeros_like(res["sb2"].type1, dtype=torch.int8)
    t1a = torch.where(kk == 0, pad(res["sb1"].type1, _PACK_A),
                      torch.where(kk == 1, res["schf"].type1.to(torch.int8),
                                  pad(res["ndb1"].type1, _PACK_A)))
    t1b = torch.where(kk == 0, res["sb2"].type1.to(torch.int8),
                      torch.where(kk == 2, res["ndb2"].type1.to(torch.int8),
                                  zero))
    okA = torch.where(kinds == 0, res["sb1"].crc_ok,
                      torch.where(kinds == 1, res["schf"].crc_ok,
                                  res["ndb1"].crc_ok))
    okB = torch.where(kinds == 0, res["sb2"].crc_ok,
                      torch.where(kinds == 2, res["ndb2"].crc_ok,
                                  torch.zeros_like(okA)))
    return torch.cat([t1a, t1b, res["bbk"].type1.to(torch.int8),
                      okA[:, None].to(torch.int8),
                      okB[:, None].to(torch.int8)], dim=-1)


_KIND_OF = {C.TETRA_TRAIN_SYNC: 0, C.TETRA_TRAIN_NORM_1: 1,
            C.TETRA_TRAIN_NORM_2: 2}
_FIELD_MAP = {
    "SYNC": [("SB1", "sb1"), ("BBK", "bbk"), ("SB2", "sb2")],
    "SCHF": [("BBK", "bbk"), ("SCH_F", "schf")],
    "NDB": [("BBK", "bbk"), ("NDB1", "ndb1"), ("NDB2", "ndb2")],
}
_KNAME_OF = {0: "SYNC", 1: "SCHF", 2: "NDB"}


def decode_slots_multi(streams, slots_per, start_inits, packed: bool = False,
                       device=None):
    """Cross-carrier batched two-phase FEC decode on `device` (the card
    unless the caller asks for the CPU).

    streams: per-carrier host bit arrays; slots_per: matching lists of
    AlignedSlots (offsets relative to each stream); start_inits: each
    carrier's current cell scrambling code. Phase 1 decodes every SB1
    (fixed BSCH scrambling) in ONE call (kernel K1, 80 steps, on a
    card); the per-slot scrambling code is then forward-filled on the
    host per carrier (the tetra_lower_mac.c:283-310 SYNC side effect),
    and phase 2 decodes every slot under its own kind in ONE
    kind-compacted call (lmac.fused, K1 at 288 steps), the batch padded
    to a power-of-two bucket as the JAX package pads it.

    Returns, per carrier, a list of per-slot dicts:
    {"kind": SYNC|SCHF|NDB, <block name>: BlockResult (numpy), "t4":
     descrambled pre-FEC bits for the traffic dump path}. packed=True
    returns instead {"packed": [n, 408] int8 rows (_pack_selected),
    "entries", "kinds", "t4_full" / "t4_b2" (left on the device), "t4_pos"}.
    """
    dev = resolve_device(device)

    entries = [(c, j, s) for c, sl in enumerate(slots_per)
               for j, s in enumerate(sl)]
    sync_entries = [e for e in entries
                    if e[2].train_id == C.TETRA_TRAIN_SYNC]

    # ---- phase 1: all SB1 blocks, one device call ----
    if sync_entries:
        sb1_t5 = np.stack([
            streams[c][s.offset + C.SB_BLK1_OFFSET:
                       s.offset + C.SB_BLK1_OFFSET + C.SB_BLK1_BITS]
            for c, _, s in sync_entries]).astype(np.int8)
        r = pipeline.decode_block("SB1", torch.as_tensor(sb1_t5, device=dev),
                                  0)
        sb1_ok, sb1_t1 = r.crc_ok.cpu().numpy(), r.type1.cpu().numpy()
    sync_pos = {(c, j): n for n, (c, j, _) in enumerate(sync_entries)}

    # ---- host: forward-fill per-slot scrambling codes per carrier ----
    inits = [[0] * len(sl) for sl in slots_per]
    for c, sl in enumerate(slots_per):
        cur = start_inits[c]
        for j, s in enumerate(sl):
            if s.train_id == C.TETRA_TRAIN_SYNC:
                n = sync_pos[(c, j)]
                if bool(sb1_ok[n]):
                    t1 = sb1_t1[n]
                    cur = scramb_get_init(bits_to_uint(t1[31:41]),
                                          bits_to_uint(t1[41:55]),
                                          bits_to_uint(t1[4:10]))
            inits[c][j] = cur

    # ---- phase 2: ONE kind-compacted device call for all slots ----
    out = [[None] * len(sl) for sl in slots_per]
    if not entries:
        if packed:
            return {"packed": np.zeros((0, _PACK_W), np.int8),
                    "entries": [], "kinds": np.zeros(0, np.int32),
                    "t4_full": None, "t4_b2": None, "t4_pos": {}}
        return out
    n = len(entries)
    b = _bucket(n)
    bursts = np.zeros((b, C.BITS_PER_TS), np.int8)
    for m, (c, _, s) in enumerate(entries):
        bursts[m] = streams[c][s.offset:s.offset + C.BITS_PER_TS]
    kinds = np.array([_KIND_OF[s.train_id] for _, _, s in entries]
                     + [0] * (b - n), np.int32)
    ii = np.array([inits[c][j] for c, j, _ in entries]
                  + [0] * (b - n), np.int64)
    bursts_d = torch.as_tensor(bursts, device=dev)
    ii_d = torch.as_tensor(ii, device=dev)
    kinds_d = torch.as_tensor(kinds, device=dev)
    res = decode_slots_fused(bursts_d, ii_d, kinds_d)

    # type-4 payload bits feed the traffic dump (tetra_lower_mac.c:198-241)
    norm_n = [m for m, (_, _, s) in enumerate(entries)
              if s.train_id != C.TETRA_TRAIN_SYNC]
    t4_full = t4_b2 = None
    if norm_n:
        sel = torch.as_tensor(norm_n, device=dev)
        _, b1, b2 = split_norm_burst(bursts_d[sel])
        iin = ii_d[sel]
        # SCH/F: one 432-bit block; NDB blk2: its own fresh keystream
        t4_full = scramb_bits(iin, torch.cat([b1, b2], dim=-1))
        t4_b2 = scramb_bits(iin, b2)
    t4_pos = {m: i for i, m in enumerate(norm_n)}

    if packed:
        # one fetched [n, 408] row per slot; t4 stays on the device
        pk = _pack_selected(res, kinds_d).cpu().numpy()[:n]
        return {"packed": pk, "entries": entries, "kinds": kinds[:n],
                "t4_full": t4_full, "t4_b2": t4_b2, "t4_pos": t4_pos}

    res_np = {k: (v.type1.cpu().numpy(), v.crc_ok.cpu().numpy(),
                  v.type2.cpu().numpy())
              for k, v in res.items() if k not in ("kinds", "crc_ok")}
    t4_full = t4_full.cpu().numpy() if t4_full is not None else None
    t4_b2 = t4_b2.cpu().numpy() if t4_b2 is not None else None

    for m, (c, j, s) in enumerate(entries):
        kname = _KNAME_OF[kinds[m]]
        d = {"kind": kname}
        for out_key, res_key in _FIELD_MAP[kname]:
            t1a, oka, t2a = res_np[res_key]
            d[out_key] = pipeline.BlockResult(t1a[m], oka[m], t2a[m])
        if kname in ("SCHF", "NDB"):
            i4 = t4_pos[m]
            d["t4"] = t4_full[i4] if kname == "SCHF" else t4_b2[i4]
        out[c][j] = d
    return out


def _ubits_str(bits) -> str:
    """0/1 bits -> '0101...' (tetra_tpu.rx's str(int(b)) join)."""
    return (np.asarray(bits, np.uint8) + 48).tobytes().decode("ascii")


class TetraReceiver:
    """One carrier's receiver: process_bits walks its hard bits through
    sync, FEC (on `device`, the card unless the caller asks for the CPU)
    and the upper MAC / LLC / MLE / crypto host control plane, logging
    each line through `log` (print by default)."""

    def __init__(self, keystore_path: str | None = None,
                 dumpdir: str | None = None,
                 gsmtap_host: str | None = None,
                 decode_voice: bool = False,
                 log=print, device=None):
        self.device = resolve_device(device)
        self.log = log
        self.tcs = CryptoState()
        if keystore_path:
            load_keystore(keystore_path, self.tcs.db)
        self._tun = None
        self.llc = LlcState(log=self._log_inline,
                            tl_sdu_cb=lambda bits, n: rx_tl_sdu(bits, n, log=self.log),
                            ip_cb=self._ip_out)
        self.gsmtap = None
        if gsmtap_host:
            self.gsmtap = GsmtapSink(gsmtap_host)
        self.umac = UpperMac(self.tcs, self.llc,
                             gsmtap_cb=self._gsmtap_cb if self.gsmtap else None,
                             log=log)
        self.dumpdir = dumpdir
        if dumpdir:
            os.makedirs(dumpdir, exist_ok=True)
        self.decode_voice = decode_voice
        self.time = TdmaTime()
        self.scramb_init = 0         # cell scrambling code (tetra_cell_data)
        self.mcc = self.mnc = self.colour_code = 0
        self.stats = RxStats()
        self._ev_ptr = 0
        # optional TMV-SAP record tap: set to a list to collect one
        # tuple per UNITDATA.ind, mirroring tools/ref_rx.c's REC lines
        self.tmv_records: list | None = None
        # streaming state: retained bit buffer + resumable sync carry
        # (the analogue of the reference's 4096-bit ring, tetra_burst_sync.h:17)
        self._buf = np.zeros(0, dtype=np.uint8)
        self._buf_base = 0           # absolute stream offset of _buf[0]
        self._sync_carry = sync_mod.SyncCarry()

    # ---- logging helpers ----

    def _log_inline(self, *args, **kwargs):
        """LLC's print-style lines (end= and the like ignored)."""
        self.log(" ".join(str(a) for a in args))

    def _trim_buffer(self):
        """Drop consumed bits: the synchroniser's virtual ring buffer
        starts at carry.buf_start and is at most 4096 bits deep
        (tetra_burst_sync.h:17), so everything before it is dead."""
        keep_from = max(self._buf_base, self._sync_carry.buf_start)
        drop = keep_from - self._buf_base
        if drop > 0:
            self._buf = self._buf[drop:]
            self._buf_base = keep_from

    def _ip_out(self, packet: bytes):
        """Reassembled SNDCP IP payload -> tun0, opened lazily on first
        use (reference tetra_llc.c:93-101)."""
        if self._tun is None:
            from tetra_tpu_torch.io.tun import TunDevice
            self._tun = TunDevice("tun0")
        self._tun.write(packet)

    def _gsmtap_cb(self, tup: TmvUnitdata):
        self.gsmtap.send(tup.tdma_time, tup.lchan, tup.tdma_time.tn - 1, tup.bits)

    # ---- block-level processing (the tp_sap_udata_ind analogue) ----

    def _crc_log(self, name: str, res, type1_len: int) -> bool:
        """CRC COMP log lines (reference tetra_lower_mac.c:258-267)."""
        if trace.enabled(2):
            trace.tap(f"type1_{name}", np.asarray(res.type1),
                      meta={"time": self.time.dump()})
        ok = bool(np.asarray(res.crc_ok))
        # reproduce the numeric value for the log line
        crc = crc16_bits_np(np.asarray(res.type2)[: type1_len + 16])
        self.log(f"CRC COMP: 0x{crc:04x} {'OK' if ok else 'WRONG'}")
        if ok:
            self.log(f"{name} {self.time.dump()} type1: "
                     f"{_ubits_str(res.type1)}")
        self.stats.crc_ok += ok
        self.stats.crc_wrong += not ok
        if not ok:
            trace.count("slots.crc_wrong")
        return ok

    def _rx_sb1(self, res):
        """SYNC PDU handling (reference tetra_lower_mac.c:283-310)."""
        type1 = np.asarray(res.type1)
        ok = self._crc_log("SB1", res, 60)
        self.log("TMB-SAP SYNC CC "
                 f"{_ubits_str(type1[4:10])}(0x{bits_to_uint(type1[4:10]):02x}) "
                 f"TN {_ubits_str(type1[10:12])}({bits_to_uint(type1[10:12]) + 1}) "
                 f"FN {_ubits_str(type1[12:17])}({bits_to_uint(type1[12:17]):2d}) "
                 f"MN {_ubits_str(type1[17:23])}({bits_to_uint(type1[17:23]):2d}) "
                 f"MCC {_ubits_str(type1[31:41])}({bits_to_uint(type1[31:41])}) "
                 f"MNC {_ubits_str(type1[41:55])}({bits_to_uint(type1[41:55])})")
        if ok:
            self.colour_code = bits_to_uint(type1[4:10])
            self.time.tn = bits_to_uint(type1[10:12]) + 1
            self.time.fn = bits_to_uint(type1[12:17])
            self.time.mn = bits_to_uint(type1[17:23])
            self.mcc = bits_to_uint(type1[31:41])
            self.mnc = bits_to_uint(type1[41:55])
            self.scramb_init = scramb_get_init(self.mcc, self.mnc, self.colour_code)
            # crypto state update (tetra_lower_mac.c:311-317)
            self.tcs.cc = self.colour_code
            if self.tcs.mcc != self.mcc or self.tcs.mnc != self.mnc:
                self.tcs.update_current_network(self.mcc, self.mnc)
        return ok

    def _dump_traffic(self, type4: np.ndarray, usage: int | None = None,
                      tsn: int | None = None, ssi: int | None = None,
                      voice_ks=None):
        """Traffic burst dump (reference tetra_lower_mac.c:198-241). A
        216-bit NDB half fills the positions it has (dump_blocks)."""
        if not self.dumpdir:
            return
        block = dump_blocks(np.asarray(type4)[None])[0]
        if usage is None:
            usage = self.umac.cur_burst_is_traffic
        if tsn is None:
            tsn = self.time.tn - 1
        if ssi is None:
            ssi = self.umac.ssi
        base = os.path.join(self.dumpdir, f"traffic_{usage}_{tsn}")
        append_files({base + ".out": [block.tobytes()],
                      base + ".txt": [f"{ssi}\n".encode()]})
        if self.decode_voice:
            self._decode_voice_slot(type4, usage, tsn, voice_ks)

    def _voice_keystream(self):
        """274 keystream ubits for this slot's voice (reference
        tetra_crypto.c:254-282: two half slots, 137 bits each, key =
        tcs->cck, IV from the slot's TDMA time) — None when no key is
        selected or crypto/clock state is incomplete."""
        t = self.time
        if (self.tcs.cck is None or not (1 <= t.tn <= 4)
                or not (1 <= t.fn <= 18) or not (1 <= t.mn <= 60)):
            return None
        return generate_keystream(self.tcs, self.tcs.cck, t, 274)

    def _decode_voice_slot(self, type4: np.ndarray, usage: int, tsn: int,
                           voice_ks=None):
        """Beyond-reference capability: the TCH/S speech FEC chain
        (rate-1/3 Viterbi per protection class, K6 on a card) + ACELP
        reordering, the two 137-bit codec frames decrypted when a key is
        selected, appended per slot to a .cod file."""
        if voice_ks is None:
            voice_ks = self._voice_keystream()
        ks = np.zeros((1, 274), np.uint8)
        if voice_ks is not None:
            ks[0] = np.asarray(voice_ks[:274], np.uint8)
        rows = torch.as_tensor(np.asarray(type4, np.int8)[None],
                               device=self.device)
        path = os.path.join(self.dumpdir, f"voice_{usage}_{tsn}.cod")
        append_files({path: [voice_frames(rows, ks).tobytes()]})

    def _record_tmv(self, lchan: int, ok, blk_num: int, bits):
        if self.tmv_records is not None:
            b = np.asarray(bits)
            self.tmv_records.append(
                (self.time.tn, self.time.fn, self.time.mn, int(lchan),
                 int(bool(ok)), int(blk_num), len(b), _ubits_str(b)))

    def _dispatch(self, res, lchan: int, blk_num: int, type1_len: int, name: str):
        ok = self._crc_log(name, res, type1_len) if name != "BBK" else True
        if name == "BBK":
            # reference: no RM3014 check, crc_ok=1 (tetra_lower_mac.c:268-271)
            self.log(f"{name} {self.time.dump()} type1: "
                     f"{_ubits_str(res.type1)}")
        self._record_tmv(lchan, ok, blk_num, res.type1)
        self.umac.rx_slot(np.asarray(res.type1), lchan, ok, self.time,
                          blk_num=blk_num, scrambling_code=self.scramb_init)

    # ---- main entry ----

    def _flush_events(self, events: list, upto_seq: int):
        """Emit sync events in reference order: the TDMA clock advances
        and 'BURST' prints once per processed slot — including lost
        ones — exactly like tetra_burst_sync.c:113-116/125-141."""
        while self._ev_ptr < len(events) and events[self._ev_ptr].seq <= upto_seq:
            e = events[self._ev_ptr]
            self._ev_ptr += 1
            if e.kind == "found_sync":
                self.log(f"found SYNC training sequence in bit #{e.detail}")
            elif e.kind == "burst":
                self.time.add_tn(1)
                self.log("\nBURST")
                self.stats.bursts += 1
                self.stats.slots += 1
            elif e.kind == "lost":
                self.log("#### could not find successive burst training sequence")
            elif e.kind == "bad_offset":
                self.log(f"#### SYNC burst at offset {e.detail}?!?")

    def process_bits(self, bits: np.ndarray, final: bool = True) -> RxStats:
        """Decode a chunk of unpacked hard bits (1 bit per byte/element).

        Streaming: pass final=False for mid-stream chunks — partial
        feed quanta at the chunk edge are retained and the synchroniser
        resumes across calls, so feeding one capture in arbitrary
        chunks is equivalent to feeding it whole. final=True (default)
        treats the chunk end as EOF, like the reference's last short
        read().
        """
        chunk = np.asarray(bits, dtype=np.uint8).reshape(-1) & 1
        self._buf = np.concatenate([self._buf, chunk])
        bits = self._buf
        events: list = []
        self._ev_ptr = 0
        slots = sync_mod.align_stream(bits, events=events,
                                      carry=self._sync_carry,
                                      base_offset=self._buf_base,
                                      flush=final, device=self.device)
        if trace.enabled(2):
            trace.tap("aligned_slots",
                      np.asarray([(s.offset, s.train_id) for s in slots]))
        if slots:
            decoded = decode_slots_multi([bits], [slots], [self.scramb_init],
                                         device=self.device)[0]
            for s, d in zip(slots, decoded):
                self._flush_events(events, s.seq)
                self._walk_slot(d)
        self._flush_events(events, 1 << 62)
        self._trim_buffer()
        return self.stats

    def _walk_slot(self, d: dict):
        """Per-slot upper-MAC processing given its decoded blocks
        (the host half of tp_sap_udata_ind + tetra_burst_rx_cb)."""
        if d["kind"] == "SYNC":
            sb1, bbk, sb2 = d["SB1"], d["BBK"], d["SB2"]
            sb1_ok = self._rx_sb1(sb1)
            self._record_tmv(LogicalChannel.BSCH, sb1_ok, 1, sb1.type1)
            self.umac.rx_slot(sb1.type1, LogicalChannel.BSCH, sb1_ok,
                              self.time, blk_num=1)
            self._dispatch(bbk, LogicalChannel.AACH, 0, 14, "BBK")
            lchan = LogicalChannel.UNKNOWN
            if is_bnch(self.time):
                self.log("BNCH FOLLOWS")
                lchan = LogicalChannel.BNCH
            self._dispatch(sb2, lchan, 2, 124, "SB2")
        elif d["kind"] == "SCHF":
            self._dispatch(d["BBK"], LogicalChannel.AACH, 0, 14, "BBK")
            if self.umac.cur_burst_is_traffic:
                self._dump_traffic(d["t4"])
            else:
                self._dispatch(d["SCH_F"], LogicalChannel.SCH_F, 0, 268,
                               "SCH/F")
        elif d["kind"] == "NDB":
            self._dispatch(d["BBK"], LogicalChannel.AACH, 0, 14, "BBK")
            if self.umac.cur_burst_is_traffic:
                # blk1 stolen in traffic mode (tetra_lower_mac.c:191-196)
                self.umac.blk1_stolen = True
                self._dispatch(d["NDB1"], LogicalChannel.UNKNOWN, 1, 124, "NDB")
                if not self.umac.blk2_stolen:
                    self._dump_traffic(d["t4"])
                else:
                    self._dispatch(d["NDB2"], LogicalChannel.UNKNOWN, 2, 124,
                                   "NDB")
            else:
                self._dispatch(d["NDB1"], LogicalChannel.UNKNOWN, 1, 124, "NDB")
                self._dispatch(d["NDB2"], LogicalChannel.UNKNOWN, 2, 124, "NDB")


def main(argv=None):
    """CLI entry point mirroring `tetra-rx [-d DUMPDIR] [-k KEYSTORE] <bits>`
    (tetra_tpu.rx.main), plus --device."""
    import argparse
    from tetra_tpu_torch.io.inputs import capture_to_bits, load_capture
    p = argparse.ArgumentParser(description="TETRA receiver (PyTorch port)")
    p.add_argument("-d", dest="dumpdir", help="traffic dump directory")
    p.add_argument("-k", dest="keystore", help="crypto keystore file")
    p.add_argument("-g", dest="gsmtap", nargs="?", const="localhost",
                   help="GSMTAP export host")
    p.add_argument("-f", dest="fmt", default="auto",
                   choices=("auto", "bits", "float", "iq"),
                   help="capture format (default: infer from extension)")
    p.add_argument("--voice", action="store_true",
                   help="run the TCH/S speech FEC chain and write packed "
                        "ACELP codec frames (.cod) next to the traffic "
                        "dumps (needs -d)")
    p.add_argument("--device", default=None,
                   help="torch device for the device stages (default: "
                        "the CUDA card; 'cpu' runs the plain versions)")
    p.add_argument("capture", help=".bits (1 byte/bit), .fl (float symbols) "
                                   "or .cfile (complex IQ)")
    args = p.parse_args(argv)
    rx = TetraReceiver(keystore_path=args.keystore, dumpdir=args.dumpdir,
                       gsmtap_host=args.gsmtap, decode_voice=args.voice,
                       device=args.device)
    kind, data = load_capture(args.capture, args.fmt)
    stats = rx.process_bits(capture_to_bits(kind, data, device=rx.device))
    print(f"\n{stats.bursts} bursts, CRC ok/wrong = {stats.crc_ok}/{stats.crc_wrong}")


if __name__ == "__main__":
    main()
