"""Per-slot result packing, per-carrier records and the traffic writer
(port of the parts of tetra_tpu.rx that the fast path uses).

The traffic writer is the counterpart of TetraReceiver._dump_traffic,
_decode_voice_slot and _ip_out (reference tetra_lower_mac.c:198-241 and
tetra_llc.c:93-101): per traffic slot a 690-int16 soft block appended to
traffic_<usage>_<tsn>.out, the SSI to traffic_<usage>_<tsn>.txt and,
with voice decode, the two 137-bit ACELP codec frames (decrypted when
the walk supplied a keystream) packed to 35 bytes in
voice_<usage>_<tsn>.cod. The JAX package decodes one slot per call;
here a chunk's slots are decoded in one batch per row length
(`voice_frames`), and each file gets the chunk's appends in event order.
"""
from __future__ import annotations

import functools
import os
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from tetra_tpu_torch.ops import acelp
from tetra_tpu_torch.tdma import TdmaTime

__all__ = ["RxStats", "CarrierState", "_pack_selected", "_PACK_BITS",
           "dump_blocks", "voice_frames", "append_files"]

_PACK_A, _PACK_B, _PACK_BBK = 268, 124, 14
_PACK_BITS = _PACK_A + _PACK_B + _PACK_BBK          # 406 payload columns


@dataclass
class RxStats:
    slots: int = 0
    crc_ok: int = 0
    crc_wrong: int = 0
    bursts: int = 0


@dataclass
class CarrierState:
    """What the native control plane reports per carrier: decode stats,
    TDMA time, cell identity and the cell scrambling code (the fields
    tetra_tpu.rx.TetraReceiver carries for the same purpose), the
    carrier's dump directory and its TUN device (opened on first use)."""
    stats: RxStats = field(default_factory=RxStats)
    time: TdmaTime = field(default_factory=TdmaTime)
    colour_code: int = 0
    mcc: int = 0
    mnc: int = 0
    scramb_init: int = 0
    dumpdir: str | None = None
    tun: object = None

    def ip_out(self, packet: bytes) -> None:
        """Reassembled SNDCP IP payload -> tun0, opened lazily on first
        use (reference tetra_llc.c:93-101)."""
        if self.tun is None:
            from tetra_tpu_torch.io.tun import TunDevice
            self.tun = TunDevice("tun0")
        self.tun.write(packet)


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
