"""Per-slot result packing and per-carrier records (port of the parts of
tetra_tpu.rx that the fast path uses)."""
from __future__ import annotations

from dataclasses import dataclass, field

import torch
import torch.nn.functional as F

from tetra_tpu.tdma import TdmaTime

__all__ = ["RxStats", "CarrierState", "_pack_selected", "_PACK_BITS"]

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
    tetra_tpu.rx.TetraReceiver carries for the same purpose)."""
    stats: RxStats = field(default_factory=RxStats)
    time: TdmaTime = field(default_factory=TdmaTime)
    colour_code: int = 0
    mcc: int = 0
    mnc: int = 0
    scramb_init: int = 0


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
