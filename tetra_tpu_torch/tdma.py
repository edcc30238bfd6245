"""TDMA time hierarchy, EN 300 392-2 Section 7.3.

Copy of tetra_tpu.tdma, kept in the port so that it imports nothing of
the JAX package; tests/test_torch_tables.py holds it to the original.

Reference behaviour: src/tetra_tdma.c — hn/mn/fn/tn/sn counters with
carrying normalisation, kept as a tiny host dataclass.
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class TdmaTime:
    """Counters start at zero like the reference's talloc_zero'd state
    (tetra-rx.c:49, static t_phy_state) — the nominally-invalid 0
    values persist until the first decoded SYNC PDU sets real time,
    and the parity oracle sees exactly that."""
    hn: int = 0   # hyperframe (1..65535)
    mn: int = 0   # multiframe (1..60)
    fn: int = 0   # frame (1..18)
    tn: int = 0   # timeslot (1..4)
    sn: int = 0   # symbol (1..255)

    def _norm_mn(self):
        if self.mn > 60:
            self.mn = self.mn % 60

    def _norm_fn(self):
        if self.fn > 18:
            self.mn += self.fn // 18
            self.fn = self.fn % 18
        self._norm_mn()

    def _norm_tn(self):
        if self.tn > 4:
            self.fn += self.tn // 4
            self.tn = self.tn % 4
        self._norm_fn()

    def _norm_sn(self):
        if self.sn > 255:
            self.tn += self.sn // 255
            self.sn = (self.sn % 255) + 1
        self._norm_tn()

    def add_sym(self, n: int):
        self.sn += n
        self._norm_sn()
        return self

    def add_tn(self, n: int):
        self.tn += n
        self._norm_tn()
        return self

    def add_fn(self, n: int):
        self.fn += n
        self._norm_fn()
        return self

    def time2fn(self) -> int:
        """Flat frame number (reference tetra_tdma.c:96-99)."""
        return ((self.hn * 60 + self.mn) * 18) + self.fn

    def dump(self) -> str:
        """mn/fn/tn/sn string (reference tetra_tdma.c:85-92)."""
        return f"{self.mn:02d}/{self.fn:02d}/{self.tn}/{self.sn:03d}"

    def copy(self) -> "TdmaTime":
        return TdmaTime(self.hn, self.mn, self.fn, self.tn, self.sn)
