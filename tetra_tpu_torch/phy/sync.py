"""Burst synchroniser constants (port of tetra_tpu.phy.sync's tables).

Reference behaviour: src/phy/tetra_burst_sync.c — a 4096-bit ring fed
64 bits per call (tetra-rx.c:86); training sequences scanned in the
priority order y, n, p, q, x (tetra_burst.c:273-283).
"""
from __future__ import annotations

from tetra_tpu_torch import constants as C

__all__ = ["RING_BITS", "FEED_BITS"]

RING_BITS = 4096       # sizeof(trs->bitbuf), tetra_burst_sync.h:17
FEED_BITS = 64         # read(fd, buf, 64), tetra-rx.c:86

_SEQS = (C.TRAIN_Y, C.TRAIN_N, C.TRAIN_P, C.TRAIN_Q, C.TRAIN_X)
_SEQ_LEN = tuple(len(s) for s in _SEQS)
