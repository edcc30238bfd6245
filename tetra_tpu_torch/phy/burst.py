"""Training-sequence match map and the burst splitters (port of the
parts of tetra_tpu.phy.burst that the fast path and the steady chain
use).

Reference behaviour: src/phy/tetra_burst.c:269-372.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tetra_tpu_torch import constants as C
from tetra_tpu_torch.phy.sync import _SEQS

__all__ = ["train_seq_match", "split_sync_burst", "split_norm_burst",
           "LOCKED_COLS"]

# the locked receiver's mask: SYNC | NORM_1 | NORM_2, in scan priority
# order (the first three match-map columns of tetra_tpu)
LOCKED_COLS = (0, 1, 2)


def train_seq_match(bits: torch.Tensor, tol: int = 0) -> torch.Tensor:
    """Match map of the SYNC, NORM_1 and NORM_2 training sequences over
    ubits [B, L]: bool [B, L, 3], True where the sequence starts at that
    offset with at most `tol` bit errors. Positions closer than a
    sequence length to the end never match (the reference's remain_len
    check, tetra_burst.c:305-312).

    One correlation of ±1-mapped bits with ±1 templates: an exact match
    is a correlation equal to the template length n, and each wrong bit
    lowers it by 2, so a match is `corr >= n - 2*tol`. tol=0 is the
    reference's exact matcher; the soft pipeline uses tol=2."""
    seqs = [_SEQS[c] for c in LOCKED_COLS]
    nmax = max(len(s) for s in seqs)
    w = np.zeros((len(seqs), 1, nmax), np.float32)
    for i, s in enumerate(seqs):
        w[i, 0, :len(s)] = 1.0 - 2.0 * s.astype(np.float32)
    B, L = bits.shape
    x = 1.0 - 2.0 * bits.to(torch.float32)
    corr = F.conv1d(F.pad(x[:, None, :], (0, nmax - 1)),
                    torch.as_tensor(w, device=bits.device))   # [B, 3, L]
    pos = torch.arange(L, device=bits.device)
    outs = [(corr[:, i] >= float(len(s) - 2 * tol)) & (pos <= L - len(s))
            for i, s in enumerate(seqs)]
    return torch.stack(outs, dim=-1)


def split_sync_burst(burst: torch.Tensor):
    """SB burst [..., 510] -> (sb1 [..., 120], bbk [..., 30], sb2
    [..., 216]) (tetra_burst.c:346-352)."""
    sb1 = burst[..., C.SB_BLK1_OFFSET: C.SB_BLK1_OFFSET + C.SB_BLK1_BITS]
    bbk = burst[..., C.SB_BBK_OFFSET: C.SB_BBK_OFFSET + C.SB_BBK_BITS]
    sb2 = burst[..., C.SB_BLK2_OFFSET: C.SB_BLK2_OFFSET + C.SB_BLK2_BITS]
    return sb1, bbk, sb2


def split_norm_burst(burst: torch.Tensor):
    """NDB burst [..., 510] -> (bbk [..., 30], blk1 [..., 216],
    blk2 [..., 216]) (tetra_burst.c:354-372)."""
    bbk1 = burst[..., C.NDB_BBK1_OFFSET: C.NDB_BBK1_OFFSET + C.NDB_BBK1_BITS]
    bbk2 = burst[..., C.NDB_BBK2_OFFSET: C.NDB_BBK2_OFFSET + C.NDB_BBK2_BITS]
    bbk = torch.cat([bbk1, bbk2], dim=-1)
    blk1 = burst[..., C.NDB_BLK1_OFFSET: C.NDB_BLK1_OFFSET + C.NDB_BLK_BITS]
    blk2 = burst[..., C.NDB_BLK2_OFFSET: C.NDB_BLK2_OFFSET + C.NDB_BLK_BITS]
    return bbk, blk1, blk2
