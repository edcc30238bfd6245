"""Burst construction, field split and training-sequence search (port of
tetra_tpu.phy.burst).

Reference behaviour: src/phy/tetra_burst.c — the continuous-downlink
burst builders (9.4.4.2.5/2.6, :169-267, numpy as in the JAX package),
the field splitters (:346-372) and the training-sequence scanner
(:269-339), here a batched correlation of ±1-mapped bits with each
template.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tetra_tpu_torch import constants as C
from tetra_tpu_torch.phy.sync import _SEQS

__all__ = ["sum_up_phase", "calc_phase_adj", "phase_adj_bits",
           "build_sync_c_d_burst", "build_norm_c_d_burst",
           "build_norm_c_d_bursts",
           "train_seq_match", "match_columns", "find_train_seq",
           "split_sync_burst", "split_norm_burst", "LOCKED_COLS"]

# match-map columns in the reference's scan priority at equal offset,
# y, n, p, q, x (tetra_burst.c:305-338), as training-sequence ids
_PRIORITY = (C.TETRA_TRAIN_SYNC, C.TETRA_TRAIN_NORM_1, C.TETRA_TRAIN_NORM_2,
             C.TETRA_TRAIN_NORM_3, C.TETRA_TRAIN_EXT)
# the locked receiver's mask: SYNC | NORM_1 | NORM_2, the first three
# columns
LOCKED_COLS = (0, 1, 2)


def sum_up_phase(bits: np.ndarray) -> int:
    """Cumulative pi/4 phase of dibit symbols (tetra_burst.c:133-151)."""
    bits = np.asarray(bits).reshape(-1, 2)
    phases = np.array([C.BITS2PHASE[(int(a), int(b))] for a, b in bits])
    return int(phases.sum())


def calc_phase_adj(phase: int) -> int:
    """-(phase mod 8) wrapped to [-3, 3], C-truncation semantics
    (tetra_burst.c:117-128)."""
    adj = -(int(np.fmod(phase, 8)))
    if adj > 3:
        adj -= 8
    elif adj < -3:
        adj += 8
    return adj


def phase_adj_bits(burst: np.ndarray, which: str) -> np.ndarray:
    """Phase-adjustment dibit for range `which` per Table 8.14: the
    spec's phase2bits[PHASE(adj)], as the JAX package emits it (the
    reference's tetra_burst.c:162 indexes its table out of bounds for
    negative adjustments). No receiver path reads these bits."""
    n1, n2 = C.PHASE_ADJ_N[which]
    seg = burst[2 * (n1 - 1): 2 * (n1 - 1) + 2 * (1 + n2 - n1)]
    adj = calc_phase_adj(sum_up_phase(seg))
    return np.asarray(C.PHASE2BITS[adj], dtype=np.uint8)


def build_sync_c_d_burst(sb, bb, bkn) -> np.ndarray:
    """9.4.4.2.6 synchronization continuous downlink burst
    (tetra_burst.c:169-216). sb: 120 scrambled sync bits, bb: 30
    scrambled broadcast bits, bkn: 216 scrambled block-2 bits."""
    burst = np.zeros(510, dtype=np.uint8)
    burst[0:12] = C.TRAIN_Q[10:22]
    burst[14:94] = C.FREQ_CORR
    burst[94:214] = np.asarray(sb, dtype=np.uint8)
    burst[214:252] = C.TRAIN_Y
    burst[252:282] = np.asarray(bb, dtype=np.uint8)
    burst[282:498] = np.asarray(bkn, dtype=np.uint8)
    burst[500:510] = C.TRAIN_Q[0:10]
    burst[12:14] = phase_adj_bits(burst, "HC")
    burst[498:500] = phase_adj_bits(burst, "HD")
    return burst


def build_norm_c_d_burst(bkn1, bb, bkn2, two_log_chan: bool) -> np.ndarray:
    """9.4.4.2.5 normal continuous downlink burst (tetra_burst.c:218-267):
    training sequence p when two_log_chan, else n."""
    burst = np.zeros(510, dtype=np.uint8)
    burst[0:12] = C.TRAIN_Q[10:22]
    burst[14:230] = np.asarray(bkn1, dtype=np.uint8)
    burst[230:244] = np.asarray(bb, dtype=np.uint8)[0:14]
    burst[244:266] = C.TRAIN_P if two_log_chan else C.TRAIN_N
    burst[266:282] = np.asarray(bb, dtype=np.uint8)[14:30]
    burst[282:498] = np.asarray(bkn2, dtype=np.uint8)
    burst[500:510] = C.TRAIN_Q[0:10]
    burst[12:14] = phase_adj_bits(burst, "HA")
    burst[498:500] = phase_adj_bits(burst, "HB")
    return burst


def _phase_adj_bits_t(bursts: torch.Tensor, which: str) -> torch.Tensor:
    """phase_adj_bits over bursts [N, 510] int8 -> [N, 2] int8."""
    n1, n2 = C.PHASE_ADJ_N[which]
    seg = bursts[:, 2 * (n1 - 1): 2 * (n1 - 1) + 2 * (1 + n2 - n1)]
    seg = seg.reshape(seg.shape[0], -1, 2).to(torch.int64)
    step = torch.tensor([C.BITS2PHASE[(a, b)] for a in (0, 1) for b in (0, 1)],
                        device=bursts.device)
    phase = step[2 * seg[..., 0] + seg[..., 1]].sum(-1)
    adj = -torch.fmod(phase, 8)
    adj = torch.where(adj > 3, adj - 8, torch.where(adj < -3, adj + 8, adj))
    if bool((adj % 2 == 0).any()):
        raise KeyError("phase adjustment outside PHASE2BITS")
    tab = torch.tensor([C.PHASE2BITS.get(a, (0, 0)) for a in range(-3, 4)],
                       dtype=torch.int8, device=bursts.device)
    return tab[adj + 3]


def build_norm_c_d_bursts(bkn1: torch.Tensor, bb: torch.Tensor,
                          bkn2: torch.Tensor,
                          two_log_chan: bool) -> torch.Tensor:
    """build_norm_c_d_burst over a batch on the tensors' device: bkn1,
    bkn2 [N, 216], bb [N, 30] -> bursts [N, 510] int8."""
    dev = bkn1.device
    n = bkn1.shape[0]
    const = lambda a: torch.as_tensor(a.astype(np.int8), device=dev).expand(
        n, len(a))
    burst = torch.cat([
        const(C.TRAIN_Q[10:22]), torch.zeros((n, 2), dtype=torch.int8,
                                             device=dev),
        bkn1.to(torch.int8), bb[:, :14].to(torch.int8),
        const(C.TRAIN_P if two_log_chan else C.TRAIN_N),
        bb[:, 14:30].to(torch.int8), bkn2.to(torch.int8),
        torch.zeros((n, 2), dtype=torch.int8, device=dev),
        const(C.TRAIN_Q[0:10])], dim=1)
    burst[:, 12:14] = _phase_adj_bits_t(burst, "HA")
    burst[:, 498:500] = _phase_adj_bits_t(burst, "HB")
    return burst


def match_columns(bits: torch.Tensor, cols: tuple,
                  tol: int = 0) -> torch.Tensor:
    """Match map of the training sequences in priority columns `cols`
    (0..4 = y, n, p, q, x) over ubits [..., L]: bool [..., L, len(cols)],
    True where the sequence starts at that offset with at most `tol` bit
    errors. Positions closer than a sequence length to the end never
    match (the reference's remain_len check, tetra_burst.c:305-312).

    One correlation of ±1-mapped bits with ±1 templates: an exact match
    is a correlation equal to the template length n, and each wrong bit
    lowers it by 2, so a match is `corr >= n - 2*tol`. tol=0 is the
    reference's exact matcher; the soft pipeline uses tol=2."""
    seqs = [_SEQS[c] for c in cols]
    nmax = max(len(s) for s in seqs)
    w = np.zeros((len(seqs), 1, nmax), np.float32)
    for i, s in enumerate(seqs):
        w[i, 0, :len(s)] = 1.0 - 2.0 * s.astype(np.float32)
    batch, L = bits.shape[:-1], bits.shape[-1]
    x = 1.0 - 2.0 * bits.reshape(-1, L).to(torch.float32)
    corr = F.conv1d(F.pad(x[:, None, :], (0, nmax - 1)),
                    torch.as_tensor(w, device=bits.device))   # [B, k, L]
    pos = torch.arange(L, device=bits.device)
    outs = [(corr[:, i] >= float(len(s) - 2 * tol)) & (pos <= L - len(s))
            for i, s in enumerate(seqs)]
    return torch.stack(outs, dim=-1).reshape(*batch, L, len(seqs))


def train_seq_match(bits: torch.Tensor, mask: int = 0x1F,
                    tol: int = 0) -> torch.Tensor:
    """Match map of the 5 training sequences over ubits [..., L]: bool
    [..., L, 5], column r for priority rank r (y, n, p, q, x); a
    sequence whose id bit is clear in `mask` never matches."""
    on = [r for r, tid in enumerate(_PRIORITY) if (mask >> tid) & 1]
    out = torch.zeros(bits.shape + (len(_PRIORITY),), dtype=torch.bool,
                      device=bits.device)
    if on:
        out[..., on] = match_columns(bits, tuple(on), tol)
    return out


def find_train_seq(bits: torch.Tensor, mask: int = 0x1F):
    """First training-sequence hit over ubits [..., L]: (train_id int32
    [...], offset int32 [...], found bool [...]), the reference scanner's
    first offset and, at equal offset, priority y, n, p, q, x
    (tetra_burst.c:269-339), evaluated over all offsets at once. With no
    hit, offset is 0 and train_id the SYNC id, as in the JAX package."""
    match = train_seq_match(bits, mask)                 # [..., L, 5]
    any_pos = match.any(dim=-1)
    offset = torch.argmax(any_pos.to(torch.uint8), dim=-1)
    found = any_pos.any(dim=-1)
    at = torch.gather(match, -2, offset[..., None, None].expand(
        *offset.shape, 1, match.shape[-1]))[..., 0, :]
    rank = torch.argmax(at.to(torch.uint8), dim=-1)
    prio = torch.as_tensor(_PRIORITY, dtype=torch.int32, device=bits.device)
    return prio[rank], offset.to(torch.int32), found


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
