"""The burst synchroniser, worked out again over a whole stream: the
state machine of osmo-tetra's src/phy/tetra_burst_sync.c stepped 64 bits
at a time (tetra-rx.c:86), vectorised over carriers (a frozen copy of
the port's plain version, phy.sync_vec.sync_scan_plain, at tolerance 0
and at the soft pipeline's tolerance 2, with its match map from
phy.burst.match_columns).

`scan_stream` runs it over each carrier's whole stream in one call from
the receiver's initial state, and returns per step the processed-burst
flag, the emitted-slot flag, the winning training sequence and the slot
offset in the stream.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference import constants as C

RING_BITS = 4096            # the reference's bit buffer (tetra_burst_sync.h:17)
FEED_BITS = 64              # read(fd, buf, 64), tetra-rx.c:86
RING_PAD = RING_BITS + 512  # the receiver's device-resident history
_BIG = 1 << 27
# training sequences by column: SYNC (y), NORM_1 (n), NORM_2 (p)
_SEQS = (C.TRAIN_Y, C.TRAIN_N, C.TRAIN_P)
_SEQ_LEN = tuple(len(s) for s in _SEQS)
_PAT0 = tuple(int(s[0]) for s in _SEQS)
_PAT1_EQ_PAT0 = tuple(bool(s[1] == s[0]) for s in _SEQS)


def match_columns(bits: torch.Tensor, tol: int = 0) -> torch.Tensor:
    """bool [B, L, 3]: the column's sequence starts at that offset with
    at most `tol` wrong bits (each lowers the correlation of the +-1
    bits by 2); positions closer than its length to the end never
    match."""
    nmax = max(_SEQ_LEN)
    w = np.zeros((3, 1, nmax), np.float32)
    for i, s in enumerate(_SEQS):
        w[i, 0, :len(s)] = 1.0 - 2.0 * s.astype(np.float32)
    B, L = bits.shape
    x = 1.0 - 2.0 * bits.to(torch.float32)
    corr = F.conv1d(F.pad(x[:, None, :], (0, nmax - 1)),
                    torch.as_tensor(w, device=bits.device))
    pos = torch.arange(L, device=bits.device)
    return torch.stack([(corr[:, i] >= float(n - 2 * tol)) & (pos <= L - n)
                        for i, n in enumerate(_SEQ_LEN)], dim=-1)


def sync_scan(bits: torch.Tensor, state0, buf_start0, nbuf0, nfs0,
              steps: int, feed: int = FEED_BITS, tol: int = 0) -> dict:
    """`steps` feed quanta of the state machine over bits [B, L]
    (window-relative int32 positions). With tol > 0 the match map allows
    `tol` wrong bits, and a locked slot takes a sequence at its expected
    offset (SYNC at 214, NORM at 244) before the first-match scan.
    Returns {'burst', 'emit', 'col', 'slot'} as [steps, B] tensors."""
    dev = bits.device
    B, L = bits.shape
    i32 = torch.int32
    idx = torch.arange(L, dtype=i32, device=dev)
    match = match_columns(bits, tol)
    prev = torch.cat([torch.zeros((B, 1), dtype=bits.dtype, device=dev),
                      bits[:, :-1]], dim=1)
    false_col = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    sentinel = torch.full((B, 1), L, dtype=i32, device=dev)
    nms, viz20s = [], []
    # the tolerant override's lookups, with a False column at L
    mcols = [torch.cat([match[..., ci], false_col], dim=1)
             for ci in range(3)] if tol else None
    for ci in range(3):
        v = torch.where(match[..., ci], idx, L)
        nm = torch.cummin(v.flip(1), dim=1).values.flip(1)
        nms.append(torch.cat([nm, sentinel], dim=1))
        viz20s.append(torch.cat([prev == _PAT0[ci], false_col], dim=1))
    del match

    def gather(arr, pos):
        pos = pos.clamp(0, L).to(torch.int64)
        return arr.gather(1, pos[:, None])[:, 0]

    def first_match(ci, a, b):
        """First visible, fitting match of column ci in [a, b), or _BIG
        (tetra_find_train_seq with its polluted 22-bit prefilter)."""
        nm = nms[ci]
        q = gather(nm, a)
        for _ in range(2):
            k = q - a
            vis20 = gather(viz20s[ci], q)
            vis = (k >= 21) | ((k == 20) & vis20)
            if _PAT1_EQ_PAT0[ci]:
                vis = vis | ((k == 19) & vis20)
            q = torch.where((q < L) & ~vis, gather(nm, q + 1), q)
        fit = q + _SEQ_LEN[ci] <= b
        return torch.where(fit & (q < L), q, _BIG)

    state = torch.as_tensor(state0, dtype=i32, device=dev).expand(B).clone()
    buf_start = torch.as_tensor(buf_start0, dtype=i32,
                                device=dev).expand(B).clone()
    nbuf = torch.as_tensor(nbuf0, dtype=i32, device=dev).expand(B).clone()
    nfs = torch.as_tensor(nfs0, dtype=i32, device=dev).expand(B).clone()
    outs = {k: [] for k in ("burst", "emit", "col", "slot")}
    for _ in range(steps):
        delta = torch.clamp(feed - (RING_BITS - nbuf), min=0)
        nbuf = nbuf + feed - delta
        buf_start = buf_start + delta
        a = buf_start
        b = buf_start + nbuf
        # UNLOCKED: scan for SYNC once two slots are buffered
        q0 = first_match(0, a, b)
        found = (state == 0) & (nbuf >= 2 * C.BITS_PER_TS) & (q0 < _BIG)
        state_u = torch.where(found, 1, state)
        nfs_u = torch.where(found, q0 + 296, nfs)
        # KNOW_FSTART (only a pre-existing one; a fresh acquisition waits)
        kf = (state == 1) & (a + nbuf >= nfs)
        nbuf = torch.where(kf, nbuf - (nfs - a), nbuf)
        buf_start = torch.where(kf, nfs, buf_start)
        nfs_k = torch.where(kf, nfs + C.BITS_PER_TS, nfs_u)
        state_k = torch.where(kf, 2, state_u)
        # LOCKED: at most one slot
        lk = ((state == 2) | kf) & (nbuf >= C.BITS_PER_TS)
        slot = buf_start
        blim = buf_start + nbuf
        key = torch.full_like(state, _BIG * 4)
        for ci in range(3):
            q = first_match(ci, slot, blim)
            key = torch.minimum(key, torch.where(q < _BIG, q * 4 + ci,
                                                 _BIG * 4))
        has = key < _BIG * 4
        col = torch.where(has, key & 3, -1)
        qw = key >> 2
        if tol:
            def at(ci, p):
                return gather(mcols[ci], p) & (p + _SEQ_LEN[ci] <= blim)
            e0 = at(0, slot + C.SYNC_TRAIN_OFFSET)
            e1 = at(1, slot + C.NORM_TRAIN_OFFSET)
            e2 = at(2, slot + C.NORM_TRAIN_OFFSET)
            eh = e0 | e1 | e2
            col = torch.where(eh, torch.where(e0, 0, torch.where(e1, 1, 2))
                              .to(i32), col)
            qw = torch.where(eh, torch.where(e0, slot + C.SYNC_TRAIN_OFFSET,
                                             slot + C.NORM_TRAIN_OFFSET), qw)
            has = has | eh
        rel = qw - slot
        is_sync = lk & (col == 0)
        sync_ok = is_sync & (rel == C.SYNC_TRAIN_OFFSET)
        is_norm = lk & ((col == 1) | (col == 2))
        norm_ok = is_norm & (rel == C.NORM_TRAIN_OFFSET)
        lost = lk & ~has
        emit = sync_ok | norm_ok
        state = torch.where((is_sync & ~sync_ok) | lost, 0, state_k)
        adv = torch.where(lk, C.BITS_PER_TS, 0).to(i32)
        for k, val in (("burst", lk), ("emit", emit), ("col", col),
                       ("slot", slot)):
            outs[k].append(val)
        buf_start = buf_start + adv
        nbuf = nbuf - adv
        nfs = nfs_k + adv
    return {k: (torch.stack(v) if v else
                torch.zeros((0, B), dtype=torch.int32, device=dev))
            for k, v in outs.items()}


def scan_stream(stream: torch.Tensor, tol: int = 0) -> dict:
    """Each carrier's whole stream of hard bits [B, T] (int8) from the
    receiver's initial state (unlocked, an empty buffer RING_PAD bits
    into a zero history), at tolerance `tol`: {'burst', 'emit', 'col',
    'slot'} [steps, B] with 'slot' the offset in the stream, steps =
    T // 64."""
    B, T = stream.shape
    win = torch.cat([torch.zeros((B, RING_PAD), dtype=torch.int8,
                                 device=stream.device),
                     stream.to(torch.int8)], dim=1)
    out = sync_scan(win, 0, RING_PAD, 0, RING_PAD, T // FEED_BITS, tol=tol)
    out["slot"] = out["slot"] - RING_PAD
    return out
