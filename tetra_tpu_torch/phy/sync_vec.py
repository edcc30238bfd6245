"""Vectorised burst synchroniser (port of tetra_tpu.phy.sync_vec.sync_scan).

Reference behaviour: src/phy/tetra_burst_sync.c stepped 64 bits at a
time (tetra-rx.c:86). Per-carrier state is a handful of int32 tensors;
each 64-bit feed quantum is one step of where-selects, vectorised over
carriers. The training-sequence search inside the reference's buffer
window is O(1) per step: one match map, reverse cumulative minima for
next-match-at-or-after, and the closed-form visibility rules of
tetra_find_train_seq's polluted 22-bit prefilter (see tetra_tpu's
module notes):
    visible(k >= 21) = True
    visible(k == 20) = bits[q-1] == pat[0]
    visible(k == 19) = bits[q-1] == pat[0] and pat[1] == pat[0]

This is a Python loop over steps, so on a GPU it is bound by kernel
launches (tens of small ops per step); a one-thread-per-carrier kernel
is queued in ROADMAP.md.
"""
from __future__ import annotations

import torch

from tetra_tpu_torch import constants as C
from tetra_tpu_torch.phy.burst import LOCKED_COLS, train_seq_match
from tetra_tpu_torch.phy.sync import FEED_BITS, RING_BITS, _SEQS, _SEQ_LEN

__all__ = ["sync_scan", "OUT_KEYS"]

_BIG = 1 << 27
_PAT0 = tuple(int(_SEQS[c][0]) for c in LOCKED_COLS)
_PAT1_EQ_PAT0 = tuple(bool(_SEQS[c][1] == _SEQS[c][0]) for c in LOCKED_COLS)
OUT_KEYS = ("burst", "emit", "col", "slot", "found", "found_rel",
            "found_q", "bad", "bad_rel", "lost")


def sync_scan(bits, state0, buf_start0, nbuf0, nfs0, slot0, fed0: int,
              steps: int, feed: int = FEED_BITS, tol: int = 0):
    """Run `steps` feed quanta of the reference state machine over bits
    [B, L] (chunk-relative int32 positions).

    tol: training-sequence bit-error tolerance (burst.train_seq_match).
    0 replays the reference's exact matcher. With tol > 0 a locked slot
    first checks the expected offsets (SYNC at 214, NORM at 244) and
    falls back to the first-match scan only when neither holds, and the
    tolerant map also feeds acquisition (both as tetra_tpu does).

    Returns ((state, buf_start, nbuf, nfs, slot_index, fed), out) with
    out[key] a [steps, B] tensor for key in OUT_KEYS:
      burst      processed-slot flag (TDMA clock advances)
      emit       aligned-slot flag
      col        winning column 0/1/2 (-1 when none)
      slot       slot start offset
      found      SYNC acquisition flag
      found_rel  buffer-relative acquisition offset; found_q absolute
      bad        bad-offset flag;  bad_rel   its offset inside the slot
      lost       lock-loss flag
    """
    dev = bits.device
    B, L = bits.shape
    i32 = torch.int32
    idx = torch.arange(L, dtype=i32, device=dev)
    match = train_seq_match(bits, tol)                  # [B, L, 3]
    prev = torch.cat([torch.zeros((B, 1), dtype=bits.dtype, device=dev),
                      bits[:, :-1]], dim=1)
    false_col = torch.zeros((B, 1), dtype=torch.bool, device=dev)
    sentinel = torch.full((B, 1), L, dtype=i32, device=dev)
    nms, viz20s = [], []
    # tolerant mode: match columns with a False sentinel (lookups at L)
    mcols = [torch.cat([match[..., ci], false_col], dim=1)
             for ci in range(len(LOCKED_COLS))] if tol else None
    for ci in range(len(LOCKED_COLS)):
        v = torch.where(match[..., ci], idx, L)
        nm = torch.cummin(v.flip(1), dim=1).values.flip(1)
        # sentinel columns so lookups at q == L are in range
        nms.append(torch.cat([nm, sentinel], dim=1))
        viz20s.append(torch.cat([prev == _PAT0[ci], false_col], dim=1))

    def gather(arr, pos):
        pos = pos.clamp(0, L).to(torch.int64)
        return arr.gather(1, pos[:, None])[:, 0]

    def first_match(ci, a, b):
        """First visible+fitting match of column ci in buffer window
        [a, b), or _BIG (phy.sync._find for one column)."""
        nm = nms[ci]
        q = gather(nm, a)
        for _ in range(2):  # chase polluted-invisible candidates
            k = q - a
            vis20 = gather(viz20s[ci], q)
            vis = (k >= 21) | ((k == 20) & vis20)
            if _PAT1_EQ_PAT0[ci]:
                vis = vis | ((k == 19) & vis20)
            q = torch.where((q < L) & ~vis, gather(nm, q + 1), q)
        fit = q + _SEQ_LEN[LOCKED_COLS[ci]] <= b
        return torch.where(fit & (q < L), q, _BIG)

    state = state0.to(i32)
    buf_start = buf_start0.to(i32)
    nbuf = nbuf0.to(i32)
    nfs = nfs0.to(i32)
    slot_index = slot0.to(i32)
    zero = torch.zeros_like(state)
    outs = {k: [] for k in OUT_KEYS}
    for _ in range(steps):
        # make_bitbuf_space + append (tetra_burst_sync.c:38-66)
        delta = torch.clamp(feed - (RING_BITS - nbuf), min=0)
        nbuf = nbuf + feed - delta
        buf_start = buf_start + delta
        a = buf_start
        b = buf_start + nbuf

        # UNLOCKED: scan for SYNC once >= 2 slots buffered
        q0 = first_match(0, a, b)
        found = (state == 0) & (nbuf >= 2 * C.BITS_PER_TS) & (q0 < _BIG)
        found_rel = torch.where(found, q0 - a, zero)
        state_u = torch.where(found, 1, state)
        nfs_u = torch.where(found, q0 + 296, nfs)

        # KNOW_FSTART (only pre-existing; a fresh acquisition waits)
        kf = (state == 1) & (a + nbuf >= nfs)
        nbuf = torch.where(kf, nbuf - (nfs - a), nbuf)
        buf_start = torch.where(kf, nfs, buf_start)
        nfs_k = torch.where(kf, nfs + C.BITS_PER_TS, nfs_u)
        state_k = torch.where(kf, 2, state_u)

        # LOCKED: process at most one slot
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
            # near-matches multiply under tolerance, and an earlier
            # spurious hit would shadow the true sequence: the expected
            # offsets win, the first-match scan is the fallback
            def at(ci, p):
                return gather(mcols[ci], p) \
                    & (p + _SEQ_LEN[LOCKED_COLS[ci]] <= blim)
            e0 = at(0, slot + C.SYNC_TRAIN_OFFSET)
            e1 = at(1, slot + C.NORM_TRAIN_OFFSET)
            e2 = at(2, slot + C.NORM_TRAIN_OFFSET)
            eh = e0 | e1 | e2
            ecol = torch.where(e0, 0, torch.where(e1, 1, 2)).to(i32)
            col = torch.where(eh, ecol, col)
            qw = torch.where(eh, torch.where(e0, slot + C.SYNC_TRAIN_OFFSET,
                                             slot + C.NORM_TRAIN_OFFSET), qw)
            has = has | eh
        rel = qw - slot

        is_sync = lk & (col == 0)
        sync_ok = is_sync & (rel == C.SYNC_TRAIN_OFFSET)
        is_norm = lk & ((col == 1) | (col == 2))
        norm_ok = is_norm & (rel == C.NORM_TRAIN_OFFSET)
        lost = lk & ~has
        bad = (is_sync & ~sync_ok) | (is_norm & ~norm_ok)
        emit = sync_ok | norm_ok

        state = torch.where((is_sync & ~sync_ok) | lost, 0, state_k)
        slot_index = slot_index + lk.to(i32)
        adv = torch.where(lk, C.BITS_PER_TS, 0).to(i32)
        for k, val in (("burst", lk), ("emit", emit), ("col", col),
                       ("slot", slot), ("found", found),
                       ("found_rel", found_rel),
                       ("found_q", torch.where(found, q0, zero)),
                       ("bad", bad), ("bad_rel", torch.where(bad, rel, zero)),
                       ("lost", lost)):
            outs[k].append(val)
        buf_start = buf_start + adv
        nbuf = nbuf - adv
        nfs = nfs_k + adv

    def stack(vals, dtype):
        if vals:
            return torch.stack(vals)
        return torch.zeros((0, B), dtype=dtype, device=dev)

    out = {k: stack(v, torch.bool if k in ("burst", "emit", "found", "bad",
                                            "lost") else i32)
           for k, v in outs.items()}
    fed = int(fed0) + steps * feed
    return (state, buf_start, nbuf, nfs, slot_index, fed), out
