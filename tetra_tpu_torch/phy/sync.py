"""Burst synchronisation over a bit stream (port of tetra_tpu.phy.sync).

Reference behaviour: src/phy/tetra_burst_sync.c — a 3-state machine
(UNLOCKED -> KNOW_FSTART -> LOCKED) over a 4096-bit ring buffer fed 64
bits per call (tetra-rx.c:86), scanning for training sequences with
tetra_find_train_seq (tetra_burst.c:269-339, priority y, n, p, q, x)
and emitting one 510-bit timeslot per step once locked.

The per-bit correlation scan runs once for the whole chunk on the
device (phy.burst.match_columns); `align_stream` then replays the
reference's buffer/state arithmetic over that match map in O(1) work
per 64-bit feed quantum, on the host, line for line as the JAX package
has it. The multi-carrier path uses the vectorised twin in
phy.sync_vec, which steps the same integer state machine on the device.

Exactness notes (as in tetra_tpu.phy.sync):

* The search window is the reference's buffer occupancy, which depends
  on the 64-bit feed granularity, so matches can legally be found past
  the slot end; the same occupancy arithmetic is replayed.
* tetra_find_train_seq primes its 22-bit prefilter with in[0..19] and
  then shifts in cur[21], so for match positions 0..20 of a scan the
  register is polluted and matches there are usually missed; the
  polluted register is replicated exactly (_prefilter_visible).
* A mismatched normal-burst offset keeps the receiver LOCKED, while a
  mismatched SYNC offset or no match at all drops it to UNLOCKED
  (tetra_burst_sync.c:125-141).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tetra_tpu_torch import constants as C
from tetra_tpu_torch.device import resolve_device

__all__ = ["AlignedSlot", "SyncEvent", "SyncCarry", "align_stream",
           "compute_match_map", "RING_BITS", "FEED_BITS"]

RING_BITS = 4096       # sizeof(trs->bitbuf), tetra_burst_sync.h:17
FEED_BITS = 64         # read(fd, buf, 64), tetra-rx.c:86

# match-map column order is the scan priority (y,n,p,q,x),
# tetra_burst.c:273-283 / the per-position check order at :308-338
_PRIO = (C.TETRA_TRAIN_SYNC, C.TETRA_TRAIN_NORM_1, C.TETRA_TRAIN_NORM_2,
         C.TETRA_TRAIN_NORM_3, C.TETRA_TRAIN_EXT)
_SEQS = (C.TRAIN_Y, C.TRAIN_N, C.TRAIN_P, C.TRAIN_Q, C.TRAIN_X)
_SEQ_LEN = tuple(len(s) for s in _SEQS)
# 22-bit prefilter words (tetra_burst.c:273-283)
_PREF = tuple(int("".join(str(int(b)) for b in s[:22]), 2) for s in _SEQS)

_SYNC_COLS = (0,)          # UNLOCKED scans for SYNC only
_LOCKED_COLS = (0, 1, 2)   # LOCKED mask SYNC|NORM_1|NORM_2


@dataclass
class AlignedSlot:
    """One aligned 510-bit timeslot emitted by the synchroniser."""
    offset: int          # chunk-relative bit offset of the slot start
    train_id: int        # TETRA_TRAIN_*
    slot_index: int      # sequential index of LOCKED slot steps (time tracking)
    seq: int = 0         # global event sequence number (log ordering)


@dataclass
class SyncEvent:
    kind: str            # 'found_sync' | 'burst' | 'lost' | 'bad_offset'
    offset: int          # chunk-relative
    detail: int = 0      # found_sync: buffer-relative offset; bad_offset: rel
    seq: int = 0


@dataclass
class SyncCarry:
    """Resumable synchroniser state for chunked streaming — the exact
    integer image of the reference's persistent tetra_rx_state
    (tetra_burst_sync.h:13-21), with positions absolute in the stream.
    The buffer content is the stream slice [buf_start, buf_start +
    bits_in_buf); callers must retain at least that much history
    (TetraReceiver keeps the tail automatically)."""
    state: str = "UNLOCKED"       # UNLOCKED | KNOW_FSTART | LOCKED
    buf_start: int = 0            # bitbuf_start_bitnum
    bits_in_buf: int = 0
    next_frame_start: int = 0     # next_frame_start_bitnum
    fed: int = 0                  # absolute stream position consumed so far
    slot_index: int = 0           # LOCKED slot steps so far
    seq: int = 0                  # monotonically increasing event counter


def compute_match_map(bits, device=None) -> np.ndarray:
    """[L, 3] exact-match map of the SYNC, NORM_1 and NORM_2 training
    sequences (columns 0-2 of tetra_tpu's [L, 5] map, in the same order;
    the synchroniser reads no other column) via one device pass; [B, L]
    input gives [B, L, 3].

    The length is padded up to an 8192-bit bucket before the device
    call, as in the JAX package, so that a stream fed in arbitrary
    chunk lengths makes calls of few distinct shapes. The zero pad
    cannot fabricate matches at valid positions (a match at p <= L - n
    never reads pad bits); positions whose window would cross the true
    end are re-masked per template below, so the result is exactly the
    unpadded map."""
    from tetra_tpu_torch.phy.burst import match_columns
    bits = np.asarray(bits)
    L = bits.shape[-1]
    ncol = len(_LOCKED_COLS)
    if L < 38:                   # shorter than the longest template
        return np.zeros(bits.shape + (ncol,), bool)
    Lp = max(64, -(-L // 8192) * 8192)
    if Lp != L:
        bits = np.pad(bits, [(0, 0)] * (bits.ndim - 1) + [(0, Lp - L)])
    x = torch.as_tensor(bits.reshape(-1, Lp).astype(np.int8),
                        device=resolve_device(device))
    m = match_columns(x, _LOCKED_COLS).cpu().numpy()
    m = m.reshape(bits.shape[:-1] + (Lp, ncol))[..., :L, :].copy()
    if Lp != L:
        for c, n in enumerate(_SEQ_LEN[:ncol]):
            m[..., L - n + 1:, c] = False
    return m


def align_stream(bits, match: np.ndarray | None = None,
                 events: list | None = None,
                 carry: "SyncCarry | None" = None,
                 base_offset: int = 0,
                 feed: int = FEED_BITS,
                 flush: bool = True, device=None) -> list[AlignedSlot]:
    """Replay the reference synchroniser over `bits` and emit aligned
    slots plus ordered SyncEvents, bit-identical to tetra_burst_sync.c
    fed `feed` bits per call.

    bits: host uint8 ubits array starting at absolute stream position
    `base_offset`. When `carry` is given it is resumed and updated in
    place, enabling chunked streaming; emitted offsets are relative to
    `bits`. With flush=False, a trailing partial feed quantum is left
    pending (fed on a later call, mirroring a stream that has not hit
    EOF yet); flush=True feeds it like the reference's final short
    read(). match: a map with at least columns 0-2 (compute_match_map's
    3, or tetra_tpu's 5); computed on `device` when not given.
    """
    bits = np.asarray(bits, dtype=np.uint8)
    L = len(bits)
    end_abs = base_offset + L
    if match is None:
        match = compute_match_map(bits, device)
    # sorted absolute positions of full-sequence matches, per column
    pos = [np.flatnonzero(match[:, c]) + base_offset
           for c in range(len(_LOCKED_COLS))]
    ev = events if events is not None else []
    out: list[AlignedSlot] = []
    cy = carry if carry is not None else SyncCarry()
    if cy.buf_start < base_offset or cy.fed < base_offset:
        raise ValueError("carry refers to bits before this chunk")

    def _prefilter_visible(a: int, q: int, col: int) -> bool:
        """Whether a true match at q is visible given scan start a,
        replicating the polluted 22-bit register for the first 21 scan
        positions (tetra_burst.c:286-294: priming reads in[0..19], the
        shift reads cur[21] — in[20] never enters the register)."""
        k = q - a
        i0 = a - base_offset
        if k == 0:
            seg = np.concatenate([bits[i0:i0 + 20], bits[i0 + 21:i0 + 22]])
        else:
            seg = np.concatenate([bits[i0 + k - 1:i0 + 20],
                                  bits[i0 + 21:i0 + k + 22]])
        reg = 0
        for b in seg:
            reg = (reg << 1) | int(b)
        return reg == _PREF[col]

    def _find(a: int, b: int, cols) -> tuple[int, int]:
        """First visible match in buffer window [a, b): (abs pos, col)
        or (-1, -1). Position order first, column priority second —
        exactly tetra_find_train_seq's scan."""
        best_q, best_c = -1, -1
        for c in cols:
            arr = pos[c]
            i = int(np.searchsorted(arr, a))
            fit = b - _SEQ_LEN[c]
            while i < len(arr):
                q = int(arr[i])
                if best_q >= 0 and q >= best_q:
                    break
                if q > fit:       # no later match of this column fits
                    break
                if q - a < 21 and not _prefilter_visible(a, q, c):
                    i += 1
                    continue
                best_q, best_c = q, c
                break
        return best_q, best_c

    while True:
        remaining = end_abs - cy.fed
        if remaining <= 0 or (remaining < feed and not flush):
            break
        flen = min(feed, remaining)
        # make_bitbuf_space (tetra_burst_sync.c:38-52)
        space = RING_BITS - cy.bits_in_buf
        if space < flen:
            delta = flen - space
            cy.bits_in_buf -= delta
            cy.buf_start += delta
        cy.bits_in_buf += flen
        cy.fed += flen

        if cy.state == "UNLOCKED":
            if cy.bits_in_buf < 2 * C.BITS_PER_TS:
                continue
            q, c = _find(cy.buf_start, cy.buf_start + cy.bits_in_buf,
                         _SYNC_COLS)
            if q < 0:
                continue
            cy.seq += 1
            ev.append(SyncEvent("found_sync", q - base_offset,
                                q - cy.buf_start, cy.seq))
            cy.state = "KNOW_FSTART"
            cy.next_frame_start = q + 296
            continue

        if cy.state == "KNOW_FSTART":
            if cy.buf_start + cy.bits_in_buf < cy.next_frame_start:
                continue
            # shift start of frame to start of bitbuf, then fall through
            cy.bits_in_buf -= cy.next_frame_start - cy.buf_start
            cy.buf_start = cy.next_frame_start
            cy.next_frame_start += C.BITS_PER_TS
            cy.state = "LOCKED"

        # LOCKED: at most one slot per feed quantum
        if cy.bits_in_buf < C.BITS_PER_TS:
            continue
        slot = cy.buf_start
        cy.slot_index += 1
        cy.seq += 1
        burst_seq = cy.seq
        ev.append(SyncEvent("burst", slot - base_offset, 0, burst_seq))
        q, c = _find(slot, slot + cy.bits_in_buf, _LOCKED_COLS)
        if c == 0:  # SYNC
            rel = q - slot
            if rel == C.SYNC_TRAIN_OFFSET:
                out.append(AlignedSlot(slot - base_offset, C.TETRA_TRAIN_SYNC,
                                       cy.slot_index, burst_seq))
            else:
                cy.seq += 1
                ev.append(SyncEvent("bad_offset", slot - base_offset, rel,
                                    cy.seq))
                cy.state = "UNLOCKED"
        elif c in (1, 2):
            rel = q - slot
            if rel == C.NORM_TRAIN_OFFSET:
                out.append(AlignedSlot(slot - base_offset, _PRIO[c],
                                       cy.slot_index, burst_seq))
            else:
                cy.seq += 1
                ev.append(SyncEvent("bad_offset", slot - base_offset, rel,
                                    cy.seq))
                # reference stays LOCKED for a normal-burst mismatch
        else:
            cy.seq += 1
            ev.append(SyncEvent("lost", slot - base_offset, 0, cy.seq))
            cy.state = "UNLOCKED"
        cy.bits_in_buf -= C.BITS_PER_TS
        cy.buf_start += C.BITS_PER_TS
        cy.next_frame_start += C.BITS_PER_TS

    return out
