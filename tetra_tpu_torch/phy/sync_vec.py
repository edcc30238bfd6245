"""Vectorised burst synchroniser (port of tetra_tpu.phy.sync_vec).

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

sync_scan_plain is a Python loop over steps (tens of small ops per
step), the plain version the tests hold the kernel against. sync_scan
dispatches on the bits' device: on the CPU the plain version, on a card
kernel S1 (csrc/sync_scan.cu, one thread per carrier, every step in one
launch) after batched torch ops build the next-match maps once a call.

MultiSync is the host wrapper of the Python control plane: chunked
streaming over [B, L] bit arrays with an absolute-position carry, whose
per-carrier slot and event lists equal phy.sync.align_stream's.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from tetra_tpu_torch import constants as C, kernels
from tetra_tpu_torch.device import resolve_device
from tetra_tpu_torch.phy.burst import LOCKED_COLS, match_columns
from tetra_tpu_torch.phy.sync import (FEED_BITS, RING_BITS, AlignedSlot,
                                      SyncEvent, _PRIO, _SEQS, _SEQ_LEN)

__all__ = ["sync_scan", "sync_scan_plain", "sync_steps", "next_match_maps",
           "OUT_KEYS", "VecSyncCarry", "MultiSync"]

_BIG = 1 << 27
_PAT0 = tuple(int(_SEQS[c][0]) for c in LOCKED_COLS)
_PAT1_EQ_PAT0 = tuple(bool(_SEQS[c][1] == _SEQS[c][0]) for c in LOCKED_COLS)
OUT_KEYS = ("burst", "emit", "col", "slot", "found", "found_rel",
            "found_q", "bad", "bad_rel", "lost")


def sync_scan_plain(bits, state0, buf_start0, nbuf0, nfs0, slot0, fed0: int,
                    steps: int, feed: int = FEED_BITS, tol: int = 0):
    """Run `steps` feed quanta of the reference state machine over bits
    [B, L] (chunk-relative int32 positions).

    tol: training-sequence bit-error tolerance (burst.match_columns).
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
    match = match_columns(bits, LOCKED_COLS, tol)       # [B, L, 3]
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


# the kernel's output planes, in the order of its two output tensors
_FLAG_KEYS = ("burst", "emit", "found", "bad", "lost")
_INT_KEYS = ("col", "slot", "found_rel", "found_q", "bad_rel")
# the protocol constants S1 is built with, in tt_sync_scan_constants'
# order
_KERNEL_CONSTANTS = (C.BITS_PER_TS, RING_BITS, C.SYNC_TRAIN_OFFSET,
                     C.NORM_TRAIN_OFFSET,
                     *(_SEQ_LEN[c] for c in LOCKED_COLS), *_PAT0,
                     *map(int, _PAT1_EQ_PAT0))


@functools.cache
def _check_kernel_constants() -> None:
    """Raise unless S1 was built with this module's protocol constants
    (once per process, before its first launch)."""
    got = (ctypes.c_int * len(_KERNEL_CONSTANTS))()
    kernels.lib().tt_sync_scan_constants(ctypes.addressof(got))
    if tuple(got) != _KERNEL_CONSTANTS:
        raise RuntimeError(f"csrc/sync_scan.cu's constants {tuple(got)} "
                           f"differ from sync_vec's {_KERNEL_CONSTANTS}")


def next_match_maps(bits, tol: int = 0) -> torch.Tensor:
    """nm [3, B, L + 1] int32: for each locked column, the first position
    at or after each one where its training sequence matches (with at
    most `tol` bit errors), L where none, and L at the sentinel position
    L. Batched torch ops, once per sync_scan call on a card."""
    B, L = bits.shape
    match = match_columns(bits, LOCKED_COLS, tol)           # [B, L, 3]
    idx = torch.arange(L, dtype=torch.int32, device=bits.device)
    v = torch.where(match.permute(2, 0, 1), idx, L)         # [3, B, L]
    nm = torch.full((len(LOCKED_COLS), B, L + 1), L, dtype=torch.int32,
                    device=bits.device)
    nm[..., :L] = torch.cummin(v.flip(2), dim=2).values.flip(2)
    return nm


def sync_steps(bits, nm, carry, steps: int, feed: int = FEED_BITS,
               tol: int = 0):
    """Kernel S1 alone, one launch (none when steps or B is 0): `steps`
    feed quanta from carry [5, B] int32 (state, buf_start, nbuf, nfs,
    slot_index) over bits int8 [B, L] and nm = next_match_maps(bits,
    tol), all on one card and contiguous (sync_scan checks them; nm may
    be None when there is no step to run). Returns (carry_out [5, B],
    flags [5, steps, B] bool (burst, emit, found, bad, lost), ints
    [5, steps, B] int32 (col, slot, found_rel, found_q, bad_rel))."""
    B, L = bits.shape
    dev = bits.device
    flags = torch.empty((len(_FLAG_KEYS), steps, B), dtype=torch.bool,
                        device=dev)
    ints = torch.empty((len(_INT_KEYS), steps, B), dtype=torch.int32,
                       device=dev)
    if steps == 0 or B == 0:
        return carry.clone(), flags, ints
    _check_kernel_constants()
    carry_out = torch.empty_like(carry)
    rc = kernels.lib().tt_sync_scan(
        bits.data_ptr(), nm.data_ptr(), carry.data_ptr(), B, L, steps, feed,
        int(bool(tol)), carry_out.data_ptr(), flags.data_ptr(),
        ints.data_ptr(), kernels.stream_ptr(dev))
    kernels.check(rc, "tt_sync_scan")
    sync_scan.launches += 1
    return carry_out, flags, ints


def sync_scan(bits, state0, buf_start0, nbuf0, nfs0, slot0, fed0: int,
              steps: int, feed: int = FEED_BITS, tol: int = 0):
    """sync_scan_plain's function (same arguments and return value) on
    the bits' device: the plain version for a CPU tensor, kernel S1 for
    a CUDA tensor (bits int8 [B, L], contiguous; the carry tensors [B]
    on the same card), which raises rather than fall back. On a card a
    call makes a fixed number of launches whatever `steps` is: the
    next-match maps (next_match_maps), the carry's stack and one launch
    of S1 for all steps (none when steps or B is 0); out's bool planes
    are bytes 0/1 as the plain version's, its int planes int32."""
    if bits.device.type == "cpu":
        return sync_scan_plain(bits, state0, buf_start0, nbuf0, nfs0, slot0,
                               fed0, steps, feed, tol)
    if bits.device.type != "cuda":
        raise ValueError(f"sync_scan: no kernel for device {bits.device}")
    kernels.require_cuda(bits, "bits", torch.int8, 2)
    B, L = bits.shape
    dev = bits.device
    carry = torch.stack([x.to(torch.int32) for x in
                         (state0, buf_start0, nbuf0, nfs0, slot0)])
    if carry.shape != (5, B) or carry.device != dev:
        raise ValueError(f"sync_scan: the carry must be [{B}] tensors on "
                         f"{dev}, got {tuple(carry.shape[1:])} on "
                         f"{carry.device}")
    nm = next_match_maps(bits, tol) if steps > 0 and B > 0 else None
    carry_out, flags, ints = sync_steps(bits, nm, carry, steps, feed, tol)
    planes = dict(zip(_FLAG_KEYS, flags)) | dict(zip(_INT_KEYS, ints))
    out = {k: planes[k] for k in OUT_KEYS}
    return (*carry_out.unbind(0), int(fed0) + steps * feed), out


sync_scan.launches = 0


@dataclass
class VecSyncCarry:
    """Per-carrier synchroniser state, absolute stream positions
    (host-side int64 so indefinitely long streams never wrap)."""
    state: np.ndarray        # [B] 0=UNLOCKED 1=KNOW_FSTART 2=LOCKED
    buf_start: np.ndarray    # [B]
    bits_in_buf: np.ndarray  # [B]
    nfs: np.ndarray          # [B] next_frame_start
    slot_index: np.ndarray   # [B]
    fed: int = 0             # common scan position (same stream length/carrier)

    @classmethod
    def zeros(cls, n: int) -> "VecSyncCarry":
        z = lambda: np.zeros(n, dtype=np.int64)
        return cls(z(), z(), z(), z(), z(), 0)


class MultiSync:
    """Host wrapper: chunked streaming over [B, L] bit arrays with an
    absolute-position carry, emitting per-carrier AlignedSlot/SyncEvent
    lists identical to phy.sync.align_stream per carrier. The scan runs
    on `device` (the card unless the caller asks for the CPU)."""

    def __init__(self, n_carriers: int, feed: int = FEED_BITS, device=None):
        self.carry = VecSyncCarry.zeros(n_carriers)
        self.n = n_carriers
        self.feed = feed
        self.device = resolve_device(device)

    def scan(self, bits, base_offset: int = 0):
        """bits [B, L] covering absolute [base_offset, base_offset+L).
        Only whole feed quanta are consumed (callers keep the tail).
        Returns (slots_per_carrier, events_per_carrier); offsets are
        ABSOLUTE stream positions (unlike align_stream's chunk-relative
        ones), since multi-carrier callers slice a shared ring."""
        cy = self.carry
        bits = np.asarray(bits, dtype=np.uint8)
        B, L = bits.shape
        assert B == self.n
        end_abs = base_offset + L
        steps = int((end_abs - cy.fed) // self.feed)
        slots = [[] for _ in range(B)]
        events = [[] for _ in range(B)]
        if steps <= 0:
            return slots, events
        if cy.buf_start.min() < base_offset or cy.fed < base_offset:
            raise ValueError("carry refers to bits before this chunk")

        dev = self.device
        rel = lambda x: (x - base_offset).astype(np.int32)
        i32 = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)
        (st, bs, nb, nfs, si, _fed), out = sync_scan(
            torch.as_tensor(bits.astype(np.int8), device=dev),
            i32(cy.state), i32(rel(cy.buf_start)), i32(cy.bits_in_buf),
            i32(np.maximum(rel(cy.nfs), -1)), i32(cy.slot_index * 0),
            int(cy.fed - base_offset), steps, self.feed)
        # three device-to-host transfers, not one per array
        i8_keys = ("burst", "emit", "found", "bad", "lost", "col")
        i32_keys = ("slot", "found_rel", "found_q", "bad_rel")
        pk8 = torch.stack([out[k].to(torch.int8) for k in i8_keys]) \
            .cpu().numpy()
        pk32 = torch.stack([out[k] for k in i32_keys]).cpu().numpy()
        cyv = torch.stack([st, bs, nb, nfs, si]).cpu().numpy()
        out = {k: pk8[i] for i, k in enumerate(i8_keys)}
        out.update({k: pk32[i] for i, k in enumerate(i32_keys)})
        st, bs, nb, nfs, si = cyv

        # rebuild ordered per-carrier event/slot lists (host, numpy masks)
        seq0 = 0  # per-carrier seq restarts per chunk; ordering is per step
        for b in range(B):
            sidx = int(cy.slot_index[b])
            seq = seq0
            for t in np.flatnonzero(out["burst"][:, b] | out["found"][:, b]):
                t = int(t)
                if out["found"][t, b]:
                    seq += 1
                    events[b].append(SyncEvent(
                        "found_sync",
                        int(out["found_q"][t, b]) + base_offset,
                        int(out["found_rel"][t, b]), seq))
                    continue
                sidx += 1
                seq += 1
                burst_seq = seq
                slot_abs = int(out["slot"][t, b]) + base_offset
                events[b].append(SyncEvent("burst", slot_abs, 0, burst_seq))
                if out["emit"][t, b]:
                    slots[b].append(AlignedSlot(
                        slot_abs, _PRIO[int(out["col"][t, b])],
                        sidx, burst_seq))
                elif out["bad"][t, b]:
                    seq += 1
                    events[b].append(SyncEvent("bad_offset", slot_abs,
                                               int(out["bad_rel"][t, b]), seq))
                elif out["lost"][t, b]:
                    seq += 1
                    events[b].append(SyncEvent("lost", slot_abs, 0, seq))

        # persist carry with absolute positions
        cy.state = np.asarray(st, np.int64)
        cy.buf_start = np.asarray(bs, np.int64) + base_offset
        cy.bits_in_buf = np.asarray(nb, np.int64)
        cy.nfs = np.asarray(nfs, np.int64) + base_offset
        cy.slot_index = cy.slot_index + np.asarray(si, np.int64)
        cy.fed += steps * self.feed
        return slots, events

    def min_buf_start(self) -> int:
        return int(self.carry.buf_start.min())
