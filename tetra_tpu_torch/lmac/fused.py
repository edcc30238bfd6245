"""Kind-compacted whole-slot FEC decode (port of tetra_tpu.lmac.fused).

Reference behaviour: src/lower_mac/tetra_lower_mac.c:143-274 decodes
each burst by its training-sequence kind (SYNC -> SB1+SB2, NORM_1 ->
SCH/F, NORM_2 -> NDB x2). All three kinds map onto ONE 288-step
segmented trellis with per-slot restarts at {80, 144, 224}:

  SYNC : [SB1 80][SB2 144][pad 64]      restarts at 80, 224
  SCH/F: [SCH_F 288]                    no restarts
  NDB  : [NDB1 144][NDB2 144]           restart at 144

Each slot is descrambled against its kind's keystream plane (slot
position -> keystream bit) and the kind's assembly map spreads the
signs into mother order inside kernel K1 (ops.viterbi_assembled),
which also runs the Viterbi and the five CRC16 checks.

Soft input (soft_input=True, the demod="soft" path): descrambling is a
sign flip of the soft values, the same assembly map spreads them into
mother order times 127 (an index gather here, where tetra_tpu multiplies
by its one-hot spread matrix outside any kernel: every row holds one
127, so the numbers are the same), kernel K4 (ops.viterbi_segmented)
runs the f32 Viterbi and ops.crc checks the five CRC16 segments.
With tracing on (utils.trace), the K4 call is the span "chunk.fec.k4"
and the counter "fec.soft_rows" adds the rows handed to it.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tetra_tpu_torch import constants as C
from tetra_tpu_torch.lmac.pipeline import BlockResult
from tetra_tpu_torch.ops import interleave, rcpc, scramble
from tetra_tpu_torch.ops.crc import crc16_check
from tetra_tpu_torch.ops.viterbi_assembled import AssembledCode
from tetra_tpu_torch.ops.viterbi_segmented import decode_segmented_k4
from tetra_tpu_torch.utils import trace

__all__ = ["FusedTables", "assemble_parts", "assemble_soft",
           "decode_slots_fused",
           "BOUNDARIES", "CRC_SEGS", "N_SYM"]

N_SYM = 288                   # unified trellis length (= SCH/F)
N_MOTHER = N_SYM * 4
BOUNDARIES = (80, 144, 224)   # union of per-kind segment starts
# CRC16-checked ranges of the decoded output (incl. the 16 CRC bits):
# SB1, SB2, SCH/F, NDB1, NDB2
CRC_SEGS = ((0, 76), (80, 140), (0, 284), (0, 140), (144, 140))
_KS_CELL = 432                # cell keystream prefix needed by any kind
_KS_FIXED_OFF = _KS_CELL      # BSCH keystream region in the ks vector
_KS_PAD = _KS_CELL + 120      # zero pad position
_SLOT_PAD = C.BITS_PER_TS     # zero pad position in the slot vector
_SLOT_W = 512                 # slot vector padded width


@functools.lru_cache(maxsize=1)
def _maps():
    """Per-kind assembly tables (kind axis: 0=SYNC, 1=SCH/F, 2=NDB):
    sel_slot / sel_ks (payload index -> slot / keystream position), the
    one-hot spread P [3, 432, 1152], rmask [3, 3] restarts, bbk [3, 30]
    broadcast-block slot positions, ks_fixed (BSCH keystream)."""
    L = 432
    sel_slot = np.full((3, L), _SLOT_PAD, np.int32)
    sel_ks = np.full((3, L), _KS_PAD, np.int32)
    P = np.zeros((3, L, N_MOTHER), np.float32)

    def fill(kind, l_off, m_off, n345, ia, slot_off, ks_off):
        punct = rcpc.puncture_indices("2_3", n345)
        _, deint = interleave.interleave_indices(n345, ia)
        for j in range(n345):
            x = int(deint[j])
            l = l_off + j
            sel_slot[kind, l] = (slot_off(x) if callable(slot_off)
                                 else slot_off + x)
            sel_ks[kind, l] = ks_off + x
            P[kind, l, m_off + int(punct[j])] = 127.0

    # SYNC: SB1 (fixed BSCH scrambling) then SB2 (cell scrambling)
    fill(0, 0, 0, 120, 11, C.SB_BLK1_OFFSET, _KS_FIXED_OFF)
    fill(0, 120, 320, 216, 101, C.SB_BLK2_OFFSET, 0)
    # SCH/F: blk1||blk2 interleaved as one 432-bit block
    fill(1, 0, 0, 432, 103,
         lambda x: C.NDB_BLK1_OFFSET + x if x < 216
         else C.NDB_BLK2_OFFSET + (x - 216), 0)
    # NDB: two independent 216-bit blocks, each a fresh keystream
    fill(2, 0, 0, 216, 101, C.NDB_BLK1_OFFSET, 0)
    fill(2, 216, 576, 216, 101, C.NDB_BLK2_OFFSET, 0)

    rmask = np.array([[1, 0, 1],     # SYNC: SB2 @80, pad @224
                      [0, 0, 0],     # SCH/F
                      [0, 1, 0]],    # NDB: NDB2 @144
                     np.float32)
    bbk = np.zeros((3, 30), np.int32)
    bbk[0] = C.SB_BBK_OFFSET + np.arange(30)
    bbk[1] = bbk[2] = np.concatenate([
        C.NDB_BBK1_OFFSET + np.arange(C.NDB_BBK1_BITS),
        C.NDB_BBK2_OFFSET + np.arange(C.NDB_BBK2_BITS)])
    ks_fixed = scramble.keystream_np(C.SCRAMB_INIT, 120).astype(np.int8)
    return sel_slot, sel_ks, P, rmask, bbk, ks_fixed


@functools.lru_cache(maxsize=1)
def _maps_planes():
    """P2[k, p, m]: the one-hot spread from slot position p straight to
    mother position m for kind k (sel_slot composed into P)."""
    sel_slot, sel_ks, P, rmask, bbk, ks_fixed = _maps()
    P2 = np.zeros((3, _SLOT_W, N_MOTHER), np.float32)
    for k in range(3):
        for l in range(432):
            p = int(sel_slot[k, l])
            if p < C.BITS_PER_TS:
                P2[k, p] = P[k, l]
    return P2


class FusedTables(nn.Module):
    """Constant tables of the fused decode: keystream gather maps, the
    per-kind restart masks, broadcast-block positions and the K1
    assembly code (one map per kind, slot position -> mother)."""

    def __init__(self):
        super().__init__()
        sel_slot, sel_ks, _, rmask, bbk, ks_fixed = _maps()
        P2 = _maps_planes()
        self.code = AssembledCode([P2[k].T for k in range(3)], N_SYM,
                                  BOUNDARIES, CRC_SEGS)
        self.register_buffer("sel_slot", torch.tensor(sel_slot, dtype=torch.int64))
        self.register_buffer("sel_ks", torch.tensor(sel_ks, dtype=torch.int64))
        self.register_buffer("rmask", torch.tensor(rmask, dtype=torch.int8))
        self.register_buffer("bbk", torch.tensor(bbk, dtype=torch.int64))
        self.register_buffer("ks_fixed", torch.tensor(ks_fixed))


@functools.lru_cache(maxsize=4)
def fused_tables(device: torch.device) -> FusedTables:
    return FusedTables().to(device)


def _keystream_plane(inits, k, tables: FusedTables):
    """Per-slot keystream of kind k arranged by slot position: (plane
    [N, 512] int8, ks_cell [N, 432])."""
    N = k.shape[0]
    ks_cell = scramble.keystream(inits, _KS_CELL)
    ksv = torch.cat([ks_cell, tables.ks_fixed.expand(N, 120),
                     torch.zeros((N, 1), dtype=torch.int8,
                                 device=k.device)], dim=1)
    plane = torch.zeros((N, _SLOT_W), dtype=torch.int8, device=k.device)
    plane.scatter_(1, tables.sel_slot[k], ksv.gather(1, tables.sel_ks[k]))
    return plane, ks_cell


def assemble_parts(slots, inits, kinds, tables: FusedTables):
    """slots [N, 510] hard bits, inits [N] int64 scrambling codes, kinds
    [N] -> (x [N, 512] int8 descrambled signs of the slot's kind, tab
    [N] int32 kind map row, rm [N, 3] int8 restarts, ks_cell [N, 432]).

    Kinds outside 0..2 decode as kind 0, as in the JAX path."""
    k = kinds.to(torch.int64).clamp(0, 2)
    plane, ks_cell = _keystream_plane(inits, k, tables)
    src = F.pad(slots.to(torch.int8), (0, _SLOT_W - C.BITS_PER_TS))
    x = (1 - 2 * (src ^ plane)).to(torch.int8)
    return x, k.to(torch.int32), tables.rmask[k], ks_cell


def assemble_soft(slots, inits, kinds, tables: FusedTables):
    """slots [N, 510] float32 soft values (positive = bit 0) -> (soft
    [N, 1152] float32 in mother order, 127 x the descrambled value or 0
    at an erasure; rm [N, 3] int8 restarts; ks_cell [N, 432])."""
    k = kinds.to(torch.int64).clamp(0, 2)
    plane, ks_cell = _keystream_plane(inits, k, tables)
    src = F.pad(slots.to(torch.float32), (0, _SLOT_W - C.BITS_PER_TS + 1))
    flip = F.pad(1 - 2 * plane.to(torch.float32), (0, 1))
    desc = src * flip                       # column 512 is the erasure 0
    idx = tables.code.pidx.to(torch.int64)[k]
    soft = desc.gather(1, torch.where(idx < 0, _SLOT_W, idx)) * 127.0
    return soft, tables.rmask[k], ks_cell


def decode_slots_fused(slots, inits, kinds, soft_input: bool = False) -> dict:
    """Mixed-kind batched lower MAC: slots [..., 510] hard bits +
    scrambling codes broadcastable to the slot batch (int64) + kinds
    (0 SYNC / 1 SCH/F / 2 NDB / -1 none) -> the tetra_tpu result dict
    (sb1/sb2/schf/ndb1/ndb2/bbk BlockResults, kinds, crc_ok).

    soft_input=True takes float soft values (positive = bit 0) in place
    of hard bits and decodes with kernel K4; the broadcast block, which
    has no FEC, is hard-sliced (soft < 0)."""
    dev = slots.device
    tables = fused_tables(dev)
    batch = slots.shape[:-1]
    N = int(np.prod(batch)) if batch else 1
    kinds_b = torch.as_tensor(kinds, device=dev).expand(batch)
    kinds_f = kinds_b.reshape(N)
    inits_f = torch.as_tensor(inits, dtype=torch.int64,
                              device=dev).expand(batch).reshape(N)
    if soft_input:
        soft_f = slots.reshape(N, C.BITS_PER_TS).to(torch.float32)
        slots_f = (soft_f < 0).to(torch.int8)
        soft, rm, ks_cell = assemble_soft(soft_f, inits_f, kinds_f, tables)
        trace.count("fec.soft_rows", soft.shape[0])
        with trace.span("chunk.fec.k4"):
            bits = decode_segmented_k4(soft, rm, N_SYM, BOUNDARIES)
        oks = [crc16_check(bits[:, off:off + ln]) for off, ln in CRC_SEGS]
    else:
        slots_f = slots.reshape(N, C.BITS_PER_TS).to(torch.int8)
        x, tab, rm, ks_cell = assemble_parts(slots_f, inits_f, kinds_f,
                                             tables)
        bits, okf = tables.code(x, tab, rm)
        oks = [okf[:, i] != 0 for i in range(len(CRC_SEGS))]
    is_sync = kinds_f.clamp(0, 2) == 0

    def block(t2, n1, ok):
        return BlockResult(t2[..., :n1].reshape(*batch, n1),
                           ok.reshape(batch),
                           t2.reshape(*batch, t2.shape[-1]))

    sb1 = block(bits[:, :80], 60, oks[0])
    sb2 = block(bits[:, 80:224], 124, oks[1])
    schf = block(bits, 268, oks[2])
    ndb1 = block(bits[:, :144], 124, oks[3])
    ndb2 = block(bits[:, 144:288], 124, oks[4])

    # broadcast block: kind-selected position, fresh cell keystream,
    # reference copy-through semantics (tetra_lower_mac.c:268-271)
    bbk_sync = slots_f[:, tables.bbk[0]]
    bbk_norm = slots_f[:, tables.bbk[1]]
    bbk_t4 = torch.where(is_sync[:, None], bbk_sync, bbk_norm) \
        ^ ks_cell[:, :30]
    bbk = BlockResult(bbk_t4[:, :14].reshape(*batch, 14),
                      torch.ones(batch, dtype=torch.bool, device=dev),
                      bbk_t4.reshape(*batch, 30))

    crc_ok = torch.where(
        kinds_b == 0, sb1.crc_ok & sb2.crc_ok,
        torch.where(kinds_b == 1, schf.crc_ok,
                    torch.where(kinds_b == 2, ndb1.crc_ok & ndb2.crc_ok,
                                torch.zeros_like(schf.crc_ok))))
    return {"kinds": kinds_b, "crc_ok": crc_ok, "sb1": sb1, "sb2": sb2,
            "schf": schf, "ndb1": ndb1, "ndb2": ndb2, "bbk": bbk}
