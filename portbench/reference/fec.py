"""The lower-MAC decode, worked out again (EN 300 392-2 clause 8;
osmo-tetra src/lower_mac/tetra_lower_mac.c): per block descramble,
deinterleave, depuncture (rate 2/3 over the rate-1/4 mother code),
16-state Viterbi, CRC16; the AACH block's systematic bits; and the
scrambling code of each slot, taken from the last SYNC block that
passed its CRC on the same carrier (the BSCH code for SB1 itself).

On a soft pipeline the blocks are decoded from the slots' int8 soft
values (positive = bit 0): descrambling flips their signs, and the
depunctured values go into the Viterbi's int32 metric as they are (the
receiver's f32 metric holds 127 times the same integers, exactly, so
its decisions and ties are these); the scrambling code still comes
from the hard decode of SB1 (soft < 0), and the AACH bits are hard.

`decode_slots` returns for each emitted slot the receiver's packed row:
[block A type-1 (SB1 60 / SCH/F 268 / NDB1 124, zero-padded to 268) |
block B type-1 (SB2 / - / NDB2, 124) | AACH type-1 (14) | okA | okB].
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference import constants as C

PACK_A, PACK_B, PACK_BBK = 268, 124, 14
ROW = PACK_A + PACK_B + PACK_BBK + 2


@functools.lru_cache(maxsize=16)
def keystream_matrix(n: int) -> np.ndarray:
    """M [32, n] over GF(2): the scrambler's keystream = state bits @ M
    (the 32-tap Fibonacci LFSR of EN 300 392-2 8.2.5, state bit j = bit
    j of the code)."""
    masks = [1 << j for j in range(32)]
    out = np.zeros((32, n), np.uint8)
    for i in range(n):
        fb = 0
        for y in C.SCRAMB_TAPS:
            fb ^= masks[32 - y]
        for j in range(32):
            out[j, i] = (fb >> j) & 1
        masks = masks[1:] + [fb]
    return out


def keystream(codes: torch.Tensor, n: int) -> torch.Tensor:
    """[R] int64 scrambling codes -> keystream bits [R, n] int8."""
    sh = torch.arange(32, device=codes.device)
    st = ((codes[:, None] >> sh) & 1).to(torch.float64)
    M = torch.as_tensor(keystream_matrix(n), dtype=torch.float64,
                        device=codes.device)
    return (torch.remainder(st @ M, 2)).to(torch.int8)


@functools.lru_cache(maxsize=16)
def _puncture(n3: int) -> np.ndarray:
    """Mother-sequence positions of the n3 type-3 bits, rate 2/3."""
    P, t, period, _ = C.PUNCT_SCHEMES["2_3"]
    P = np.asarray(P, np.int64)
    j = np.arange(1, n3 + 1, dtype=np.int64)
    q = (j - 1) // t
    return (period * q + P[j - t * q] - 1).astype(np.int64)


@functools.lru_cache(maxsize=16)
def _deinterleave(K: int, a: int) -> np.ndarray:
    """type-3 bit i comes from type-4 position (a (i+1)) mod K."""
    i = np.arange(1, K + 1, dtype=np.int64)
    return (a * i) % K


@functools.lru_cache(maxsize=2)
def _trellis():
    """(prev0, prev1, signs0 [16, 4], signs1 [16, 4]): for each new
    state its two predecessors and the expected mother-code symbols (+1
    for a 0 bit) of the branch from each; state s' = ((s & 7) << 1) | b."""
    gens = C.CONV_GENERATORS_CCH
    p0 = np.arange(16) >> 1
    p1 = p0 | 8
    b = np.arange(16) & 1

    def signs(prev):
        out = np.zeros((16, len(gens)), np.int32)
        for s in range(16):
            for gi, taps in enumerate(gens):
                bit = b[s]
                for d in taps:
                    bit ^= (prev[s] >> (d - 1)) & 1
                out[s, gi] = 1 - 2 * bit
        return out
    return p0, p1, signs(p0), signs(p1)


def viterbi(soft: torch.Tensor, n_sym: int) -> torch.Tensor:
    """Mother-code soft symbols [R, 4 n_sym] int32 (+1 bit 0, -1 bit 1,
    0 erased) -> bits [R, n_sym] int8: start in state 0; a decision takes
    the upper predecessor only when strictly better; the traceback
    starts at the lowest-index best state."""
    dev = soft.device
    R = soft.shape[0]
    p0, p1, s0, s1 = (torch.as_tensor(a, device=dev) for a in _trellis())
    x = soft.reshape(R, n_sym, 4).to(torch.int32)
    metric = torch.full((R, 16), -(1 << 27), dtype=torch.int32, device=dev)
    metric[:, 0] = 0
    decs = []
    for t in range(n_sym):
        xt = x[:, t, None, :]
        c0 = metric[:, p0] + (xt * s0).sum(-1, dtype=torch.int32)
        c1 = metric[:, p1] + (xt * s1).sum(-1, dtype=torch.int32)
        d = c1 > c0
        metric = torch.where(d, c1, c0)
        decs.append(d)
    best = metric.max(dim=1, keepdim=True).values
    state = torch.where(metric == best, torch.arange(16, device=dev),
                        16).min(dim=1).values
    bits = torch.empty((R, n_sym), dtype=torch.int8, device=dev)
    for t in range(n_sym - 1, -1, -1):
        bits[:, t] = (state & 1).to(torch.int8)
        took = decs[t].gather(1, state[:, None])[:, 0].to(torch.int64)
        state = (state >> 1) | (took << 3)
    return bits


def crc16_ok(bits: torch.Tensor) -> torch.Tensor:
    """CRC16-CCITT (init 0xFFFF, polynomial 0x1021, MSB first) over the
    rows [R, n]; a row passes when the register ends at 0x1D0F."""
    reg = torch.full((bits.shape[0],), 0xFFFF, dtype=torch.int64,
                     device=bits.device)
    b = bits.to(torch.int64)
    for i in range(bits.shape[1]):
        top = ((reg >> 15) & 1) ^ b[:, i]
        reg = ((reg << 1) & 0xFFFF) ^ (top * 0x1021)
    return reg == C.TETRA_CRC_OK


def decode_block(kind: str, type5: torch.Tensor, codes: torch.Tensor,
                 soft: bool = False):
    """type-5 bits [R, n345] of one CRC-protected block kind, scrambled
    with codes [R] -> (type-1 bits [R, n1] int8, crc ok [R] bool); soft:
    type5 holds soft values (positive = bit 0) instead of bits."""
    n345, n2, n1, a, _ = C.BLOCK_PARAMS[kind]
    R = type5.shape[0]
    if R == 0:
        return (torch.zeros((0, n1), dtype=torch.int8, device=type5.device),
                torch.zeros(0, dtype=torch.bool, device=type5.device))
    ks = keystream(codes, n345)
    if soft:
        type4 = type5.to(torch.int32) * (1 - 2 * ks.to(torch.int32))
    else:
        type4 = 1 - 2 * (type5.to(torch.int8) ^ ks).to(torch.int32)
    dev = type5.device
    type3 = type4[:, torch.as_tensor(_deinterleave(n345, a), device=dev)]
    mother = torch.zeros((R, 4 * n2), dtype=torch.int32, device=dev)
    mother[:, torch.as_tensor(_puncture(n345), device=dev)] = type3
    type2 = viterbi(mother, n2)
    return type2[:, :n1], crc16_ok(type2[:, :n1 + 16])


def sb1_code(t1: torch.Tensor) -> torch.Tensor:
    """The cell scrambling code from SB1 type-1 bits [R, 60]: ((mcc <<
    20 | mnc << 6 | colour) << 2) | 3 (tetra_scramb.c:87-99)."""
    def u(lo, n):
        w = 1 << torch.arange(n - 1, -1, -1, device=t1.device)
        return (t1[:, lo:lo + n].to(torch.int64) * w).sum(-1)
    return (((u(31, 10) << 20) | (u(41, 14) << 6) | u(4, 6)) << 2) \
        | C.SCRAMB_INIT


def slot_bits(stream: torch.Tensor, car: np.ndarray, pos: np.ndarray
              ) -> torch.Tensor:
    """The 510 values of each slot (carrier car [S], stream offset pos
    [S]) of the streams [B, T] -> [S, 510]."""
    dev = stream.device
    idx = (torch.as_tensor(pos, device=dev)[:, None]
           + torch.arange(C.BITS_PER_TS, device=dev)[None])
    return stream[torch.as_tensor(car, device=dev)[:, None], idx]


def slot_codes(bursts: torch.Tensor, car: np.ndarray, kind: np.ndarray):
    """Each emitted slot's scrambling code, from the hard bits [S, 510]
    of the slots in order within each carrier (car [S], kind [S]): the
    code that the last SYNC slot at or before it on its carrier names,
    where that slot's SB1 passed its CRC with the BSCH code, else the
    receiver's initial 0. Returns (codes [S] int64, the SYNC slots' SB1
    type-1 bits, their CRC flags)."""
    dev = bursts.device
    S = len(car)
    sync = np.flatnonzero(kind == 0)
    sb1_t5 = bursts[torch.as_tensor(sync, device=dev),
                    C.SB_BLK1_OFFSET:C.SB_BLK1_OFFSET + C.SB_BLK1_BITS]
    sb1, sb1_ok = decode_block(
        "SB1", sb1_t5, torch.full((len(sync),), C.SCRAMB_INIT,
                                  dtype=torch.int64, device=dev))
    have = np.zeros(S, bool)
    have[sync] = sb1_ok.cpu().numpy()
    code_at = np.zeros(S, np.int64)
    code_at[sync] = sb1_code(sb1).cpu().numpy()
    last = np.maximum.accumulate(np.where(have, np.arange(S), -1))
    same = (last >= 0) & (car[np.maximum(last, 0)] == car)
    codes_np = np.where(same, code_at[np.maximum(last, 0)], 0)
    return torch.as_tensor(codes_np, device=dev), sb1, sb1_ok


def decode_slots(stream: torch.Tensor, car: np.ndarray, pos: np.ndarray,
                 kind: np.ndarray, soft: torch.Tensor | None = None
                 ) -> np.ndarray:
    """Emitted slots, in order within each carrier (car [S], stream
    offset pos [S], kind [S]: 0 SYNC, 1 SCH/F, 2 NDB) of the hard-bit
    streams [B, T] -> their packed rows [S, ROW] uint8. soft: the soft
    values [B, T] of a soft pipeline, from which the blocks decode."""
    dev = stream.device
    S = len(car)
    out = np.zeros((S, ROW), np.uint8)
    if S == 0:
        return out
    bursts = slot_bits(stream, car, pos)
    blocks = bursts if soft is None else slot_bits(soft, car, pos)
    sync = np.flatnonzero(kind == 0)
    codes, sb1, sb1_ok = slot_codes(bursts, car, kind)

    # the AACH block of every slot: descrambled systematic bits
    sync_t = torch.as_tensor(kind == 0, device=dev)[:, None]
    bbk_sync = bursts[:, C.SB_BBK_OFFSET:C.SB_BBK_OFFSET + C.SB_BBK_BITS]
    bbk_norm = torch.cat([
        bursts[:, C.NDB_BBK1_OFFSET:C.NDB_BBK1_OFFSET + C.NDB_BBK1_BITS],
        bursts[:, C.NDB_BBK2_OFFSET:C.NDB_BBK2_OFFSET + C.NDB_BBK2_BITS]],
        dim=1)
    bbk = torch.where(sync_t, bbk_sync, bbk_norm).to(torch.int8) \
        ^ keystream(codes, 30)
    out[:, PACK_A + PACK_B:PACK_A + PACK_B + PACK_BBK] = \
        bbk[:, :14].cpu().numpy()

    def put(rows, t1, ok, col, okcol):
        rows_t = rows
        out[rows_t, col:col + t1.shape[1]] = t1.cpu().numpy()
        out[rows_t, okcol] = ok.cpu().numpy()

    sd = soft is not None
    r = torch.as_tensor(sync, device=dev)
    if sd:
        sb1, sb1_ok = decode_block(
            "SB1", blocks[r, C.SB_BLK1_OFFSET:C.SB_BLK1_OFFSET
                          + C.SB_BLK1_BITS],
            torch.full((len(sync),), C.SCRAMB_INIT, dtype=torch.int64,
                       device=dev), soft=True)
    put(sync, sb1, sb1_ok, 0, ROW - 2)
    blk1 = (C.NDB_BLK1_OFFSET, C.NDB_BLK1_OFFSET + C.NDB_BLK_BITS)
    blk2 = (C.NDB_BLK2_OFFSET, C.NDB_BLK2_OFFSET + C.NDB_BLK_BITS)
    t1, ok = decode_block("SB2", blocks[r, C.SB_BLK2_OFFSET:C.SB_BLK2_OFFSET
                                        + C.SB_BLK2_BITS], codes[r], sd)
    put(sync, t1, ok, PACK_A, ROW - 1)
    schf = np.flatnonzero(kind == 1)
    r = torch.as_tensor(schf, device=dev)
    t1, ok = decode_block("SCH_F", torch.cat(
        [blocks[r, blk1[0]:blk1[1]], blocks[r, blk2[0]:blk2[1]]], dim=1),
        codes[r], sd)
    put(schf, t1, ok, 0, ROW - 2)
    ndb = np.flatnonzero(kind == 2)
    r = torch.as_tensor(ndb, device=dev)
    t1, ok = decode_block("NDB", blocks[r, blk1[0]:blk1[1]], codes[r], sd)
    put(ndb, t1, ok, 0, ROW - 2)
    t1, ok = decode_block("NDB", blocks[r, blk2[0]:blk2[1]], codes[r], sd)
    put(ndb, t1, ok, PACK_A, ROW - 1)
    return out
