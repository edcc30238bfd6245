"""Fused multi-carrier chunk pipeline (port of tetra_tpu.fastpath).

Reference behaviour: the per-chunk receiver loop of src/tetra-rx.c:82-95
— burst sync, TDMA clock, lower-MAC FEC, upper-MAC walk — over N
carriers at once.

Per chunk, on the device: dequantize -> PFB channelize (K2) -> resample
to 36 kHz (K3) -> hard demod at os=4 -> ring splice -> sync scan ->
GLOBAL slot compaction (one stable argsort over carriers x steps) ->
SB1 pre-decode (K1, 80 steps) -> scrambling-code forward fill ->
kind-compacted FEC (K1, 288 steps) -> per-kind section packing -> ONE
int8 bundle [G*40 + B*32], plus the traffic payloads t4_full [G, 432] and
t4_b2 [G, 216] (each slot's type-4 bits: the whole 432-bit block, and
the second half with its own keystream), which stay on the device for
the receiver's traffic dumps and voice decode. The ring tail, the sync
carry and the scrambling codes stay on the device between chunks. On the host the
bundle is parsed with numpy (`_decode_segments`) and walked by the C++
control plane. If a chunk emits more slots than the row budget G, the
chunk re-runs from its saved inputs with the sufficient budget
(`_overflow_rerun`).

Soft mode (soft=True, the receiver's demod="soft"): the demod emits
int8 reliabilities (positive = bit 0) and the ring carries them; the
sync scan (with `tol` training-sequence bit errors allowed), the SB1
pre-decode, the payload sections and the traffic payloads read hard
bits (soft < 0), and the FEC gathers the soft slot rows and decodes them with kernel K4. Hard
bits fed to a soft pipeline become full-confidence ±31 values.

The bundle bytes and the traffic payloads are identical to tetra_tpu's
for the same inputs. Sharded meshes are not ported.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tetra_tpu_torch import constants as C
from tetra_tpu_torch.io import stream
from tetra_tpu_torch.lmac import fused, pipeline
from tetra_tpu_torch.ops import scramble
from tetra_tpu_torch.phy import dqpsk, pfb
from tetra_tpu_torch.phy.burst import split_norm_burst
from tetra_tpu_torch.phy.sync import FEED_BITS, RING_BITS
from tetra_tpu_torch.phy.sync_vec import sync_scan
from tetra_tpu_torch.rx import _PACK_BITS, _pack_selected

__all__ = ["FastChunkPipeline", "PipelineState", "carry_from_numpy",
           "fused_chunk", "fused_chunk_iq", "max_slots", "ROW_BYTES",
           "RING_PAD"]

ROW_BYTES = 40            # 36 packed section bytes + flags+delta+car16
_SEC_BYTES = 36           # ceil(282 / 8): worst-kind section total
SIDE_I32 = 8              # n_slots tail st bs nb nfs si scramb
RING_PAD = RING_BITS + 512   # device-resident tail: ring depth + slack
G_SLACK = 3               # per-carrier row-budget slack over chunk/510
SOFT_ONE = 31             # soft value of a full-confidence hard bit


def max_slots(steps: int, feed: int) -> int:
    """Static bound on slots one carrier can emit in `steps` quanta."""
    return int(min(steps, (RING_BITS + steps * feed) // C.BITS_PER_TS + 1))


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding [0, 2^32) -> int32 with the same bits."""
    return (((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _fused_chunk_body(ring, chunk, end_rel: int, rebase: int, st0, bs0,
                      nb0, nfs0, fed_rel: int, scr0, steps: int, feed: int,
                      g_rows: int, soft: bool = False, tol: int = 0):
    """One ingest chunk on the device.

    ring [B, RING_PAD] int8: last RING_PAD stream bits (carry).
    chunk [B, lc_pad] int8: this chunk's new bits.
    soft: ring and chunk hold int8 soft values instead of bits; tol:
    the sync scan's training-sequence bit-error tolerance.
    end_rel: window-relative stream end; rebase: window base delta
    since the carry was written; fed_rel: scan position in this window.
    st0, bs0, nb0, nfs0 [B] int32 sync carry; scr0 [B] int64 cell
    scrambling codes. g_rows: global row budget G.

    Returns (bundle [G*ROW_BYTES + B*32] int8, new_ring,
    (st, bs, nb, nfs, scr_final), t4_full [G, 432] int8, t4_b2 [G, 216]
    int8)."""
    dev = ring.device
    B = ring.shape[0]
    G = g_rows
    win = torch.cat([ring, chunk.to(torch.int8)], dim=1)
    bits = (win < 0).to(torch.int8) if soft else win
    L = win.shape[1]

    (st, bs, nb, nfs, si, _), out = sync_scan(
        bits, st0, bs0 - rebase, nb0, nfs0 - rebase, st0 * 0, fed_rel,
        steps, feed, tol)

    # ---- GLOBAL slot compaction: one stable argsort over carriers x
    # steps; emitted slots get carrier-major keys c*steps + t, holes
    # sort last, so the first G rows are the emitted slots in walk order
    emitT = out["emit"].T                                   # [B, steps]
    burstT = out["burst"].T.to(torch.int32)
    n_slots = emitT.sum(dim=1, dtype=torch.int32)
    big = B * steps
    ar = torch.arange(B * steps, dtype=torch.int32, device=dev)
    keys = torch.where(emitT.reshape(-1), ar, big)
    gorder = torch.argsort(keys, stable=True)[:G]
    gvalid = keys[gorder] < big
    zero = torch.zeros_like(gorder)
    gcar = torch.where(gvalid, gorder // steps, zero)
    kind = torch.where(gvalid, out["col"].T.reshape(-1)[gorder].to(torch.int64), zero)
    soff = torch.where(gvalid, out["slot"].T.reshape(-1)[gorder].to(torch.int64), zero)

    # TDMA burst deltas: bursts (incl. own) since the previous emitted
    # slot; tail = bursts after the last one (tetra_burst_sync.c:113)
    bc = torch.cumsum(burstT, dim=1, dtype=torch.int32)
    prev = torch.cummax(torch.where(emitT, bc, 0), dim=1).values
    prev = torch.cat([torch.zeros((B, 1), dtype=torch.int32, device=dev),
                      prev[:, :-1]], dim=1)
    delta_step = torch.where(emitT, bc - prev, 0)
    tail = bc[:, -1] - delta_step.sum(dim=1, dtype=torch.int32)
    delta = delta_step.reshape(-1)[gorder]

    # ---- slot bits [G, 510]: one gather from the window
    pos = (gcar * L + soff)[:, None] \
        + torch.arange(C.BITS_PER_TS, device=dev)[None, :]
    flat = bits.reshape(-1)[pos]

    # ---- SB1 pre-decode + scrambling-code forward fill
    # (tetra_lower_mac.c:283-310); rows are carrier-major, so the fill
    # is segmented by carrier: the last SB1-bearing row at or before
    # each row, if it belongs to the same carrier
    r1 = pipeline.decode_block(
        "SB1", flat[:, C.SB_BLK1_OFFSET: C.SB_BLK1_OFFSET + C.SB_BLK1_BITS],
        C.SCRAMB_INIT)
    t1 = r1.type1.to(torch.int64)

    def field(a, b):
        w = 1 << torch.arange(b - a - 1, -1, -1, device=dev)
        return (t1[:, a:b] * w).sum(-1)

    newinit = ((((field(31, 41) & 0x3FF) << 20)
                | ((field(41, 55) & 0x3FFF) << 6)
                | (field(4, 10) & 0x3F)) << 2) | C.SCRAMB_INIT
    have = gvalid & (kind == 0) & r1.crc_ok
    segcar = torch.where(gvalid, gcar, -1)
    rows = torch.arange(G, device=dev)
    last = torch.cummax(torch.where(have, rows, -1), dim=0).values
    lastc = last.clamp(min=0)
    fh = (last >= 0) & (segcar[lastc] == segcar)
    inits = torch.where(fh, newinit[lastc], scr0[gcar])
    # per-carrier final code: the fill value at each carrier's last row
    # (carriers with no rows this chunk keep their carry)
    segend = gvalid & torch.cat([segcar[1:] != segcar[:-1],
                                 torch.ones(1, dtype=torch.bool,
                                            device=dev)])
    scr_ext = torch.cat([scr0, torch.zeros(1, dtype=scr0.dtype,
                                           device=dev)])
    scr_ext = scr_ext.scatter(0, torch.where(segend, gcar, B), inits)
    scr_final = scr_ext[:B]

    # ---- traffic payloads: type-4 bits of SCH/F (one 432-bit block) and
    # of an NDB's second half (its own fresh keystream), for the dumps
    _, b1, b2 = split_norm_burst(flat)
    t4_full = scramble.scramb_bits(inits, torch.cat([b1, b2], dim=1))
    t4_b2 = scramble.scramb_bits(inits, b2)

    # ---- kind-compacted FEC decode + per-kind section packing
    if soft:
        soft_rows = win.reshape(-1)[pos].to(torch.float32)
        res = fused.decode_slots_fused(soft_rows, inits, kind,
                                       soft_input=True)
    else:
        res = fused.decode_slots_fused(flat, inits, kind)
    pk = _pack_selected(res, kind)                       # [G, 408] int8

    A, Bs, K = pk[:, :268], pk[:, 268:392], pk[:, 392:406]

    def z(n):
        return torch.zeros((G, n), dtype=pk.dtype, device=dev)

    lay0 = torch.cat([A[:, :60], Bs, K, z(90)], dim=1)   # SYNC 198
    lay1 = torch.cat([A, K, z(6)], dim=1)                # SCHF 282
    lay2 = torch.cat([A[:, :124], Bs, K, z(26)], dim=1)  # NDB 262
    kk = kind[:, None]
    pay = torch.where(kk == 0, lay0, torch.where(kk == 1, lay1, lay2))
    w8 = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=torch.int32,
                      device=dev)
    pay_b = (pay.reshape(-1, _SEC_BYTES, 8).to(torch.int32) * w8).sum(-1)
    # one flag byte: kind(2) | okA<<2 | okB<<3 | valid<<4
    flags = (kind.to(torch.int32)
             | (pk[:, _PACK_BITS].to(torch.int32) << 2)
             | (pk[:, _PACK_BITS + 1].to(torch.int32) << 3)
             | (gvalid.to(torch.int32) << 4))
    row = torch.cat([
        pay_b.to(torch.uint8),
        flags.to(torch.uint8)[:, None],
        delta.clamp(0, 255).to(torch.uint8)[:, None],
        (gcar & 255).to(torch.uint8)[:, None],
        (gcar >> 8).to(torch.uint8)[:, None]], dim=1)    # [G, 40]
    side = torch.stack([n_slots, tail, st, bs, nb, nfs, si,
                        _to_i32(scr_final)], dim=1).contiguous()
    bundle = torch.cat([row.view(torch.int8).reshape(G * ROW_BYTES),
                        side.view(torch.int8).reshape(B * 4 * SIDE_I32)])
    new_ring = win[:, end_rel - RING_PAD:end_rel].contiguous()
    return bundle, new_ring, (st, bs, nb, nfs, scr_final), t4_full, t4_b2


def _unpack(packed, lc_pad: int, soft: bool = False):
    """[B, lc_pad/8] uint8 MSB-first -> [B, lc_pad] int8 bits, or on a
    soft pipeline their full-confidence soft values ±SOFT_ONE."""
    shifts = torch.arange(7, -1, -1, device=packed.device)
    B = packed.shape[0]
    b = ((packed.to(torch.int32)[..., None] >> shifts) & 1).reshape(B, lc_pad)
    if soft:
        b = (1 - 2 * b) * SOFT_ONE
    return b.to(torch.int8)


def fused_chunk(ring, packed, end_rel, rebase, st0, bs0, nb0, nfs0, fed_rel,
                scr0, steps: int, feed: int, g_rows: int, lc_pad: int,
                soft: bool = False, tol: int = 0):
    """Packed-bits entry: packed [B, lc_pad//8] uint8 (MSB first)."""
    return _fused_chunk_body(ring, _unpack(packed, lc_pad, soft), end_rel,
                             rebase, st0, bs0, nb0, nfs0, fed_rel, scr0,
                             steps, feed, g_rows, soft, tol)


def _iq_to_ri(fmt: str, raw):
    """Wideband ingest format -> planar float32 (re, im) on the device."""
    if fmt == "iq4c":
        return stream.dequantize_iq4c(raw)
    if fmt == "iq4":
        return stream.dequantize_iq4(raw)
    if fmt == "iq8":
        return raw[0::2].to(torch.float32), raw[1::2].to(torch.float32)
    if fmt == "f32i":
        return raw[0::2].contiguous(), raw[1::2].contiguous()
    raise ValueError(fmt)


def _iq_frontend(raw, channel_idx, fmt: str, n_chan: int, fs: float,
                 sps: int, soft: bool = False):
    """Wideband raw samples -> per-carrier hard bits (or int8 soft
    values, soft=True) [C, Lf]: dequantize -> PFB channelize ->
    resample -> DQPSK demod (os=4)."""
    re, im = _iq_to_ri(fmt, raw)
    cr, ci = pfb.pfb_to_demod_rate_ri(re, im, channel_idx, n_chan, fs)
    demod = dqpsk.demodulate_soft_ri if soft else dqpsk.demodulate_hard_ri
    return demod(cr, ci, sps=sps, os=4)


def fused_chunk_iq(ring, raw, channel_idx, end_rel, rebase, st0, bs0, nb0,
                   nfs0, fed_rel, scr0, fmt: str, n_chan: int, fs: float,
                   sps: int, keep: int, steps: int, feed: int, g_rows: int,
                   lc_pad: int, soft: bool = False, tol: int = 0):
    """Wideband-IQ entry: raw quantized RF samples -> the chunk bundle.
    keep: how many trailing demod bits are NEW stream bits."""
    bits_full = _iq_frontend(raw, channel_idx, fmt, n_chan, fs, sps, soft)
    chunk = bits_full[:, bits_full.shape[1] - keep:]
    if lc_pad != keep:
        chunk = F.pad(chunk, (0, lc_pad - keep))
    return _fused_chunk_body(ring, chunk, end_rel, rebase, st0, bs0, nb0,
                             nfs0, fed_rel, scr0, steps, feed, g_rows, soft,
                             tol)


def _iq_frontend_bits(raw, channel_idx, fmt: str, n_chan: int, fs: float,
                      sps: int, keep: int, soft: bool = False):
    """Front end alone (short-chunk absorb path): the trailing `keep`
    new bits (or soft values)."""
    bits_full = _iq_frontend(raw, channel_idx, fmt, n_chan, fs, sps, soft)
    return bits_full[:, bits_full.shape[1] - keep:]


def _pack_bits_device(bits, lc_pad: int):
    """Device [B, Lc] hard bits -> packed [B, lc_pad/8] uint8 (MSB first)."""
    B, Lc = bits.shape
    b = bits.to(torch.int32) & 1
    if lc_pad != Lc:
        b = F.pad(b, (0, lc_pad - Lc))
    w8 = 1 << torch.arange(7, -1, -1, device=bits.device)
    return (b.reshape(B, lc_pad // 8, 8) * w8).sum(-1).to(torch.uint8)


def _absorb_bits(ring, bits):
    """Short-chunk path: append < one feed quantum of bits to the ring."""
    win = torch.cat([ring, bits.to(torch.int8)], dim=1)
    return win[:, win.shape[1] - RING_PAD:].contiguous()


def _absorb(ring, packed, lc: int, lc_pad: int, soft: bool = False):
    """Short-chunk path for packed input: append lc bits to the ring."""
    win = torch.cat([ring, _unpack(packed, lc_pad, soft)], dim=1)
    return win[:, lc:lc + RING_PAD].contiguous()


@dataclass(eq=False)
class ChunkHandle:
    """A dispatched chunk whose bundle has not been fetched. Holds the
    re-dispatch closure so a budget overflow can re-run it; the handle
    is updated in place on a re-run, so that rows gathered from t4_full
    and t4_b2 by the collected slot_refs are the rows those refs index."""
    bundle: torch.Tensor       # device [G*ROW_BYTES + B*32] int8
    t4_full: torch.Tensor      # device [G, 432] int8
    t4_b2: torch.Tensor        # device [G, 216] int8
    g_rows: int
    inputs: tuple | None = None   # (dispatch fn(scr, g_rows), scr it ran with)
    maxs: int = 0                 # sufficient per-carrier budget


@dataclass
class PipelineState:
    """The pipeline carry: ring tail, sync carry (st, bs, nb, nfs) and
    scrambling codes (int64), and the host stream positions."""
    ring: torch.Tensor
    carry: tuple
    carry_base: int
    end: int
    fed: int


def carry_from_numpy(ring, carry, carry_base: int, end: int, fed: int,
                     device) -> PipelineState:
    """A tetra_tpu FastChunkPipeline's state given as numpy arrays (ring
    [B, RING_PAD] int8, carry = (st, bs, nb, nfs int32, scramb uint32))
    -> the port's PipelineState on `device`, to resume mid-stream."""
    dev = torch.device(device)
    st, bs, nb, nfs, scr = carry
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=dev)
    return PipelineState(
        ring=torch.tensor(np.asarray(ring, np.int8), device=dev),
        carry=(i32(st), i32(bs), i32(nb), i32(nfs),
               torch.tensor(np.asarray(scr, np.uint32).astype(np.int64),
                            device=dev)),
        carry_base=int(carry_base), end=int(end), fed=int(fed))


class FastChunkPipeline:
    """Host driver: device-resident ring + sync/scramble carry, deferred
    single-fetch results. Submit chunks with `submit` / `submit_iq`,
    fetch and decode with `collect`.

    soft=True: the ring carries int8 soft values, submit_iq demodulates
    soft and the FEC runs kernel K4; tol (training-sequence bit errors
    the sync scan accepts) defaults to 2 on a soft pipeline, 0 else."""

    def __init__(self, n_carriers: int, device, soft: bool = False,
                 tol: int | None = None):
        self.n = n_carriers
        self.device = torch.device(device)
        self.feed = FEED_BITS
        self.soft = soft
        self.tol = (2 if soft else 0) if tol is None else tol
        z = lambda v=0: torch.full((n_carriers,), v, dtype=torch.int32,
                                   device=self.device)
        # positions are relative to carry_base; abs 0 == rel RING_PAD
        self.state = PipelineState(
            ring=torch.zeros((n_carriers, RING_PAD), dtype=torch.int8,
                             device=self.device),
            carry=(z(), z(RING_PAD), z(), z(RING_PAD),
                   torch.zeros(n_carriers, dtype=torch.int64,
                               device=self.device)),
            carry_base=-RING_PAD, end=0, fed=0)
        self._outstanding: list[ChunkHandle] = []

    def submit(self, bits) -> ChunkHandle | None:
        """Dispatch one chunk of per-carrier hard bits [B, Lc] (numpy,
        packed on the host, or a device tensor, packed on the device)."""
        B, Lc = bits.shape
        if B != self.n:
            raise ValueError(f"expected {self.n} carriers, got {B}")
        lc_pad = -(-Lc // 32) * 32
        if isinstance(bits, torch.Tensor):
            packed = _pack_bits_device(bits.to(self.device), lc_pad)
        else:
            b = np.asarray(bits, dtype=np.uint8) & 1
            if lc_pad != Lc:
                b = np.pad(b, ((0, 0), (0, lc_pad - Lc)))
            packed = torch.as_tensor(np.packbits(b, axis=1),
                                     device=self.device)
        s = self.state
        steps = int((s.end + Lc - s.fed) // self.feed)
        if steps <= 0:
            s.ring = _absorb(s.ring, packed, Lc, lc_pad, self.soft)
            s.end += Lc
            return None
        feed, soft, tol = self.feed, self.soft, self.tol

        def make_fn(ring0, rebase, end_rel, fed_rel, st, bs, nb, nfs):
            def dispatch(scr, g_rows):
                return fused_chunk(ring0, packed, end_rel, rebase, st, bs,
                                   nb, nfs, fed_rel, scr, steps, feed,
                                   g_rows, lc_pad, soft, tol)
            return dispatch
        return self._submit_common(Lc, steps, make_fn)

    def submit_iq(self, raw, fmt: str, keep: int, channel_idx,
                  n_chan: int, fs: float, sps: int = 2) -> ChunkHandle | None:
        """Dispatch one WIDEBAND chunk: raw quantized RF samples (with the
        caller's overlap-save history) -> the fused chunk program. keep:
        how many trailing demod bits are NEW stream bits."""
        lc_pad = -(-keep // 32) * 32
        s = self.state
        steps = int((s.end + keep - s.fed) // self.feed)
        raw_d = torch.as_tensor(np.asarray(raw)).to(self.device)
        if steps <= 0:
            bits = _iq_frontend_bits(raw_d, channel_idx, fmt, n_chan, fs,
                                     sps, keep, self.soft)
            s.ring = _absorb_bits(s.ring, bits)
            s.end += keep
            return None
        feed, soft, tol = self.feed, self.soft, self.tol

        def make_fn(ring0, rebase, end_rel, fed_rel, st, bs, nb, nfs):
            def dispatch(scr, g_rows):
                return fused_chunk_iq(ring0, raw_d, channel_idx, end_rel,
                                      rebase, st, bs, nb, nfs, fed_rel, scr,
                                      fmt, n_chan, fs, sps, keep, steps,
                                      feed, g_rows, lc_pad, soft, tol)
            return dispatch
        return self._submit_common(keep, steps, make_fn)

    def _submit_common(self, Lc: int, steps: int, make_fn) -> ChunkHandle:
        """Window geometry, carry snapshot, dispatch, carry advance. The
        dispatch closure is always kept: an overflow in an EARLIER chunk
        corrects the scrambling-code carry, which must then be
        re-committed through chunks dispatched with the stale value."""
        s = self.state
        new_base = s.end - RING_PAD
        end_abs = s.end + Lc
        maxs = max_slots(steps, self.feed)
        G = self.n * min(maxs, steps * self.feed // C.BITS_PER_TS + G_SLACK)
        st, bs, nb, nfs, scr = s.carry
        dispatch = make_fn(s.ring, new_base - s.carry_base,
                           end_abs - new_base, s.fed - new_base,
                           st, bs, nb, nfs)
        bundle, ring, carry, t4f, t4b = dispatch(scr, G)
        s.ring = ring
        s.carry = carry
        s.carry_base = new_base
        s.end = end_abs
        s.fed += steps * self.feed
        h = ChunkHandle(bundle, t4f, t4b, G, (dispatch, scr), maxs)
        self._outstanding.append(h)
        return h

    def collect(self, h: ChunkHandle) -> dict:
        """Fetch one chunk's bundle and decode it to numpy arrays:
        {carrier, kind, okA, okB, delta, payload [n, 408], slot_ref,
         n_slots [B], tail [B], scramb [B], side_carrier}. A row-budget
        overflow re-runs the chunk with the sufficient budget first."""
        d = self._decode_segments(h.g_rows, h.bundle.cpu().numpy())
        if d is None:
            if h.inputs is None or h.g_rows >= self.n * h.maxs:
                raise RuntimeError("slot compaction overflow (bound bug)")
            self._overflow_rerun(h)
            return self.collect(h)
        if h in self._outstanding:
            self._outstanding.remove(h)
        return d

    def _decode_segments(self, G: int, bundle: np.ndarray) -> dict | None:
        """Parse a fetched bundle into the collect dict; None signals a
        row-budget overflow."""
        B = self.n
        rows = np.ascontiguousarray(bundle[:G * ROW_BYTES]) \
            .view(np.uint8).reshape(G, ROW_BYTES)
        side = np.ascontiguousarray(bundle[G * ROW_BYTES:]) \
            .view(np.int32).reshape(B, SIDE_I32)
        total = int(side[:, 0].sum())
        if total > G:
            return None
        sel = rows[:total]
        f = sel[:, _SEC_BYTES].astype(np.int32)
        if not (f & 16).all():
            raise RuntimeError("valid rows must form a prefix")
        cars = (sel[:, _SEC_BYTES + 2].astype(np.int32)
                | (sel[:, _SEC_BYTES + 3].astype(np.int32) << 8))
        # re-expand the per-kind packed sections to the canonical
        # [n, 408] row (A 268 | B 124 | BBK 14 | okA | okB)
        sec = np.unpackbits(np.ascontiguousarray(sel[:, :_SEC_BYTES]),
                            axis=1)
        kk = f & 3
        payload = np.zeros((total, 408), np.uint8)
        m = kk == 0
        payload[m, 0:60] = sec[m, 0:60]
        payload[m, 268:392] = sec[m, 60:184]
        payload[m, 392:406] = sec[m, 184:198]
        m = kk == 1
        payload[m, 0:268] = sec[m, 0:268]
        payload[m, 392:406] = sec[m, 268:282]
        m = kk == 2
        payload[m, 0:124] = sec[m, 0:124]
        payload[m, 268:392] = sec[m, 124:248]
        payload[m, 392:406] = sec[m, 248:262]
        return {
            "carrier": cars,
            "okA": (f >> 2) & 1,
            "okB": (f >> 3) & 1,
            "kind": kk,
            "delta": sel[:, _SEC_BYTES + 1].astype(np.int32),
            "payload": payload,
            "slot_ref": np.arange(total, dtype=np.int32),
            "n_slots": side[:, 0], "tail": side[:, 1],
            "scramb": side[:, 7].view(np.uint32),
            "side_carrier": np.arange(B, dtype=np.int32),
        }

    def _dispatch(self, h: ChunkHandle, g_rows: int, scr_override=None):
        """(Re-)run a chunk from its saved closure with row budget
        g_rows, updating the handle in place; returns the carry."""
        fn, scr = h.inputs
        if scr_override is not None:
            scr = scr_override
            h.inputs = (fn, scr)
        bundle, _, carry, t4f, t4b = fn(scr, g_rows)
        h.bundle, h.t4_full, h.t4_b2, h.g_rows = bundle, t4f, t4b, g_rows
        return carry

    def _overflow_rerun(self, h: ChunkHandle) -> None:
        """Re-run an overflowed chunk with the sufficient budget, then
        carry the corrected scrambling codes through every chunk
        dispatched after it and into the pipeline head."""
        scr = self._dispatch(h, self.n * h.maxs)[4]
        later = self._outstanding[self._outstanding.index(h) + 1:]
        for h2 in later:
            if torch.equal(h2.inputs[1], scr):
                return          # the stale carry was already correct
            scr = self._dispatch(h2, h2.g_rows, scr_override=scr)[4]
        self.state.carry = self.state.carry[:4] + (scr,)
