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
for the same inputs.

Bundle fetch (`prefetch`): the receiver starts the copy of its oldest
pending bundle to pinned host memory before it submits the next chunk,
so the copy is queued on the stream ahead of that chunk's program and
`collect` waits for the copy alone, not for the later chunks queued
behind it (tetra_tpu's copy_to_host_async, rx_multi.py:432-440).

Carrier-sharded meshes (`mesh=`, a torch DeviceMesh whose ranks are
processes, possibly sharing one card): each rank keeps the ring and the
carries of its own carriers only and runs the whole chunk program on
them (`_sharded_fused_chunk`: a local row budget G / shards, global
carrier ids in the rows, no collectives). `collect_local` parses this
rank's bundle segment; `collect` all-gathers every rank's segment and
parses them all, and when any shard overflowed its budget all ranks
re-run the chunk together.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from tetra_tpu_torch import constants as C
from tetra_tpu_torch.io import stream
from tetra_tpu_torch.parallel import collectives
from tetra_tpu_torch.parallel.mesh import mesh_size
from tetra_tpu_torch.lmac import fused, pipeline
from tetra_tpu_torch.ops import scramble
from tetra_tpu_torch.phy import dqpsk, pfb
from tetra_tpu_torch.phy.burst import split_norm_burst
from tetra_tpu_torch.phy.sync import FEED_BITS, RING_BITS
from tetra_tpu_torch.phy.sync_vec import sync_scan
from tetra_tpu_torch.rx import _PACK_BITS, _pack_selected
from tetra_tpu_torch.utils import trace

__all__ = ["FastChunkPipeline", "PipelineState", "carry_from_numpy",
           "fused_chunk", "fused_chunk_iq", "max_slots", "next_seq",
           "ROW_BYTES", "RING_PAD"]

ROW_BYTES = 40            # 36 packed section bytes + flags+delta+car16
_SEC_BYTES = 36           # ceil(282 / 8): worst-kind section total
SIDE_I32 = 8              # n_slots tail st bs nb nfs si scramb
RING_PAD = RING_BITS + 512   # device-resident tail: ring depth + slack
G_SLACK = 3               # per-carrier row-budget slack over chunk/510
SOFT_ONE = 31             # soft value of a full-confidence hard bit
_NEXT_SEQ = 0             # the id of the next dispatched chunk (per process)


def next_seq() -> int:
    """The sequence id the next dispatched chunk will get: ids are
    unique in the process, in dispatch order (the chunk id of the
    trace's spans)."""
    return _NEXT_SEQ


def max_slots(steps: int, feed: int) -> int:
    """Static bound on slots one carrier can emit in `steps` quanta."""
    return int(min(steps, (RING_BITS + steps * feed) // C.BITS_PER_TS + 1))


def _to_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding [0, 2^32) -> int32 with the same bits."""
    return (((x & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000).to(torch.int32)


def _fused_chunk_body(ring, chunk, end_rel: int, rebase: int, st0, bs0,
                      nb0, nfs0, fed_rel: int, scr0, steps: int, feed: int,
                      g_rows: int, car_offset: int = 0, soft: bool = False,
                      tol: int = 0):
    """One ingest chunk on the device.

    ring [B, RING_PAD] int8: last RING_PAD stream bits (carry).
    chunk [B, lc_pad] int8: this chunk's new bits.
    soft: ring and chunk hold int8 soft values instead of bits; tol:
    the sync scan's training-sequence bit-error tolerance.
    end_rel: window-relative stream end; rebase: window base delta
    since the carry was written; fed_rel: scan position in this window.
    st0, bs0, nb0, nfs0 [B] int32 sync carry; scr0 [B] int64 cell
    scrambling codes. g_rows: global row budget G. car_offset: the
    global id of carrier 0 when the body runs as one shard of a
    carrier-sharded mesh, so that rows carry global carrier ids.

    Returns (bundle [G*ROW_BYTES + B*32] int8, new_ring,
    (st, bs, nb, nfs, scr_final), t4_full [G, 432] int8, t4_b2 [G, 216]
    int8)."""
    dev = ring.device
    B = ring.shape[0]
    G = g_rows
    win = torch.cat([ring, chunk.to(torch.int8)], dim=1)
    bits = (win < 0).to(torch.int8) if soft else win
    L = win.shape[1]

    with trace.span("chunk.sync"):
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
    with trace.span("chunk.fec"):
        r1 = pipeline.decode_block(
            "SB1",
            flat[:, C.SB_BLK1_OFFSET: C.SB_BLK1_OFFSET + C.SB_BLK1_BITS],
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
        # per-carrier final code: the fill value at each carrier's last
        # row (carriers with no rows this chunk keep their carry)
        segend = gvalid & torch.cat([segcar[1:] != segcar[:-1],
                                     torch.ones(1, dtype=torch.bool,
                                                device=dev)])
        scr_ext = torch.cat([scr0, torch.zeros(1, dtype=scr0.dtype,
                                               device=dev)])
        scr_ext = scr_ext.scatter(0, torch.where(segend, gcar, B), inits)
        scr_final = scr_ext[:B]

        # ---- traffic payloads: type-4 bits of SCH/F (one 432-bit block)
        # and of an NDB's second half (its own fresh keystream), for the
        # dumps
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
    gcar_g = gcar + car_offset
    row = torch.cat([
        pay_b.to(torch.uint8),
        flags.to(torch.uint8)[:, None],
        delta.clamp(0, 255).to(torch.uint8)[:, None],
        (gcar_g & 255).to(torch.uint8)[:, None],
        (gcar_g >> 8).to(torch.uint8)[:, None]], dim=1)    # [G, 40]
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
                             steps, feed, g_rows, soft=soft, tol=tol)


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
    with trace.span("chunk.frontend"):
        bits_full = _iq_frontend(raw, channel_idx, fmt, n_chan, fs, sps,
                                 soft)
    chunk = bits_full[:, bits_full.shape[1] - keep:]
    if lc_pad != keep:
        chunk = F.pad(chunk, (0, lc_pad - keep))
    return _fused_chunk_body(ring, chunk, end_rel, rebase, st0, bs0, nb0,
                             nfs0, fed_rel, scr0, steps, feed, g_rows,
                             soft=soft, tol=tol)


def _sharded_fused_chunk(mesh, axis: str, steps: int, feed: int,
                         g_rows: int, lc_pad: int, soft: bool = False,
                         tol: int = 0):
    """The fused chunk as one shard of a carrier-sharded mesh: this
    rank runs the WHOLE chunk program (sync scan, slot compaction, SB1
    pre-decode, scrambling fill, FEC, packing) on its own carrier slice
    with a local row budget g_rows / shards, so the compaction never
    crosses ranks and the program has no collectives: carriers are
    independent receivers (the reference scales by one OS process chain
    per carrier, src/receiver1:8). Rows carry global carrier ids through
    car_offset, so the shards' bundle segments in rank order parse to
    the unsharded program's decisions. Returns fn(ring, packed, end_rel,
    rebase, st, bs, nb, nfs, fed_rel, scr) on this rank's carriers."""
    ns = mesh_size(mesh, axis)
    if g_rows % ns:
        raise ValueError(f"row budget {g_rows} does not split over {ns} "
                         "shards")
    gl = g_rows // ns
    shard = mesh.get_local_rank(axis)

    def body(ring, packed, end_rel, rebase, st, bs, nb, nfs, fed_rel, scr):
        B = ring.shape[0]
        return _fused_chunk_body(ring, _unpack(packed, lc_pad, soft),
                                 end_rel, rebase, st, bs, nb, nfs, fed_rel,
                                 scr, steps, feed, gl, car_offset=shard * B,
                                 soft=soft, tol=tol)
    return body


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
    and t4_b2 by the collected slot_refs are the rows those refs index.
    On a mesh the tensors are this rank's shard (its bundle segment)."""
    bundle: torch.Tensor       # device [G*ROW_BYTES + B*32] int8
    t4_full: torch.Tensor      # device [G, 432] int8
    t4_b2: torch.Tensor        # device [G, 216] int8
    g_rows: int
    inputs: tuple | None = None   # (dispatch fn(scr, g_rows), scr it ran with)
    maxs: int = 0                 # sufficient per-carrier budget
    # the early fetch (FastChunkPipeline.prefetch): (host copy of the
    # bundle, CUDA event recorded after the copy and the pinned buffer
    # it lies in, or None and None on the CPU)
    fetch: tuple | None = None
    seq: int = -1                 # the chunk's id (next_seq at dispatch)


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
    the sync scan accepts) defaults to 2 on a soft pipeline, 0 else.

    mesh: a torch.distributed DeviceMesh; the chunk program then runs
    carrier-sharded over its `mesh_axis` dimension
    (`_sharded_fused_chunk`): this rank keeps only its own carriers'
    ring and carry on `device`, `submit` takes the full host chunk (as
    tetra_tpu's replicated payload) and uploads this rank's rows, and
    n_carriers must divide evenly over the axis. `multiproc` is true
    when the axis spans more than one rank (every rank is a process);
    such a pipeline reads its results per rank with `collect_local`, or
    gathered with `collect`."""

    def __init__(self, n_carriers: int, device, soft: bool = False,
                 tol: int | None = None, mesh=None, mesh_axis: str = "car"):
        self.n = n_carriers
        self.device = torch.device(device)
        self.feed = FEED_BITS
        self.soft = soft
        self.tol = (2 if soft else 0) if tol is None else tol
        self.mesh = mesh
        self.mesh_axis = mesh_axis
        self.shards = mesh_size(mesh, mesh_axis) if mesh is not None else 1
        if n_carriers % self.shards:
            raise ValueError(f"{n_carriers} carriers do not split over "
                             f"{self.shards} shards")
        self.multiproc = self.shards > 1
        self.shard = mesh.get_local_rank(mesh_axis) if mesh is not None \
            else 0
        self.n_local = n_carriers // self.shards
        self.car0 = self.shard * self.n_local   # first carrier of this rank
        nl = self.n_local
        z = lambda v=0: torch.full((nl,), v, dtype=torch.int32,
                                   device=self.device)
        # positions are relative to carry_base; abs 0 == rel RING_PAD
        self.state = PipelineState(
            ring=torch.zeros((nl, RING_PAD), dtype=torch.int8,
                             device=self.device),
            carry=(z(), z(RING_PAD), z(), z(RING_PAD),
                   torch.zeros(nl, dtype=torch.int64, device=self.device)),
            carry_base=-RING_PAD, end=0, fed=0)
        self._outstanding: list[ChunkHandle] = []
        # the early fetch's pinned host buffers not in use, each sized to
        # the largest bundle seen when it was made
        self._pinned: list[torch.Tensor] = []
        self._pinned_numel = 0

    def _local_rows(self, bits):
        """This rank's carrier rows of a full-width chunk."""
        if self.mesh is None:
            return bits
        return bits[self.car0:self.car0 + self.n_local]

    def submit(self, bits) -> ChunkHandle | None:
        """Dispatch one chunk of per-carrier hard bits [B, Lc] (numpy,
        packed on the host, or a device tensor, packed on the device);
        on a mesh, B is every carrier and this rank takes its rows."""
        B, Lc = bits.shape
        if B != self.n:
            raise ValueError(f"expected {self.n} carriers, got {B}")
        bits = self._local_rows(bits)
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
        mesh, axis = self.mesh, self.mesh_axis

        def make_fn(ring0, rebase, end_rel, fed_rel, st, bs, nb, nfs):
            def dispatch(scr, g_rows):
                if mesh is not None:
                    fn = _sharded_fused_chunk(mesh, axis, steps, feed,
                                              g_rows, lc_pad, soft, tol)
                    return fn(ring0, packed, end_rel, rebase, st, bs, nb,
                              nfs, fed_rel, scr)
                return fused_chunk(ring0, packed, end_rel, rebase, st, bs,
                                   nb, nfs, fed_rel, scr, steps, feed,
                                   g_rows, lc_pad, soft, tol)
            return dispatch
        return self._submit_common(Lc, steps, make_fn)

    def submit_iq(self, raw, fmt: str, keep: int, channel_idx,
                  n_chan: int, fs: float, sps: int = 2) -> ChunkHandle | None:
        """Dispatch one WIDEBAND chunk: raw quantized RF samples (with the
        caller's overlap-save history) -> the fused chunk program. keep:
        how many trailing demod bits are NEW stream bits.

        Not on a multi-rank mesh: the fused front end runs unsharded, and
        tetra_tpu's submit_iq on a multi-process mesh parses garbage
        (its collect_local reads an unsharded bundle as shard segments);
        such a receiver takes process_bits or the mixer bank."""
        if self.multiproc:
            raise NotImplementedError(
                "submit_iq on a multi-rank mesh: the PFB front end fused "
                "into the chunk program is not carrier-sharded (tetra_tpu "
                "fails here too); feed demodulated bits through submit")
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
        global _NEXT_SEQ
        h = ChunkHandle(bundle, t4f, t4b, G, (dispatch, scr), maxs,
                        seq=_NEXT_SEQ)
        _NEXT_SEQ += 1
        self._outstanding.append(h)
        return h

    def prefetch(self, h: ChunkHandle) -> None:
        """Start the copy of h's bundle to the host, once: a non-blocking
        copy on the current stream into a pinned buffer, then an event.
        Work queued after this call does not delay `collect`'s wait. On
        the CPU the bundle is its own host copy."""
        if h.fetch is not None:
            return
        if self.device.type != "cuda":
            h.fetch = (h.bundle, None, None)
            return
        n = h.bundle.numel()
        if n > self._pinned_numel:
            self._pinned_numel = n
            self._pinned = []           # free buffers too small from now
        if self._pinned:
            buf = self._pinned.pop()
        else:
            buf = torch.empty(self._pinned_numel, dtype=torch.int8,
                              pin_memory=True)
        buf[:n].copy_(h.bundle, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record()
        h.fetch = (buf[:n], ready, buf)

    def _fetched(self, h: ChunkHandle) -> np.ndarray:
        """h's bundle on the host: the early fetch's buffer once its copy
        has landed (the pinned buffer then returns to the free list,
        unless a larger bundle has been seen since), else a blocking
        copy."""
        with trace.span("chunk.fetch_wait", h.seq):
            if h.fetch is None:
                return h.bundle.cpu().numpy()
            host, ready, buf = h.fetch
            h.fetch = None
            if ready is None:
                return host.numpy()
            ready.synchronize()
            out = host.numpy().copy()
        if buf.numel() >= self._pinned_numel:
            self._pinned.append(buf)
        return out

    def collect(self, h: ChunkHandle) -> dict:
        """Fetch one chunk's bundle and decode it to numpy arrays:
        {carrier, kind, okA, okB, delta, payload [n, 408], slot_ref,
         n_slots [B], tail [B], scramb [B], side_carrier}. A row-budget
        overflow re-runs the chunk with the sufficient budget first.

        On a mesh every rank gathers every rank's bundle segment (equal
        sizes) and parses them all, so every rank returns the whole
        chunk's dict; slot_refs index the shards' stacked t4 rows. An
        overflow in any shard is seen by every rank, and all re-run."""
        seg = self._fetched(h)
        if self.multiproc:
            group = self.mesh.get_group(self.mesh_axis)
            segs = np.stack(collectives.all_gather_host(seg, group))
        else:
            segs = seg[None]
        with trace.span("chunk.parse", h.seq):
            d = self._decode_segments(h.g_rows, segs, np.arange(self.shards))
        if d is None:
            if h.inputs is None or h.g_rows >= self.n * h.maxs:
                raise RuntimeError("slot compaction overflow (bound bug)")
            self._overflow_rerun(h)
            return self.collect(h)
        if h in self._outstanding:
            self._outstanding.remove(h)
        return d

    def collect_local(self, h: ChunkHandle) -> dict:
        """Multi-rank variant of collect: decode ONLY this rank's bundle
        segment. The carrier axis is embarrassingly parallel (the
        reference scales by one OS process per carrier,
        src/receiver1:8), so each rank walks its own carriers and never
        fetches another's. "side_carrier" maps the returned n_slots,
        tail and scramb entries to global carrier ids."""
        seg = self._fetched(h)
        with trace.span("chunk.parse", h.seq):
            d = self._decode_segments(h.g_rows, seg[None],
                                      np.asarray([self.shard], np.int32))
        if d is None:
            # a re-run would have to be agreed on by every rank; size
            # G_SLACK for the workload instead (as tetra_tpu)
            raise RuntimeError("row-budget overflow on a multi-process "
                               "mesh; raise the budget slack")
        if h in self._outstanding:
            self._outstanding.remove(h)
        return d

    def _decode_segments(self, G: int, segs: np.ndarray, ids) -> dict | None:
        """Parse bundle segments segs [k, G/ns*ROW_BYTES + B/ns*32] of
        the shards `ids` into the collect dict; None signals a row-budget
        overflow in any of them."""
        ns = self.shards
        gl = G // ns
        Bl = self.n // ns
        k = len(ids)
        rows = np.ascontiguousarray(segs[:, :gl * ROW_BYTES]) \
            .view(np.uint8).reshape(k, gl, ROW_BYTES)
        side = np.ascontiguousarray(segs[:, gl * ROW_BYTES:]) \
            .view(np.int32).reshape(k, Bl, SIDE_I32)
        tot_s = side[..., 0].sum(axis=1)                # rows per shard
        if (tot_s > gl).any():
            return None
        side_carrier = (ids[:, None] * Bl
                        + np.arange(Bl, dtype=np.int32)).reshape(-1)
        sel = np.concatenate([rows[i, :tot_s[i]] for i in range(k)])
        slot_ref = np.concatenate(
            [ids[i] * gl + np.arange(tot_s[i], dtype=np.int32)
             for i in range(k)]).astype(np.int32)
        total = len(sel)
        side = side.reshape(-1, SIDE_I32).copy()
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
            "slot_ref": slot_ref,
            "n_slots": side[:, 0], "tail": side[:, 1],
            "scramb": side[:, 7].view(np.uint32),
            "side_carrier": side_carrier,
        }

    def _dispatch(self, h: ChunkHandle, g_rows: int, scr_override=None):
        """(Re-)run a chunk from its saved closure with row budget
        g_rows, updating the handle in place; returns the carry. An early
        fetch of the old bundle is dropped: it is stale."""
        fn, scr = h.inputs
        if scr_override is not None:
            scr = scr_override
            h.inputs = (fn, scr)
        bundle, _, carry, t4f, t4b = fn(scr, g_rows)
        h.bundle, h.t4_full, h.t4_b2, h.g_rows = bundle, t4f, t4b, g_rows
        h.fetch = None
        return carry

    def _overflow_rerun(self, h: ChunkHandle) -> None:
        """Re-run an overflowed chunk with the sufficient budget, then
        carry the corrected scrambling codes through every chunk
        dispatched after it and into the pipeline head."""
        trace.count("chunk.reruns")
        with trace.span("chunk.rerun", h.seq):
            scr = self._dispatch(h, self.n * h.maxs)[4]
            later = self._outstanding[self._outstanding.index(h) + 1:]
            for h2 in later:
                if torch.equal(h2.inputs[1], scr):
                    return      # the stale carry was already correct
                scr = self._dispatch(h2, h2.g_rows, scr_override=scr)[4]
            self.state.carry = self.state.carry[:4] + (scr,)
