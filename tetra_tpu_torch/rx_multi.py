"""Multi-carrier receiver: wideband IQ -> N decoded carrier streams
(port of tetra_tpu.rx_multi).

Wideband samples in one of four ingest formats (`process_iq4c`, the
production companded 4+4-bit IQ; `process_iq8`, interleaved int8;
`process_iq4`, uniform 4+4-bit; `process_iq`, complex samples) or
per-carrier hard bits (`process_bits`) in, per-carrier decode stats out.
Two front ends run on the device, each with overlap-save streaming
across chunks, then the hard demod at os=4:

* the polyphase filterbank (`pfb_channels`: carriers on the 25 kHz grid
  of n_chan channels): dequantize, PFB channelizer K2, resampler K3;
* the mixer bank (the default: one carrier per entry of `offsets_hz`,
  anywhere in the span): dequantize, then phy.channelizer.channelize_ri
  (oscillator mix at absolute sample indices, 127-tap FIR, polyphase
  resampler), plain PyTorch. Its streaming consumes BLOCK-aligned
  quanta of whole fs/36k resampler periods, so a chunked stream gives
  the bits of a whole-capture run; a rate whose fs/36k is not rational
  with a small denominator is demodulated per call, statelessly.

Two control planes, as in the JAX package:

* "python" (the default): all carriers synchronise in one device scan
  (phy.sync_vec.MultiSync) and FEC-decode in one device program
  (rx.decode_slots_multi: K1 at 80 and at 288 steps on a card); then
  each carrier's TetraReceiver walks its upper MAC / LLC / MLE / crypto
  per slot on the host, with the reference's log lines (`log`: one
  callable for all carriers, or one per carrier), per-carrier
  decryption, GSMTAP per carrier and the L3 parse. With tracing on,
  each stage is a span "pyplane.*" (utils.trace.timings()).
* "native": each chunk runs as one fused chunk program on the device
  (fastpath.submit_iq) and one C++ walk of the upper MAC / LLC / MLE /
  crypto (umac.native_exec), with structured events instead of log
  lines. Chunks are pipelined: up to `pipeline_depth` dispatched chunks
  wait before the oldest is fetched and walked; a final=True call
  drains the queue.

With tracing on (utils.trace), the receiver's construction is a span
"rx.build", each public process_* call a span "call", and on the native
plane each chunk's "chunk.submit" (with the front end, sync and FEC
enqueues inside it), "chunk.fetch_wait", "chunk.parse", "chunk.walk" and
"chunk.egress" carry the chunk's id (fastpath.next_seq). On both planes
the counter "slots.crc_wrong" adds each block the walk found failing its
CRC, as RxStats.crc_wrong counts it (a traffic slot carries no CRC).

`carriers` holds one TetraReceiver per carrier on both planes (the
native plane writes its stats, TDMA time and cell identity there).

Egress on both planes: every TL-SDU to `tl_sdu_sink(carrier, pdisc,
pdut, sdu_bits)` (on the Python plane chained after the MLE parse),
defrag-reassembled SNDCP IP packets to tun0, GSMTAP packets of every
CRC-OK block (`gsmtap_host`), and with `dumpdir` the traffic dumps of
each carrier under `dumpdir/carrier<i>` (with `decode_voice`, the TCH/S
voice frames too, decoded on the card by kernel K6).

demod="soft" is the degraded-signal mode of the native plane: int8 soft
demod, a sync scan that accepts 2 training-sequence bit errors, and the
soft Viterbi (kernel K4) over the same kind-compacted FEC. The mixer
bank demodulates hard, as in tetra_tpu, and its bits enter the soft
pipeline as full-confidence values: the combination warns.

Before each native-plane submit the oldest pending chunk's bundle starts
its copy to the host (`_prefetch_pending`), ahead of the new chunk's
program on the stream, as tetra_tpu's copy_to_host_async does.

mesh (native plane): a torch.distributed DeviceMesh with a "car"
dimension; the fused chunk program runs carrier-sharded over its ranks
(fastpath.FastChunkPipeline). On a mesh of several ranks, each rank
fetches and walks only its own carriers (collect_local) and traffic
dumps and voice are skipped, as in tetra_tpu; bits enter through
process_bits or the mixer bank (every rank demodulates every carrier and
uploads its own rows), while the PFB wideband entries raise, since
tetra_tpu's fused PFB chunk is not carrier-sharded and parses garbage on
a multi-process mesh.
"""
from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from tetra_tpu_torch.device import resolve_device
from tetra_tpu_torch import fastpath
from tetra_tpu_torch.fastpath import FastChunkPipeline, _iq_frontend, \
    _iq_to_ri
from tetra_tpu_torch.phy import channelizer, dqpsk
from tetra_tpu_torch.phy.sync_vec import MultiSync
from tetra_tpu_torch.rx import RxStats, TetraReceiver, append_files, \
    decode_slots_multi, dump_blocks, voice_frames
from tetra_tpu_torch.tdma import TdmaTime
from tetra_tpu_torch.umac.native_exec import EV, NativeControlPlane
from tetra_tpu_torch.utils import trace
from tetra_tpu_torch.utils.bits import bits_to_uint, pack_bits

__all__ = ["MultiCarrierReceiver", "pfb_demod_bits_len",
           "mixer_demod_bits_len", "mixer_block"]


def pfb_demod_bits_len(n_samples: int, n_chan: int, fs: float,
                       sps: int, taps_per_branch: int = 16) -> int:
    """Demod output bit count for an n_samples wideband feed through the
    PFB front end (closed form of tetra_tpu.rx_multi._pfb_demod_bits_len):
    M channel frames, n_out resampled samples, 2 bits per symbol."""
    hop = n_chan // 2
    M = max((n_samples - n_chan * taps_per_branch) // hop + 1, 1)
    skew = -(n_chan * taps_per_branch - 1) / (2.0 * hop)
    ratio = (2.0 * fs / n_chan) / 36_000.0
    n_out = max(int((M - 8 - max(skew, 0.0)) / ratio), 0)
    return 2 * (n_out // sps)


def mixer_demod_bits_len(n_samples: int, fs: float, sps: int) -> int:
    """Demod output bit count for an n_samples wideband feed through the
    mixer-bank front end (closed form of
    tetra_tpu.rx_multi._mixer_demod_bits_len): the FIR keeps the length,
    the resampler gives n_out samples (the n_out of both its plans, 8
    taps per phase, no skew), 2 bits per symbol."""
    n_out = max(int((n_samples - 8) / (fs / channelizer.DEMOD_RATE)), 0)
    return 2 * (n_out // sps)


def mixer_block(fs: float):
    """(BLOCK, L, M) of the mixer bank's overlap-save streaming at fs,
    or None when fs/36k is not L/M with a small denominator: BLOCK is
    whole resampler periods of L samples, at least 2048, with an even
    number of demod bits (BLOCK/L * M); each continuation re-feeds
    2 * BLOCK samples."""
    lm = channelizer._rational_ratio(fs, channelizer.DEMOD_RATE)
    if lm is None:
        return None
    L_, M_ = lm
    BLOCK = L_ * max(1, -(-2048 // L_))
    if ((BLOCK // L_) * M_) % 2:
        BLOCK *= 2
    return BLOCK, L_, M_


class MultiCarrierReceiver:
    @trace.spanned("rx.build")
    def __init__(self, offsets_hz, fs: float, sps: int = 2,
                 keystore_path: str | None = None,
                 dumpdir: str | None = None, log=None,
                 pfb_channels=None, n_chan: int | None = None,
                 control_plane: str = "python",
                 gsmtap_host: str | None = None,
                 decode_voice: bool = False,
                 tl_sdu_sink=None, mesh=None, demod: str = "hard",
                 device=None):
        if control_plane not in ("python", "native"):
            raise ValueError(f"control_plane must be 'python' or 'native', "
                             f"got {control_plane!r}")
        if demod not in ("hard", "soft"):
            raise ValueError(f"demod must be 'hard' or 'soft', got {demod!r}")
        if demod != "hard" and control_plane != "native":
            raise ValueError("soft demod rides the fastpath (native "
                             "control plane)")
        if demod == "soft" and pfb_channels is None:
            warnings.warn("demod='soft' on the mixer bank: its front end "
                          "demodulates hard (as tetra_tpu does), so these "
                          "carriers reach the soft Viterbi as "
                          "full-confidence hard bits", RuntimeWarning,
                          stacklevel=2)
        self.device = resolve_device(device)
        self.offsets = np.asarray(offsets_hz, dtype=np.float32)
        self.fs = float(fs)
        self.sps = sps
        self.pfb_channels = (np.asarray(pfb_channels, np.int32)
                             if pfb_channels is not None else None)
        self.n_chan = (n_chan if n_chan is not None
                       else int(round(fs / 25_000.0)))
        n_carriers = (len(self.pfb_channels) if self.pfb_channels is not None
                      else len(self.offsets))
        self.carriers = []
        for i in range(n_carriers):
            # `log` may be one callable shared by all carriers or a
            # per-carrier sequence of callables
            if log is None:
                carrier_log = lambda *a, **k: None
            elif isinstance(log, (list, tuple)):
                carrier_log = log[i]
            else:
                carrier_log = log
            self.carriers.append(TetraReceiver(
                keystore_path=keystore_path,
                dumpdir=f"{dumpdir}/carrier{i}" if dumpdir else None,
                # the native plane exports GSMTAP from ONE shared sink fed
                # by the executor's events, not per-carrier sockets
                gsmtap_host=(gsmtap_host if control_plane == "python"
                             else None),
                decode_voice=decode_voice, log=carrier_log,
                device=self.device))
        self.control_plane = control_plane
        self.decode_voice = decode_voice
        # generic TL-SDU egress: fn(carrier, pdisc, pdut, sdu_ubits) for
        # every TL-SDU, from either plane
        self.tl_sdu_sink = tl_sdu_sink
        if tl_sdu_sink is not None and control_plane == "python":
            for ci, rx in enumerate(self.carriers):
                # the sink is additive: TetraReceiver wired tl_sdu_cb to
                # mle.rx_tl_sdu (MLE/CMCE/SNDCP parse + the reference's
                # log lines); chain it so the L3 parse stays
                def cb(bits, n, _c=ci, _prev=rx.llc.tl_sdu_cb):
                    if _prev is not None:
                        _prev(bits, n)
                    b = np.asarray(bits)[:n]
                    pdisc = int(bits_to_uint(b[:3]))
                    w = {1: 4, 2: 5, 4: 4, 5: 3}.get(pdisc)
                    pdut = (-1 if w is None
                            else int(bits_to_uint(b[3:3 + w])))
                    self.tl_sdu_sink(_c, pdisc, pdut, b)
                rx.llc.tl_sdu_cb = cb
        self.native_cp = None
        self.gsmtap = None
        self.native_events = []   # accumulated event dicts (native plane)
        if control_plane == "native":
            self.native_cp = NativeControlPlane(n_carriers)
            if keystore_path:
                from tetra_tpu_torch.crypto.crypto import load_keystore
                self.native_cp.set_keys(load_keystore(keystore_path))
            if gsmtap_host:
                from tetra_tpu_torch.io.gsmtap import GsmtapSink
                self.gsmtap = GsmtapSink(gsmtap_host)
                self.native_cp.set_gsmtap(True)
            self._fast = FastChunkPipeline(n_carriers, self.device,
                                           soft=demod == "soft", mesh=mesh)
            self._pending = []
            # chunks kept in flight while streaming (final=False)
            self.pipeline_depth = 2
        else:
            self.sync = MultiSync(n_carriers, device=self.device)
            self._buf = np.zeros((n_carriers, 0), dtype=np.uint8)
            self._buf_base = 0
        if self.pfb_channels is not None:
            chans = torch.as_tensor(self.pfb_channels, dtype=torch.int64)
            self._chan_idx = (None if np.array_equal(
                self.pfb_channels, np.arange(self.n_chan))
                else chans.to(self.device))
        self._wb_rem = None
        self._wb_hist = None
        self._wb_g = None
        self._mx_rem = None
        self._mx_hist = None
        self._mx_pos = 0      # absolute sample index of the consumed head
        self._mx_g = None

    @trace.spanned("call")
    def process_iq(self, wideband_iq, final: bool = True) -> list[RxStats]:
        """One chunk of wideband complex samples through the chain (sent
        to the device as interleaved float32 I/Q)."""
        iq = np.ascontiguousarray(np.asarray(wideband_iq, np.complex64))
        return self._wideband_stream(iq.view(np.float32), 2, "f32i", final)

    @trace.spanned("call")
    def process_iq8(self, iq8, final: bool = True) -> list[RxStats]:
        """One chunk of interleaved int8 wideband IQ ([I0, Q0, I1, Q1,
        ...], two bytes per complex sample) through the chain."""
        return self._wideband_stream(np.asarray(iq8, np.int8), 2, "iq8",
                                     final)

    @trace.spanned("call")
    def process_iq4c(self, packed_u8, final: bool = True) -> list[RxStats]:
        """One chunk of companded 4+4-bit wideband IQ (one byte per
        complex sample, io.stream.quantize_iq4c) through the chain."""
        return self._wideband_stream(np.asarray(packed_u8, np.uint8), 1,
                                     "iq4c", final)

    @trace.spanned("call")
    def process_iq4(self, packed_u8, final: bool = True) -> list[RxStats]:
        """One chunk of uniform 4+4-bit wideband IQ (one byte per complex
        sample, io.stream.quantize_iq4) through the chain. Its 15 linear
        levels suit up to ~128 active channels; a fully loaded span
        should use process_iq4c (same byte rate) or process_iq8."""
        return self._wideband_stream(np.asarray(packed_u8, np.uint8), 1,
                                     "iq4", final)

    def _wideband_stream(self, raw, k: int, fmt: str, final: bool):
        """Overlap-save streaming for the PFB front end: each
        continuation re-feeds the last W raw samples, and chunks are
        consumed in BLOCK-aligned quanta (BLOCK = 25*n_chan samples =
        exactly 36 demod bits per carrier), so the per-call output's
        valid region equals the continuous stream's bits. raw: 1-D,
        k elements per complex sample.

        The native plane dispatches the whole chunk (front end, sync,
        FEC, packing) as one device program; the Python plane runs the
        front end on the device and walks the kept bits through
        process_bits. Mixer-bank receivers take _mixer_stream."""
        if self.pfb_channels is None:
            return self._mixer_stream(raw, k, fmt, final)
        if self.control_plane == "native":
            h = None
            with trace.span("chunk.submit", fastpath.next_seq()) as sp:
                take = self._wb_take(raw, k, final)
                if take is not None:
                    self._prefetch_pending()
                    h = self._fast.submit_iq(take[0], fmt, take[1],
                                             self._chan_idx, self.n_chan,
                                             self.fs, sps=self.sps)
                if h is None and sp is not None:
                    sp.chunk = None     # nothing dispatched
            if take is None:
                return self._no_chunk(final)
            return self._native_drain(h, final)
        take = self._wb_take(raw, k, final)
        if take is None:
            return self._no_chunk(final)
        feed, keep = take
        with trace.span("pyplane.frontend"):
            raw_d = torch.as_tensor(np.asarray(feed)).to(self.device)
            bits = _iq_frontend(raw_d, self._chan_idx, fmt, self.n_chan,
                                self.fs, self.sps)
            bits = bits[:, bits.shape[1] - keep:].cpu().numpy() \
                .astype(np.uint8)
        return self._process_bits(bits, final=final)

    def _wb_take(self, raw, k: int, final: bool):
        """The PFB stream's bookkeeping for one call: (feed with its
        overlap-save history, new demod bits to keep), or None when the
        call completes no BLOCK (the samples wait for the next)."""
        n = self.n_chan
        BLOCK = 25 * n
        W = 2 * BLOCK
        if self._wb_rem is None:
            self._wb_rem = raw[:0]
        data = np.concatenate([self._wb_rem, raw])
        total = len(data) // k
        usable = (total // BLOCK) * BLOCK
        if final:
            usable = total
        if usable == 0 or (self._wb_hist is None and usable < W
                           and not final):
            self._wb_rem = data
            if final:
                self._reset_wb_stream()
            return None
        self._wb_rem = data[usable * k:]
        chunk = data[: usable * k]
        first = self._wb_hist is None
        feed = chunk if first else np.concatenate([self._wb_hist, chunk])
        nbits = pfb_demod_bits_len(len(feed) // k, n, self.fs, self.sps)
        keep = nbits if first else max(nbits - self._wb_g, 0)
        if first and usable % BLOCK == 0:
            # bits(L) is affine on BLOCK-aligned lengths with slope
            # 36/BLOCK: the first call yields the per-carrier bit count
            # every continuation must drop
            self._wb_g = nbits - 36 * (usable // BLOCK - 2)
        hist_src = chunk if len(chunk) >= W * k else feed
        self._wb_hist = hist_src[-W * k:]
        if final:
            self._reset_wb_stream()
        return feed, keep

    def _no_chunk(self, final: bool):
        """A call that completed no chunk: drain on final, else the
        stats as they stand. (A native-plane submit of no bits would
        dispatch nothing.)"""
        if not final:
            return [c.stats for c in self.carriers]
        if self.control_plane == "native":
            return self._native_drain(None, True)
        return self._process_bits(
            np.zeros((len(self.carriers), 0), np.uint8), final=True)

    def _reset_wb_stream(self):
        self._wb_hist = None
        self._wb_rem = self._wb_rem[:0]
        self._wb_g = None

    def _mixer_stream(self, raw, k: int, fmt: str, final: bool):
        """Overlap-save streaming for the mixer bank (carriers at any
        offset; reference xlating FIR front end,
        src/demod/osmosdr-tetra_demod_fft.py:74-80), as the PFB branch:
        continuations re-feed the last W raw samples and drop the
        re-derived bits; chunks are consumed in BLOCK-aligned quanta
        (whole fs/36k resampler periods, sized to dominate the 127-tap
        FIR + resampler + RRC memories, with an even number of demod
        bits per block), and the oscillator runs at absolute sample
        indices, so a chunked stream's bits equal a whole-capture run's.
        A rate whose fs/36k is not rational with a small denominator is
        demodulated per call, statelessly."""
        blk = mixer_block(self.fs)
        if blk is None and len(raw) == 0:
            return self._process_bits(
                np.zeros((len(self.carriers), 0), np.uint8), final=final)
        if self.control_plane == "python":
            take = self._mx_take(raw, k, fmt, final, blk)
            if take is None:
                return self._no_chunk(final)
            return self._process_bits(self._mixer_bits(*take), final=final)
        h = None
        with trace.span("chunk.submit", fastpath.next_seq()) as sp:
            take = self._mx_take(raw, k, fmt, final, blk)
            if take is not None:
                h = self._submit(self._mixer_bits(*take))
            if h is None and sp is not None:
                sp.chunk = None         # nothing dispatched
        if take is None:
            return self._no_chunk(final)
        return self._native_drain(h, final)

    def _mx_take(self, raw, k: int, fmt: str, final: bool, blk):
        """The mixer stream's bookkeeping for one call: the arguments of
        _mixer_bits (feed with its history, format, absolute index of its
        first sample, new bits to keep), or None when the call completes
        no BLOCK. blk: mixer_block(fs); None demodulates the call
        alone."""
        if blk is None:
            return raw, fmt, 0, None
        BLOCK, L_, M_ = blk
        W = 2 * BLOCK
        if self._mx_rem is None:
            self._mx_rem = raw[:0]
        data = np.concatenate([self._mx_rem, raw])
        total = len(data) // k
        usable = (total // BLOCK) * BLOCK
        if final:
            usable = total
        if usable == 0 or (self._mx_hist is None and usable < W
                           and not final):
            self._mx_rem = data
            if final:
                self._reset_mx_stream()
            return None
        self._mx_rem = data[usable * k:]
        chunk = data[: usable * k]
        first = self._mx_hist is None
        feed = chunk if first else np.concatenate([self._mx_hist, chunk])
        base = self._mx_pos - (0 if first else W)
        nbits = mixer_demod_bits_len(len(feed) // k, self.fs, self.sps)
        keep = nbits if first else max(nbits - self._mx_g, 0)
        if first and usable % BLOCK == 0:
            # bits(L) is affine on BLOCK-aligned lengths with slope
            # bpb/BLOCK: the first call yields the per-carrier bit count
            # every continuation must drop
            bpb = (BLOCK // L_) * M_
            self._mx_g = nbits - bpb * (usable // BLOCK - 2)
        hist_src = chunk if len(chunk) >= W * k else feed
        self._mx_hist = hist_src[-W * k:]
        self._mx_pos += usable
        if final:
            self._reset_mx_stream()
        return feed, fmt, base, keep

    def _reset_mx_stream(self):
        self._mx_hist = None
        self._mx_rem = self._mx_rem[:0]
        self._mx_pos = 0
        self._mx_g = None

    def _mixer_bits(self, feed, fmt: str, base: int, keep: int | None):
        """Mixer-bank front end on the device: raw samples in format
        `fmt` (oscillator at absolute index base) -> channelize_ri ->
        hard demod at os=4 -> the trailing `keep` bits (all when None)
        [C, keep]; a device tensor on the native plane, host numpy on
        the Python plane."""
        python = self.control_plane == "python"
        with trace.span("pyplane.frontend" if python else "chunk.frontend"):
            re, im = _iq_to_ri(fmt, torch.as_tensor(np.asarray(feed))
                               .to(self.device))
            cr, ci = channelizer.channelize_ri(re, im, self.offsets,
                                               self.fs, base=base)
            bits = dqpsk.demodulate_hard_ri(cr, ci, sps=self.sps, os=4)
            if keep is not None:
                bits = bits[:, bits.shape[1] - keep:]
            if python:
                bits = bits.cpu().numpy().astype(np.uint8)
        return bits

    @trace.spanned("call")
    def process_bits(self, bits, final: bool = True) -> list[RxStats]:
        """Per-carrier hard bits [C, T] -> per-carrier decode stats.

        Native plane: final=False keeps chunks in flight (their fetch
        and walk happen during later calls); stats are complete once a
        final=True call drains the pipeline. Python plane: the walk runs
        in this call; only whole 64-bit feed quanta are consumed and
        the rest waits for the next call, whatever `final` says (as in
        the JAX package)."""
        if not isinstance(bits, torch.Tensor):
            bits = np.asarray(bits)
        if bits.ndim != 2 or bits.shape[0] != len(self.carriers):
            raise ValueError("bits must be [n_carriers, T]")
        return self._process_bits(bits, final)

    def _process_bits(self, bits, final: bool) -> list[RxStats]:
        """process_bits inside a call that is already traced."""
        if self.control_plane == "native":
            with trace.span("chunk.submit", fastpath.next_seq()) as sp:
                h = self._submit(bits)
                if h is None and sp is not None:
                    sp.chunk = None     # nothing dispatched
            return self._native_drain(h, final)
        if isinstance(bits, torch.Tensor):
            bits = bits.cpu().numpy()
        return self._process_bits_python(np.asarray(bits, np.uint8))

    def _submit(self, bits):
        """Native plane: start the oldest pending bundle's copy, then
        dispatch one chunk of per-carrier bits; its handle, or None."""
        self._prefetch_pending()
        return self._fast.submit(bits)

    def _process_bits_python(self, bits) -> list[RxStats]:
        """Python control plane: all carriers synchronise in one device
        scan and FEC-decode in one device program; the byte-scale
        upper-MAC walk runs per carrier on the host."""
        self._buf = np.concatenate([self._buf, bits & 1], axis=1)
        with trace.span("pyplane.sync"):
            slots, events = self.sync.scan(self._buf,
                                           base_offset=self._buf_base)
        # rebase the absolute offsets to the buffer for slicing/decoding
        base = self._buf_base
        for sl, ev in zip(slots, events):
            for s in sl:
                s.offset -= base
            for e in ev:
                e.offset -= base
        with trace.span("pyplane.decode"):
            decoded = decode_slots_multi(
                list(self._buf), slots,
                [rx.scramb_init for rx in self.carriers], device=self.device)
        with trace.span("pyplane.walk"):
            for c, rx in enumerate(self.carriers):
                rx._ev_ptr = 0
                for s, d in zip(slots[c], decoded[c]):
                    rx._flush_events(events[c], s.seq)
                    rx._walk_slot(d)
                rx._flush_events(events[c], 1 << 62)

        keep = max(self._buf_base, self.sync.min_buf_start())
        if keep > self._buf_base:
            self._buf = self._buf[:, keep - self._buf_base:]
            self._buf_base = keep
        return [rx.stats for rx in self.carriers]

    def _prefetch_pending(self):
        """Start the oldest pending bundle's copy to the host before the
        next chunk is submitted (tetra_tpu rx_multi.py:432-440)."""
        if self._pending:
            self._fast.prefetch(self._pending[0])

    def _native_drain(self, h, final: bool) -> list[RxStats]:
        """Queue one dispatched chunk and drain the pipeline to its
        depth (or fully, when final)."""
        if h is not None:
            self._pending.append(h)
        while self._pending and (final
                                 or len(self._pending) > self.pipeline_depth):
            self._collect_walk(self._pending.pop(0))
        return [c.stats for c in self.carriers]

    # walk2 packed-row geometry (rx._PACK_* layout; see
    # native/umac_exec.cpp ROW_STRIDE constants)
    _GT_LEN_A = {0: 60, 1: 268, 2: 124}
    _GT_LEN_B = {0: 124, 1: 0, 2: 124}

    def _export_gsmtap(self, evd, d):
        """EV.GSMTAP events (one per CRC-OK TMV dispatch of the C++ walk;
        reference hook tetra_upper_mac.c:483-488) -> UDP packets: the
        dispatched block's bits from the payload row, its lchan, TDMA
        time and timeslot."""
        for i in np.flatnonzero(evd["kind"] == EV.GSMTAP):
            row = int(evd["a"][i])
            lchan = int(evd["b"][i])
            c = int(evd["c"][i])
            off = int(evd["d"][i])
            blk = (c >> 20) & 0xF
            t = TdmaTime(tn=(c >> 16) & 0xF, fn=(c >> 8) & 0xFF,
                         mn=c & 0xFF)
            kind = int(d["kind"][row])
            # AACH rides the BBK bits; blk_num 2 is the second half-slot
            # block; everything else (SB1, SCH/F, NDB1) is block A
            if lchan == 8:
                sec = d["payload"][row][392:406]
            elif blk == 2:
                sec = d["payload"][row][268: 268 + self._GT_LEN_B[kind]]
            else:
                sec = d["payload"][row][: self._GT_LEN_A[kind]]
            self.gsmtap.send(t, lchan, t.tn - 1, sec[off:])

    def _payload_egress(self, evd, arena):
        """TL-SDUs from the walk's payload arena: defrag-reassembled
        SNDCP IP payloads to tun0 (reference tetra_llc.c:93-101), every
        TL-SDU to the sink when one is registered."""
        dd = evd["d"]
        tl = (evd["kind"] == EV.TLSDU) & (dd >= 0)
        if self.tl_sdu_sink is None:
            tl &= (dd & 1) == 1
        for i in np.flatnonzero(tl):
            ref = int(dd[i])
            nbits = int(evd["c"][i])
            car = int(evd["carrier"][i])
            sdu = arena[ref >> 1: (ref >> 1) + nbits]
            if (ref & 1) and nbits > 19:
                payload = sdu[19:]      # strip the SNDCP header bits
                self.carriers[car]._ip_out(
                    pack_bits(payload[: (len(payload) // 8) * 8]))
            if self.tl_sdu_sink is not None:
                self.tl_sdu_sink(car, int(evd["a"][i]), int(evd["b"][i]),
                                 sdu)

    def _dump_traffic(self, h, evd, tr, arena):
        """The chunk's EV.TRAFFIC slots (a = slot_ref, b = 1 for an NDB
        second half, c = usage, d = (voice keystream arena ref + 1) << 8
        | tn): one device gather and one voice decode per row length
        from the chunk's traffic payloads, then the appends in event
        order."""
        n = len(tr)
        half = evd["b"][tr] == 1
        blocks = np.empty((n, 690), np.int16)
        cod = np.empty((n, 35), np.uint8)
        ks = np.zeros((n, 274), np.uint8)
        vref = evd["d"][tr] >> 8
        if self.decode_voice and (vref > 0).any():
            ks[vref > 0] = arena[(vref[vref > 0] - 1)[:, None]
                                 + np.arange(274)]
        for src, pos in ((h.t4_full, np.flatnonzero(~half)),
                         (h.t4_b2, np.flatnonzero(half))):
            if not len(pos):
                continue
            rows = src[torch.as_tensor(evd["a"][tr[pos]], device=self.device)]
            blocks[pos] = dump_blocks(rows.cpu().numpy())
            if self.decode_voice:
                cod[pos] = voice_frames(rows, ks[pos])
        parts = {}
        for j, i in enumerate(tr):
            d = self.carriers[evd["carrier"][i]].dumpdir
            ut = f"{evd['c'][i]}_{(evd['d'][i] & 0xFF) - 1}"
            add = [(f"traffic_{ut}.out", blocks[j].tobytes()),
                   (f"traffic_{ut}.txt", b"0\n")]   # native plane: SSI 0
            if self.decode_voice:
                add.append((f"voice_{ut}.cod", cod[j].tobytes()))
            for name, data in add:
                parts.setdefault(os.path.join(d, name), []).append(data)
        append_files(parts)

    def _collect_walk(self, h):
        """Fetch one chunk and run the native control plane: numpy record
        assembly + ONE C++ walk that advances the TDMA clocks and
        applies SYNC side effects; then the chunk's egress. On a
        multi-rank mesh this rank fetches and walks only its own
        carriers (collect_local; side_carrier holds their global ids)."""
        d = (self._fast.collect_local(h) if self._fast.multiproc
             else self._fast.collect(h))
        n = len(d["carrier"])
        recs = np.column_stack([
            d["carrier"], d["kind"], d["okA"], d["okB"], d["delta"],
            np.arange(n, dtype=np.int32), d["slot_ref"]])
        with trace.span("chunk.walk", h.seq):
            evd = self.native_cp.walk2(d["payload"].reshape(-1), recs,
                                       d["tail"])
        with trace.span("chunk.egress", h.seq):
            self._egress(h, d, evd)

    def _egress(self, h, d, evd):
        """After the walk: the native events kept, the per-carrier stats,
        TDMA time and cell identity, then GSMTAP, the TL-SDU egress and
        the traffic dumps."""
        self.native_events.append(evd)

        B = len(self.carriers)
        adv_all = np.bincount(d["carrier"], weights=d["delta"],
                              minlength=B).astype(np.int64)
        kinds = evd["kind"]
        cars = evd["carrier"]
        crc = kinds == EV.CRC
        ok_c = np.bincount(cars[crc & (evd["b"] == 1)], minlength=B)
        wr_c = np.bincount(cars[crc & (evd["b"] == 0)], minlength=B)
        if trace.enabled():
            trace.count("slots.crc_wrong", int(wr_c.sum()))
        states = self.native_cp.get_states()
        scr = d["scramb"]
        for i, c in enumerate(np.asarray(d["side_carrier"], np.int64)):
            c = int(c)
            rx = self.carriers[c]
            adv = adv_all[c] + int(d["tail"][i])
            if adv:
                rx.stats.bursts += int(adv)
                rx.stats.slots += int(adv)
            rx.stats.crc_ok += int(ok_c[c])
            rx.stats.crc_wrong += int(wr_c[c])
            rx.time.tn, rx.time.fn, rx.time.mn = (int(states[c, 0]),
                                                  int(states[c, 1]),
                                                  int(states[c, 2]))
            rx.colour_code, rx.mcc, rx.mnc = (int(states[c, 3]),
                                              int(states[c, 4]),
                                              int(states[c, 5]))
            rx.scramb_init = int(scr[i])

        if self.gsmtap is not None:
            self._export_gsmtap(evd, d)
        arena = evd.get("payload")
        if arena is not None and len(arena):
            self._payload_egress(evd, arena)
        tr = np.flatnonzero(kinds == EV.TRAFFIC)
        # a multi-rank mesh skips the dumps and voice, as tetra_tpu:
        # voice dumping is a single-host concern
        if (len(tr) and self.carriers and self.carriers[0].dumpdir
                and not self._fast.multiproc):
            self._dump_traffic(h, evd, tr, arena)
