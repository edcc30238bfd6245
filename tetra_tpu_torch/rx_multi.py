"""Multi-carrier receiver, production path (port of the PFB + native
control-plane branch of tetra_tpu.rx_multi).

Wideband companded IQ (`process_iq4c`) or complex samples (`process_iq`)
in, per-carrier decode stats and native control-plane events out. Each
chunk runs as one fused chunk program on the device (fastpath.submit_iq)
and one C++ walk of the upper MAC / LLC / MLE / crypto
(tetra_tpu.umac.native_exec). Chunks are pipelined: up to
`pipeline_depth` dispatched chunks wait before the oldest is fetched
and walked; a final=True call drains the queue.

demod="soft" is the degraded-signal mode: int8 soft demod, a sync scan
that accepts 2 training-sequence bit errors, and the soft Viterbi
(kernel K4) over the same kind-compacted FEC.

Not ported (NotImplementedError): the mixer-bank channelizer (no
pfb_channels), the Python control plane, mesh sharding, GSMTAP export,
TL-SDU sinks, traffic dumps and voice decode.
"""
from __future__ import annotations

import numpy as np
import torch

from tetra_tpu_torch.device import resolve_device
from tetra_tpu_torch.fastpath import FastChunkPipeline
from tetra_tpu_torch.rx import CarrierState, RxStats

__all__ = ["MultiCarrierReceiver", "pfb_demod_bits_len"]


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


class MultiCarrierReceiver:
    def __init__(self, offsets_hz, fs: float, sps: int = 2,
                 keystore_path: str | None = None,
                 dumpdir: str | None = None,
                 pfb_channels=None, n_chan: int | None = None,
                 control_plane: str = "native",
                 gsmtap_host: str | None = None,
                 decode_voice: bool = False,
                 tl_sdu_sink=None, mesh=None, demod: str = "hard",
                 device=None):
        if pfb_channels is None:
            raise NotImplementedError("the mixer-bank channelizer is not "
                                      "ported; pass pfb_channels")
        if control_plane != "native":
            raise NotImplementedError("only the native control plane is "
                                      "ported")
        if demod not in ("hard", "soft"):
            raise ValueError(f"demod must be 'hard' or 'soft', got {demod!r}")
        if mesh is not None:
            raise NotImplementedError("mesh sharding is not ported")
        if gsmtap_host or dumpdir or decode_voice or tl_sdu_sink is not None:
            raise NotImplementedError("GSMTAP export, traffic dumps, voice "
                                      "decode and TL-SDU sinks are not "
                                      "ported")
        from tetra_tpu.umac.native_exec import NativeControlPlane
        self.device = resolve_device(device)
        self.fs = float(fs)
        self.sps = sps
        self.pfb_channels = np.asarray(pfb_channels, np.int32)
        self.n_chan = (n_chan if n_chan is not None
                       else int(round(fs / 25_000.0)))
        n_carriers = len(self.pfb_channels)
        self.carriers = [CarrierState() for _ in range(n_carriers)]
        self.native_cp = NativeControlPlane(n_carriers)
        if keystore_path:
            from tetra_tpu.crypto.crypto import load_keystore
            self.native_cp.set_keys(load_keystore(keystore_path))
        self.native_events = []
        self._fast = FastChunkPipeline(n_carriers, self.device,
                                       soft=demod == "soft")
        self._pending = []
        # chunks kept in flight while streaming (final=False)
        self.pipeline_depth = 2
        chans = torch.as_tensor(self.pfb_channels, dtype=torch.int64)
        self._chan_idx = (None if np.array_equal(
            self.pfb_channels, np.arange(self.n_chan))
            else chans.to(self.device))
        self._wb_rem = None
        self._wb_hist = None
        self._wb_g = None

    def process_iq(self, wideband_iq, final: bool = True) -> list[RxStats]:
        """One chunk of wideband complex samples through the chain (sent
        to the device as interleaved float32 I/Q)."""
        iq = np.ascontiguousarray(np.asarray(wideband_iq, np.complex64))
        return self._wideband_stream(iq.view(np.float32), 2, "f32i", final)

    def process_iq4c(self, packed_u8, final: bool = True) -> list[RxStats]:
        """One chunk of companded 4+4-bit wideband IQ (one byte per
        complex sample, io.stream.quantize_iq4c) through the chain."""
        return self._wideband_stream(np.asarray(packed_u8, np.uint8), 1,
                                     "iq4c", final)

    def _wideband_stream(self, raw, k: int, fmt: str, final: bool):
        """Overlap-save streaming for the PFB front end: each
        continuation re-feeds the last W raw samples, and chunks are
        consumed in BLOCK-aligned quanta (BLOCK = 25*n_chan samples =
        exactly 36 demod bits per carrier), so the per-call output's
        valid region equals the continuous stream's bits. raw: 1-D,
        k elements per complex sample."""
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
                return self.process_bits(
                    np.zeros((len(self.carriers), 0), np.uint8), final=True)
            return [c.stats for c in self.carriers]
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
        h = self._fast.submit_iq(feed, fmt, keep, self._chan_idx, n,
                                 self.fs, sps=self.sps)
        return self._native_drain(h, final)

    def _reset_wb_stream(self):
        self._wb_hist = None
        self._wb_rem = self._wb_rem[:0]
        self._wb_g = None

    def process_bits(self, bits, final: bool = True) -> list[RxStats]:
        """Per-carrier hard bits [C, T] -> per-carrier decode stats."""
        if bits.ndim != 2 or bits.shape[0] != len(self.carriers):
            raise ValueError("bits must be [n_carriers, T]")
        return self._native_drain(self._fast.submit(bits), final)

    def _native_drain(self, h, final: bool) -> list[RxStats]:
        """Queue one dispatched chunk and drain the pipeline to its
        depth (or fully, when final)."""
        if h is not None:
            self._pending.append(h)
        while self._pending and (final
                                 or len(self._pending) > self.pipeline_depth):
            self._collect_walk(self._pending.pop(0))
        return [c.stats for c in self.carriers]

    def _collect_walk(self, h):
        """Fetch one chunk and run the native control plane: numpy record
        assembly + ONE C++ walk that advances the TDMA clocks and
        applies SYNC side effects."""
        from tetra_tpu.umac.native_exec import EV
        d = self._fast.collect(h)
        n = len(d["carrier"])
        recs = np.column_stack([
            d["carrier"], d["kind"], d["okA"], d["okB"], d["delta"],
            np.arange(n, dtype=np.int32), d["slot_ref"]])
        evd = self.native_cp.walk2(d["payload"].reshape(-1), recs,
                                   d["tail"])
        self.native_events.append(evd)

        B = len(self.carriers)
        adv_all = np.bincount(d["carrier"], weights=d["delta"],
                              minlength=B).astype(np.int64)
        kinds = evd["kind"]
        cars = evd["carrier"]
        crc = kinds == EV.CRC
        ok_c = np.bincount(cars[crc & (evd["b"] == 1)], minlength=B)
        wr_c = np.bincount(cars[crc & (evd["b"] == 0)], minlength=B)
        states = self.native_cp.get_states()
        scr = d["scramb"]
        for i, c in enumerate(np.asarray(d["side_carrier"], np.int64)):
            c = int(c)
            cs = self.carriers[c]
            adv = adv_all[c] + int(d["tail"][i])
            if adv:
                cs.stats.bursts += int(adv)
                cs.stats.slots += int(adv)
            cs.stats.crc_ok += int(ok_c[c])
            cs.stats.crc_wrong += int(wr_c[c])
            cs.time.tn, cs.time.fn, cs.time.mn = (int(states[c, 0]),
                                                  int(states[c, 1]),
                                                  int(states[c, 2]))
            cs.colour_code, cs.mcc, cs.mnc = (int(states[c, 3]),
                                              int(states[c, 4]),
                                              int(states[c, 5]))
            cs.scramb_init = int(scr[i])
        tl = (kinds == EV.TLSDU) & (evd["d"] >= 0) & ((evd["d"] & 1) == 1)
        if ((evd["c"][tl] > 19).any()):
            raise NotImplementedError("TUN egress of reassembled SNDCP "
                                      "packets is not ported")
