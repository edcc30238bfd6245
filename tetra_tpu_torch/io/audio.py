"""Audio-card I/Q source: the fcdp (Funcube Dongle Pro) ingest path
(copy of tetra_tpu.io.audio).

Reference behaviour: src/demod/fcdp-tetra_demod.py:17-57 — a GNU Radio
`audio.source` reads the dongle's stereo PCM (left = I, right = Q,
default 96 kHz), `float_to_complex` pairs the channels, then a
freq-xlating low-pass (`-c` calibration offset, 25 kHz cut-off) and a
fractional resampler bring the signal to the demod rate (36 kHz).

This module owns only the byte-level PCM ingest — the same interleaved
frames ALSA would deliver, read from any file object, pipe or fd
(`arecord -f S16_LE -c 2 -r 96000 -t raw -D hw:1 | ...`), so no audio
stack is needed in-process. The downstream mix + low-pass + resample
runs on the device through `phy.channelizer.channelize_ri`
(offsets=[calibration], fs=audio rate), shared with the wideband SDR
path. Wired into the CLI as `python -m tetra_tpu_torch.receiver --audio
- --audio-rate 96000`.
"""
from __future__ import annotations

import sys

import numpy as np

__all__ = ["AudioPipeSource", "FCDP_RATE"]

FCDP_RATE = 96_000.0     # the reference's default (-r, fcdp-tetra_demod.py:62)


class AudioPipeSource:
    """Interleaved stereo PCM frames -> complex I/Q samples.

    source: a path, '-' for stdin, or any binary file object.
    fmt: 's16le' (arecord S16_LE; scaled to +-1.0) or 'f32le'
    (FLOAT_LE — what gnuradio's audio.source produces internally).
    swap_iq flips the channel pairing for cards that wire Q to the
    left channel.
    """

    _ITEM = {"s16le": (np.dtype("<i2"), 1.0 / 32768.0),
             "f32le": (np.dtype("<f4"), 1.0)}

    def __init__(self, source, sample_rate: float = FCDP_RATE,
                 fmt: str = "s16le", swap_iq: bool = False):
        if fmt not in self._ITEM:
            raise ValueError(f"unknown PCM format {fmt!r}")
        self.sample_rate = float(sample_rate)
        self.fmt = fmt
        self.swap_iq = swap_iq
        self._own = False
        if source == "-":
            self._f = sys.stdin.buffer
        elif isinstance(source, (str, bytes)):
            self._f = open(source, "rb")
            self._own = True
        else:
            self._f = source
        self._tail = b""

    def read(self, n_samples: int) -> np.ndarray:
        """Read up to n_samples complex samples (short at EOF)."""
        dt, scale = self._ITEM[self.fmt]
        frame = 2 * dt.itemsize
        want = n_samples * frame - len(self._tail)
        chunks = [self._tail]
        got = 0
        while got < want:
            b = self._f.read(want - got)
            if not b:
                break
            chunks.append(b)
            got += len(b)
        raw = b"".join(chunks)
        usable = len(raw) - len(raw) % frame
        self._tail = raw[usable:]
        if not usable:
            return np.zeros(0, np.complex64)
        pcm = np.frombuffer(raw[:usable], dt).astype(np.float32) * scale
        i, q = pcm[0::2], pcm[1::2]
        if self.swap_iq:
            i, q = q, i
        return (i + 1j * q).astype(np.complex64)

    def read_ri(self, n_samples: int):
        z = self.read(n_samples)
        return (np.real(z).astype(np.float32),
                np.imag(z).astype(np.float32))

    def stream(self, chunk: int = 1 << 16):
        """Yield complex chunks until EOF."""
        while True:
            z = self.read(chunk)
            if len(z) == 0:
                return
            yield z

    def close(self):
        if self._own:
            self._f.close()
