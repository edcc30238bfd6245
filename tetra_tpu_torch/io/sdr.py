"""Live SDR sample sources over the network (rtl_tcp protocol) (copy of
tetra_tpu.io.sdr).

Reference behaviour: the live demod variants acquire I/Q straight from
SDR hardware through GNU Radio source blocks — gr-osmosdr for rtl-sdr /
USRP (reference src/demod/osmosdr-tetra_demod_fft.py:64-96, default
1.8 Msps) and an audio-card source for the FuncubeDongle Pro (reference
src/demod/fcdp-tetra_demod.py:17-50).  Neither driver stack exists
here, and none is needed: every rtl-sdr deployment ships `rtl_tcp`, a
tiny daemon that exposes the same hardware over a trivial TCP protocol
(12-byte `RTL0` banner, 5-byte set-parameter commands, then a raw
stream of unsigned-8-bit interleaved I/Q).  This module speaks that
protocol directly with the standard socket library, so the framework
ingests from real hardware with zero native drivers — and because the
wideband capture lands as one tensor, a single source feeds EVERY
carrier in the dongle's span at once instead of one process per
carrier.

The FuncubeDongle path is covered the same way: anything that can
deliver I/Q over TCP/UDP/file (including an `arecord | nc` pipeline at
the FCDP's 96 kHz) feeds the identical ingest; see io/udp.py and
io/inputs.py.
"""
from __future__ import annotations

import socket
import struct

import numpy as np

from tetra_tpu_torch.utils import trace

__all__ = ["RtlTcpSource", "RTL_TCP_PORT", "TUNER_NAMES"]

RTL_TCP_PORT = 1234

# rtl_tcp SET_* command ids (librtlsdr rtl_tcp.c command switch)
CMD_FREQ = 0x01
CMD_SAMPLE_RATE = 0x02
CMD_GAIN_MODE = 0x03
CMD_GAIN = 0x04           # tenths of dB
CMD_FREQ_CORRECTION = 0x05  # ppm, signed
CMD_AGC_MODE = 0x08
CMD_DIRECT_SAMPLING = 0x09
CMD_OFFSET_TUNING = 0x0A
CMD_BIAS_TEE = 0x0E

TUNER_NAMES = {0: "UNKNOWN", 1: "E4000", 2: "FC0012", 3: "FC0013",
               4: "FC2580", 5: "R820T", 6: "R828D"}


class RtlTcpSource:
    """I/Q source speaking the rtl_tcp wire protocol.

    >>> src = RtlTcpSource("sdr-host")          # doctest: +SKIP
    >>> src.configure(freq_hz=392.5e6, rate_hz=1.8e6, gain_db=38.0)
    >>> for iq in src.stream(chunk=1 << 20): ...   # complex64 chunks

    Samples arrive as unsigned bytes centred on 127.5 and are rescaled
    to ~unit-amplitude complex64 (the demod's AGC removes the residual
    scale, as the reference's feedforward AGC does at cqpsk.py:237).
    """

    def __init__(self, host: str, port: int = RTL_TCP_PORT,
                 timeout: float | None = 10.0):
        self.sock = socket.create_connection((host, port), timeout=timeout)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
        hdr = self._read_exact(12)
        if hdr[:4] != b"RTL0":
            raise IOError(f"not an rtl_tcp server (banner {hdr[:4]!r})")
        self.tuner_type, self.tuner_gain_count = struct.unpack(">II", hdr[4:])
        self.tuner_name = TUNER_NAMES.get(self.tuner_type,
                                          str(self.tuner_type))
        self.sample_rate = None

    # -- control ---------------------------------------------------------
    def _cmd(self, cmd: int, param: int):
        self.sock.sendall(struct.pack(">BI", cmd, param & 0xFFFFFFFF))

    def set_freq(self, hz: float):
        self._cmd(CMD_FREQ, int(round(hz)))

    def set_sample_rate(self, hz: float):
        self.sample_rate = float(hz)
        self._cmd(CMD_SAMPLE_RATE, int(round(hz)))

    def set_gain_mode(self, manual: bool):
        self._cmd(CMD_GAIN_MODE, 1 if manual else 0)

    def set_gain(self, db: float):
        """Manual tuner gain in dB (protocol carries tenths of dB)."""
        self.set_gain_mode(True)
        self._cmd(CMD_GAIN, int(round(db * 10.0)))

    def set_freq_correction(self, ppm: int):
        self._cmd(CMD_FREQ_CORRECTION, int(ppm))

    def set_agc(self, on: bool):
        self._cmd(CMD_AGC_MODE, 1 if on else 0)

    def set_bias_tee(self, on: bool):
        self._cmd(CMD_BIAS_TEE, 1 if on else 0)

    def configure(self, freq_hz: float, rate_hz: float,
                  gain_db: float | None = None, ppm: int = 0):
        """The osmosdr-source parameter set in one call (reference
        osmosdr-tetra_demod_fft.py options: -f/-s/-g/-c)."""
        self.set_sample_rate(rate_hz)
        self.set_freq(freq_hz)
        if ppm:
            self.set_freq_correction(ppm)
        if gain_db is None:
            self.set_gain_mode(False)
            self.set_agc(True)
        else:
            self.set_gain(gain_db)

    # -- data ------------------------------------------------------------
    def _read_exact(self, n: int) -> bytes:
        buf = bytearray()
        while len(buf) < n:
            chunk = self.sock.recv(n - len(buf))
            if not chunk:
                raise EOFError("rtl_tcp stream closed")
            buf += chunk
        return bytes(buf)

    def read(self, n_samples: int) -> np.ndarray:
        """Blocking read of exactly n_samples complex samples."""
        raw = np.frombuffer(self._read_exact(2 * n_samples), dtype=np.uint8)
        return self._to_complex(raw)

    def read_ri(self, n_samples: int):
        """Planar (re, im) float32 variant (device-transport friendly)."""
        raw = np.frombuffer(self._read_exact(2 * n_samples), dtype=np.uint8)
        f = (raw.astype(np.float32) - 127.5) * (1.0 / 127.5)
        return np.ascontiguousarray(f[0::2]), np.ascontiguousarray(f[1::2])

    @staticmethod
    @trace.spanned("io.u8")
    def _to_complex(raw_u8: np.ndarray) -> np.ndarray:
        """Interleaved u8 I/Q -> a fresh complex64 array of len // 2
        samples: each byte b becomes (b - 127.5) * (1 / 127.5) in float32,
        in place in one float32 array, which is then seen as complex64
        (even bytes I, odd bytes Q). An odd length raises ValueError."""
        f = np.subtract(raw_u8, np.float32(127.5), dtype=np.float32)
        f *= np.float32(1.0 / 127.5)
        return f.view(np.complex64)

    def stream(self, chunk: int = 1 << 20, total_samples: int | None = None):
        """Generator of complex64 chunks (`chunk` samples each) until
        total_samples (if given) or EOF/timeout."""
        got = 0
        while total_samples is None or got < total_samples:
            n = chunk if total_samples is None else min(
                chunk, total_samples - got)
            try:
                yield self.read(n)
            except (socket.timeout, EOFError):
                return
            got += n

    def close(self):
        try:
            self.sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        self.sock.close()
