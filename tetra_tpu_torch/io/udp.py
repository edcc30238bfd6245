"""UDP ingest/egress for live SDR operation (copy of
tetra_tpu.io.udp).

Reference behaviour: src/receiver1udp glues the GNU Radio demod to
tetra-rx with `socat UDP-LISTEN:...` (receiver1udp:71-78), and
telive_1ch_simple_gr310_udp.py streams complex samples to UDP port
42001. Here the same transports are native: a datagram source yielding
sample chunks, and a sink for forwarding decoded output.
"""
from __future__ import annotations

import socket

import numpy as np

__all__ = ["UdpSource", "UdpSink", "TELIVE_PORT"]

TELIVE_PORT = 42001


class UdpSource:
    """Receive sample chunks over UDP.

    dtype: np.complex64 for IQ (telive flowgraph), np.float32 for demod
    symbols, np.uint8 for sliced bits."""

    def __init__(self, port: int, host: str = "0.0.0.0", dtype=np.complex64,
                 bufsize: int = 1 << 16, timeout: float | None = None):
        self.dtype = np.dtype(dtype)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 22)
        self.sock.bind((host, port))
        if timeout is not None:
            self.sock.settimeout(timeout)
        self.bufsize = bufsize

    def recv(self) -> np.ndarray:
        """One datagram -> typed array (truncated to whole elements)."""
        data, _ = self.sock.recvfrom(self.bufsize)
        n = len(data) // self.dtype.itemsize
        return np.frombuffer(data[: n * self.dtype.itemsize], dtype=self.dtype)

    def stream(self, total_elements: int | None = None):
        """Generator of chunks until timeout/total reached."""
        got = 0
        while total_elements is None or got < total_elements:
            try:
                chunk = self.recv()
            except socket.timeout:
                return
            got += len(chunk)
            yield chunk

    def close(self):
        self.sock.close()


class UdpSink:
    def __init__(self, host: str, port: int):
        self.addr = (host, port)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)

    def send(self, arr: np.ndarray) -> int:
        return self.sock.sendto(np.asarray(arr).tobytes(), self.addr)

    def close(self):
        self.sock.close()
