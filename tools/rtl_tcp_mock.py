"""A mock rtl_tcp server in a process of its own: the port's copy of
tests/test_sdr.MockRtlTcp, for the port's tests and chip_smoke.py.

It speaks the rtl_tcp wire protocol to one client: the 12-byte RTL0
banner (an R820T tuner with 29 gain steps), then the fixed unsigned-8-bit
interleaved I/Q payload, while it records the 5-byte set-parameter
commands the client sends. Once the payload is sent it keeps reading
commands until the client hangs up (or 5 s pass).

    with rtl_tcp_mock.serve(payload_u8) as srv:
        receiver.main(["--rtltcp", f"127.0.0.1:{srv.port}", ...])
    srv.commands        # [(cmd, param), ...] in arrival order

In its own process the server's send loop never waits for the
receiver's interpreter lock. As a script it serves the payload file
given, prints its port, and on exit prints the commands as JSON:

    python3 tools/rtl_tcp_mock.py payload.u8
"""
import json
import os
import select
import socket
import struct
import subprocess
import sys
import tempfile

import numpy as np


TUNER_TYPE, GAINS = 5, 29      # R820T (io/sdr.TUNER_NAMES), 29 steps


def _serve(path: str) -> None:
    with open(path, "rb") as f:
        payload = memoryview(f.read())
    ls = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    ls.bind(("127.0.0.1", 0))
    ls.listen(1)
    print(ls.getsockname()[1], flush=True)
    conn, _ = ls.accept()
    conn.sendall(b"RTL0" + struct.pack(">II", TUNER_TYPE, GAINS))
    buf = bytearray()
    sent = 0
    try:
        while sent < len(payload):
            r, w, _ = select.select([conn], [conn], [], 60.0)
            if not (r or w):
                break
            if r:
                data = conn.recv(4096)
                if not data:
                    break
                buf += data
            if w:
                sent += conn.send(payload[sent:sent + 65536])
        conn.settimeout(5.0)
        while True:
            data = conn.recv(4096)
            if not data:
                break
            buf += data
    except OSError:       # the client hung up or went quiet
        pass
    conn.close()
    ls.close()
    cmds = [struct.unpack(">BI", bytes(buf[i:i + 5]))
            for i in range(0, len(buf) - len(buf) % 5, 5)]
    print(json.dumps(cmds), flush=True)


class serve:
    """Context manager: a mock rtl_tcp server process serving
    `payload_u8` on 127.0.0.1 (`port`); the commands it received in
    `commands` on exit."""

    def __init__(self, payload_u8):
        self.payload = np.asarray(payload_u8, np.uint8)
        self.commands = []

    def __enter__(self):
        fd, self._path = tempfile.mkstemp(suffix=".u8")
        with os.fdopen(fd, "wb") as f:
            f.write(self.payload.tobytes())
        self.proc = subprocess.Popen(
            [sys.executable, __file__, self._path], stdout=subprocess.PIPE,
            text=True)
        self.port = int(self.proc.stdout.readline())
        return self

    def __exit__(self, exc_type, *exc):
        out = ""
        try:
            if exc_type is not None:      # the client may never connect
                self.proc.kill()
            out = self.proc.communicate(timeout=120)[0]
        except subprocess.TimeoutExpired:
            pass
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
            os.unlink(self._path)
        lines = out.strip().splitlines()
        self.commands = [tuple(c) for c in json.loads(lines[-1])] \
            if lines else []
        return False


def scan_payload(u8, fs: float) -> np.ndarray:
    """The payload for a client that scans first (the receiver's
    --carriers auto reads 1 s, then streams): that second (u8 tiled),
    the capture, then 0.5 s of silence (127)."""
    u8 = np.asarray(u8, np.uint8)
    reps = -(-int(2 * fs) // len(u8))
    return np.concatenate([np.tile(u8, reps)[: int(2 * fs)], u8,
                           np.full(int(fs), 127, np.uint8)])


if __name__ == "__main__":
    _serve(sys.argv[1])
