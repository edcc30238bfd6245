"""Collect UDP datagrams in a process of their own: the GSMTAP sink of
the port's tests and of chip_smoke.py.

    with udp_sink.collect() as sink:
        receiver.gsmtap.addr = sink.addr
        ...                       # run the receiver
    sink.packets                  # the datagrams, in arrival order

A receiver sends its packets in bursts; read in the sending process, a
reader thread waits for the interpreter lock and the socket's buffer
overflows. As a script, this file binds 127.0.0.1 on the given port (by
default an ephemeral one), prints the port, keeps every datagram until
one equal to END arrives, then writes them to stdout, each as a 4-byte
length and its bytes.

    python3 tools/udp_sink.py [port]
"""
import socket
import struct
import subprocess
import sys

END = b"\x00udp_sink_end\x00"


def _serve(port: int) -> None:
    s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    s.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, 1 << 24)
    s.bind(("127.0.0.1", port))
    out = sys.stdout.buffer
    out.write(f"{s.getsockname()[1]}\n".encode())
    out.flush()
    pkts = []
    while True:
        data, _ = s.recvfrom(65536)
        if data == END:
            break
        pkts.append(data)
    for data in pkts:
        out.write(struct.pack("<I", len(data)) + data)
    out.flush()
    s.close()


class collect:
    """Context manager: a sink process on 127.0.0.1:`port` (0: an
    ephemeral port) on entry (`addr`), its datagrams in `packets` on
    exit."""

    def __init__(self, port: int = 0):
        self.port = port

    def __enter__(self):
        self.proc = subprocess.Popen([sys.executable, __file__,
                                      str(self.port)],
                                     stdout=subprocess.PIPE)
        self.addr = ("127.0.0.1", int(self.proc.stdout.readline()))
        self.packets = []
        return self

    def __exit__(self, *exc):
        with socket.socket(socket.AF_INET, socket.SOCK_DGRAM) as s:
            s.sendto(END, self.addr)
        try:
            data = self.proc.communicate(timeout=120)[0]
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        i = 0
        while i < len(data):
            (n,) = struct.unpack_from("<I", data, i)
            self.packets.append(data[i + 4:i + 4 + n])
            i += 4 + n
        return False


if __name__ == "__main__":
    _serve(int(sys.argv[1]) if len(sys.argv) > 1 else 0)
