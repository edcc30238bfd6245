"""TUN device output for decoded SNDCP IP payloads.

Copy of tetra_tpu.io.tun, kept in the port so that it imports nothing of
the JAX package; tests/test_torch_tables.py holds it to the original.

Reference behaviour: src/tuntap.c (tun_alloc of an IFF_TUN|IFF_NO_PI
device) and src/tunctl.c (persistent-device management); the LLC writes
reassembled IP packets into tun0 (src/tetra_llc.c:93-101).
"""
from __future__ import annotations

import fcntl
import os
import struct

__all__ = ["TunDevice", "tun_alloc", "tunctl"]

TUNSETIFF = 0x400454CA
TUNSETPERSIST = 0x400454CB
TUNSETOWNER = 0x400454CC
TUNSETGROUP = 0x400454CE
IFF_TUN = 0x0001
IFF_TAP = 0x0002
IFF_NO_PI = 0x1000


def tun_alloc(name: str = "tun0") -> int:
    """Open /dev/net/tun as IFF_TUN|IFF_NO_PI (reference tuntap.c:13-42).

    Returns the fd; raises OSError when unavailable (e.g. sandboxed).
    """
    fd = os.open("/dev/net/tun", os.O_RDWR)
    ifr = struct.pack("16sH22x", name.encode(), IFF_TUN | IFF_NO_PI)
    fcntl.ioctl(fd, TUNSETIFF, ifr)
    return fd


class TunDevice:
    """IP packet sink; silently disabled when the TUN device can't open
    (matching the reference's fd<0 behaviour, tetra_llc.c:95-101)."""

    def __init__(self, name: str = "tun0"):
        self.name = name
        self.fd = -1
        try:
            self.fd = tun_alloc(name)
        except OSError:
            pass

    def write(self, packet: bytes) -> int:
        if self.fd < 0:
            return 0
        return os.write(self.fd, packet)

    def close(self):
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1


def tunctl(name: str = "tun0", owner: int | None = None,
           delete: bool = False) -> int:
    """Create/delete a persistent TUN device (reference tunctl.c:34-160)."""
    fd = os.open("/dev/net/tun", os.O_RDWR)
    try:
        ifr = struct.pack("16sH22x", name.encode(), IFF_TUN | IFF_NO_PI)
        fcntl.ioctl(fd, TUNSETIFF, ifr)
        if delete:
            fcntl.ioctl(fd, TUNSETPERSIST, 0)
        else:
            if owner is not None:
                fcntl.ioctl(fd, TUNSETOWNER, owner)
            fcntl.ioctl(fd, TUNSETPERSIST, 1)
        return 0
    finally:
        os.close(fd)
