"""ctypes bindings for the native host hot-path library.

Copy of tetra_tpu.crypto.native, kept in the port so that it imports nothing of
the JAX package; tests/test_torch_tables.py holds it to the original.

Loads native/libtetra_native.so (built by native/Makefile; auto-built
on first use when a toolchain is present) and exposes batch keystream /
CRC services. Falls back to the pure-Python implementations when the
library is unavailable, so the framework remains functional everywhere.
"""
from __future__ import annotations

import ctypes
import pathlib
import subprocess

import numpy as np

__all__ = ["available", "tea_keystream_batch", "tb5", "crc16_batch",
           "fcs32_batch"]

_NATIVE_DIR = pathlib.Path(__file__).parent.parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libtetra_native.so"
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if not _LIB_PATH.exists():
        try:
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True, timeout=120)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(str(_LIB_PATH))
    except OSError:
        return None
    lib.tetra_tea_keystream_batch.argtypes = [
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8)]
    lib.tetra_tb5.argtypes = [
        ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_uint8)]
    lib.tetra_crc16_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint16)]
    lib.tetra_fcs32_batch.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint32)]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def _ptr(arr, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def tea_keystream_batch(ksg: int, ivs, ecks, nbytes: int) -> np.ndarray:
    """n independent keystreams: ivs [n] uint32, ecks [n, 10] bytes ->
    [n, nbytes] uint8. Uses the native core when available."""
    ivs = np.ascontiguousarray(ivs, dtype=np.uint32)
    ecks = np.ascontiguousarray(ecks, dtype=np.uint8)
    n = len(ivs)
    assert ecks.shape == (n, 10)
    lib = _load()
    if lib is None:
        from tetra_tpu_torch.crypto import tea
        fn = {1: tea.tea1, 2: tea.tea2, 3: tea.tea3}[ksg]
        return np.stack([
            np.frombuffer(fn(int(ivs[i]), bytes(ecks[i]), nbytes), np.uint8)
            for i in range(n)])
    out = np.empty((n, nbytes), dtype=np.uint8)
    lib.tetra_tea_keystream_batch(ksg, _ptr(ivs, ctypes.c_uint32),
                                  _ptr(ecks, ctypes.c_uint8), n, nbytes,
                                  _ptr(out, ctypes.c_uint8))
    return out


def tb5(cn: int, la: int, cc: int, ck: bytes) -> bytes:
    lib = _load()
    if lib is None:
        from tetra_tpu_torch.crypto import taa1
        return taa1.tb5(cn, la, cc, ck)
    ckb = np.frombuffer(bytes(ck[:10]), dtype=np.uint8).copy()
    out = np.empty(10, dtype=np.uint8)
    lib.tetra_tb5(cn, la, cc, _ptr(ckb, ctypes.c_uint8), _ptr(out, ctypes.c_uint8))
    return bytes(out)


def crc16_batch(bits) -> np.ndarray:
    """[n, len] unpacked bits -> [n] uint16 CRC values."""
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    n, length = bits.shape
    lib = _load()
    if lib is None:
        from tetra_tpu_torch.ops.crc import crc16_bits_np
        return np.asarray([crc16_bits_np(bits[i]) for i in range(n)],
                          dtype=np.uint16)
    out = np.empty(n, dtype=np.uint16)
    lib.tetra_crc16_batch(_ptr(bits, ctypes.c_uint8), n, length,
                          _ptr(out, ctypes.c_uint16))
    return out


def fcs32_batch(bits) -> np.ndarray:
    """[n, len] unpacked bits -> [n] uint32 FCS values."""
    bits = np.ascontiguousarray(bits, dtype=np.uint8)
    n, length = bits.shape
    lib = _load()
    if lib is None:
        from tetra_tpu_torch.ops.crc import fcs32_np
        return np.asarray([fcs32_np(bits[i]) for i in range(n)], dtype=np.uint32)
    out = np.empty(n, dtype=np.uint32)
    lib.tetra_fcs32_batch(_ptr(bits, ctypes.c_uint8), n, length,
                          _ptr(out, ctypes.c_uint32))
    return out
