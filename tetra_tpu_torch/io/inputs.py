"""Capture-file ingest: .bits / float-symbol / complex-IQ formats (port
of tetra_tpu.io.inputs).

Mirrors the reference's input formats: `tetra-rx` consumes one byte per
bit (reference tetra-rx.c:86-95), `float_to_bits` consumes float32
phase symbols (float_to_bits.c:120-160), and the demod flowgraphs
consume complex64 "cfiles" (README.md:132-139).
"""
from __future__ import annotations

import numpy as np

__all__ = ["read_bits_file", "read_float_file", "read_cfile", "load_capture",
           "capture_to_bits"]


def read_bits_file(path: str) -> np.ndarray:
    """1 byte per bit -> ubits array."""
    return (np.fromfile(path, dtype=np.uint8) & 1)


def read_float_file(path: str) -> np.ndarray:
    """float32 phase symbols (pi/4 units, ±1/±3)."""
    return np.fromfile(path, dtype=np.float32)


def read_cfile(path: str) -> np.ndarray:
    """complex64 baseband samples (GNU Radio cfile)."""
    return np.fromfile(path, dtype=np.complex64)


def load_capture(path: str, kind: str = "auto") -> tuple[str, np.ndarray]:
    """Load a capture, inferring the format from the extension when
    kind='auto': .bits -> bits, .fl/.float -> float symbols,
    .cfile/.iq/.cf32 -> complex IQ. Returns (kind, array)."""
    if kind == "auto":
        lower = path.lower()
        if lower.endswith((".cfile", ".iq", ".cf32")):
            kind = "iq"
        elif lower.endswith((".fl", ".float", ".f32")):
            kind = "float"
        else:
            kind = "bits"
    if kind == "bits":
        return kind, read_bits_file(path)
    if kind == "float":
        return kind, read_float_file(path)
    if kind == "iq":
        return kind, read_cfile(path)
    raise ValueError(f"unknown capture kind {kind!r}")


def capture_to_bits(kind: str, data: np.ndarray, sps: int = 2,
                    device=None) -> np.ndarray:
    """Run the front-end stages needed to turn any capture into hard
    bits (host numpy); the slicer and the demod run on `device`, the
    card unless the caller asks for the CPU."""
    import torch
    from tetra_tpu_torch.device import resolve_device
    from tetra_tpu_torch.phy import dqpsk
    if kind == "bits":
        return np.asarray(data, dtype=np.uint8)
    dev = resolve_device(device)
    if kind == "float":
        syms = torch.as_tensor(np.asarray(data, np.float32), device=dev)
        return dqpsk.float_to_bits(syms).cpu().numpy()
    if kind == "iq":
        syms = dqpsk.demodulate(data, sps=sps, device=dev)
        return dqpsk.float_to_bits(syms).cpu().numpy()
    raise ValueError(kind)
