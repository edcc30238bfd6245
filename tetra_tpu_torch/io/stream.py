"""Wideband ingest formats (port of tetra_tpu.io.stream).

The production format is companded 4+4-bit IQ (`iq4c`): one byte per
complex sample, each nibble an index into the 16 Lloyd-Max levels of a
unit-variance Gaussian. `quantize_iq4c` is the host-side encoder used
to build fixtures.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["LLOYD_MAX_16", "quantize_iq4c", "dequantize_iq4c",
           "dequantize_iq4"]

# Optimal (Lloyd-Max) 16-level quantizer for a unit-variance Gaussian
# (Max, "Quantizing for minimum distortion", 1960).
LLOYD_MAX_16 = np.array(
    [-2.733, -2.069, -1.618, -1.256, -0.9424, -0.6568, -0.3881, -0.1284,
     0.1284, 0.3881, 0.6568, 0.9424, 1.256, 1.618, 2.069, 2.733],
    np.float32)
_LM16_BOUNDS = ((LLOYD_MAX_16[:-1] + LLOYD_MAX_16[1:]) / 2).astype(np.float32)


def quantize_iq4c(re, im, sigma: float | None = None) -> np.ndarray:
    """Host-side float IQ -> ONE uint8 per complex sample, companded:
    each component maps to the nearest Lloyd-Max level for a Gaussian
    of the measured (or given) std; I index low nibble, Q high."""
    re = np.asarray(re)
    im = np.asarray(im)
    if sigma is None:
        sigma = float(np.sqrt((np.var(re) + np.var(im)) / 2.0)) or 1.0
    qi = np.searchsorted(_LM16_BOUNDS, re / sigma).astype(np.uint8)
    qq = np.searchsorted(_LM16_BOUNDS, im / sigma).astype(np.uint8)
    return (qi | (qq << 4)).astype(np.uint8)


def dequantize_iq4c(packed: torch.Tensor):
    """Companded 4+4-bit IQ [T] uint8 -> (re, im) float32 at unit sigma:
    two 16-entry table lookups."""
    lut = torch.as_tensor(LLOYD_MAX_16, device=packed.device)
    p = packed.to(torch.int64)
    return lut[p & 0xF], lut[(p >> 4) & 0xF]


def dequantize_iq4(packed: torch.Tensor, scale: float = 1.0 / 7.0):
    """Packed 4+4-bit two's-complement IQ [T] uint8 -> (re, im) float32."""
    p = packed.to(torch.int32)
    re4 = ((p & 0xF) ^ 8) - 8
    im4 = (((p >> 4) & 0xF) ^ 8) - 8
    return (re4.to(torch.float32) * scale, im4.to(torch.float32) * scale)
