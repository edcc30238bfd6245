"""Wideband ingest formats (port of tetra_tpu.io.stream).

The production format is companded 4+4-bit IQ (`iq4c`): one byte per
complex sample, each nibble an index into the 16 Lloyd-Max levels of a
unit-variance Gaussian. The other two are interleaved int8 IQ (`iq8`,
two bytes per complex sample, `quantize_iq` per plane) and uniform
4+4-bit IQ (`iq4`, two's-complement nibbles in [-7, 7]). The quantize_*
functions are the host-side encoders; the dequantize_* functions run on
the tensor's device. The double-buffered ingest loop of the JAX package
(`stream_map`) is not ported.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["LLOYD_MAX_16", "quantize_iq", "dequantize_iq", "quantize_iq4",
           "quantize_iq4c", "dequantize_iq4c", "dequantize_iq4"]

def quantize_iq(re, im, scale: float = 127.0):
    """Host-side float IQ -> int8 planar pair (SDR-capture-like)."""
    q = lambda x: np.clip(np.round(np.asarray(x) * scale), -127, 127).astype(np.int8)
    return q(re), q(im)


def dequantize_iq(re_i8: torch.Tensor, im_i8: torch.Tensor,
                  scale: float = 1.0 / 127.0):
    """int8 planar IQ -> float32 planes."""
    return (re_i8.to(torch.float32) * scale, im_i8.to(torch.float32) * scale)


def quantize_iq4(re, im, scale: float = 7.0) -> np.ndarray:
    """Host-side float IQ -> ONE uint8 per complex sample (I in the low
    nibble, Q in the high nibble, two's-complement nibbles in [-7, 7])."""
    q = lambda x: (np.clip(np.round(np.asarray(x) * scale), -7, 7)
                   .astype(np.int8) & 0xF).astype(np.uint8)
    return (q(re) | (q(im) << 4)).astype(np.uint8)


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
