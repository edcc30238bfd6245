"""Wideband ingest formats (port of tetra_tpu.io.stream).

The production format is companded 4+4-bit IQ (`iq4c`): one byte per
complex sample, each nibble an index into the 16 Lloyd-Max levels of a
unit-variance Gaussian. The other two are interleaved int8 IQ (`iq8`,
two bytes per complex sample, `quantize_iq` per plane) and uniform
4+4-bit IQ (`iq4`, two's-complement nibbles in [-7, 7]). The quantize_*
functions are the host-side encoders; the dequantize_* functions run on
the tensor's device. `stream_map` is the double-buffered ingest loop:
host chunks go to the card on a side stream while the previous chunk
computes.
"""
from __future__ import annotations

from collections.abc import Callable, Iterable, Iterator

import numpy as np
import torch

from tetra_tpu_torch.device import resolve_device

__all__ = ["LLOYD_MAX_16", "quantize_iq", "dequantize_iq", "quantize_iq4",
           "quantize_iq4c", "dequantize_iq4c", "dequantize_iq4",
           "stream_map"]

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


def _tree_map(fn, tree):
    """fn over the leaves of a tree of tuples, lists and dicts."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _host_tensor(a) -> torch.Tensor:
    """A host array leaf as a CPU tensor (uint32, which torch lacks as
    arithmetic type, widens to int64, as the port's scrambling codes)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    return torch.from_numpy(np.ascontiguousarray(a))


def stream_map(step: Callable, chunks: Iterable, *, device=None,
               prefetch: int = 1, static=None) -> Iterator:
    """Map `step` over host chunks with the copy to the card overlapping
    the compute (tetra_tpu.io.stream.stream_map).

    chunks: an iterable of trees (tuples, lists, dicts) of host arrays.
    Each chunk is put in pinned memory and copied to the device on a
    side CUDA stream, `prefetch` chunks ahead: the copy of chunk
    N+prefetch is queued before step(chunk N) runs, so it rides under
    that chunk's compute. The compute stream waits on each copy's event,
    and each copied tensor is recorded on the compute stream, so the
    allocator does not reuse its memory while the step may still read
    it. Yields step(chunk) in order; results stay on the device.

    static: an optional tree of per-stream constants (scrambling codes,
    filter state, ...) uploaded ONCE; step is then called as
    step(static, chunk). device defaults to the card; on the CPU this is
    a plain map.
    """
    dev = resolve_device(device)
    if static is not None:
        static_d = _tree_map(lambda a: _host_tensor(a).to(dev), static)
        inner = step
        step = lambda c: inner(static_d, c)
    if dev.type != "cuda":
        for c in chunks:
            yield step(_tree_map(_host_tensor, c))
        return
    copy_stream = torch.cuda.Stream(dev)

    def put(c):
        host = _tree_map(lambda a: _host_tensor(a).pin_memory(), c)
        with torch.cuda.stream(copy_stream):
            d = _tree_map(lambda t: t.to(dev, non_blocking=True), host)
            ready = torch.cuda.Event()
            ready.record(copy_stream)
        return d, ready

    def take(entry):
        d, ready = entry
        compute = torch.cuda.current_stream(dev)
        compute.wait_event(ready)
        _tree_map(lambda t: t.record_stream(compute), d)
        return d

    it = iter(chunks)
    buf = []
    for c in it:
        buf.append(put(c))
        if len(buf) == prefetch + 1:
            break
    end = object()
    while buf:
        out = step(take(buf.pop(0)))
        nxt = next(it, end)
        if nxt is not end:
            buf.append(put(nxt))
        yield out
