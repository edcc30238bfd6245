"""Tracing / stage taps / timing instrumentation (port of
tetra_tpu.utils.trace).

Reference behaviour (SURVEY.md §5): DEBUGP printf tracing compiled in
with -DDEBUG (tetra_common.h:12-16) dumping per-stage type-2/3/4/5 bit
strings, GNU Radio file_sink taps on every demod stage (cqpsk.py
log=True), and external `time` wrapping for benchmarks
(tetra-rx-tests.sh:56-57).

Here: a process-wide trace level (TETRA_TPU_TRACE), per-stage tensor
taps that record (or dump to files) intermediate bit tensors, a
lightweight timer registry, and torch.profiler capture of device traces
in place of the JAX package's jax.profiler passthrough.
"""
from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import numpy as np

__all__ = ["set_level", "enabled", "debugp", "tap", "taps", "clear_taps",
           "timer", "timings", "clear_timings", "device_trace"]

_LEVEL = int(os.environ.get("TETRA_TPU_TRACE", "0"))
_TAPS: dict[str, list] = defaultdict(list)
_TAP_DIR: str | None = None
_TIMINGS: dict[str, list] = defaultdict(list)


def set_level(level: int, tap_dir: str | None = None):
    """0 = off, 1 = stage logs, 2 = stage logs + tensor taps."""
    global _LEVEL, _TAP_DIR
    _LEVEL = level
    _TAP_DIR = tap_dir


def enabled(level: int = 1) -> bool:
    return _LEVEL >= level


def debugp(fmt: str, *args):
    """DEBUGP analogue: stage logging at level >= 1."""
    if _LEVEL >= 1:
        print(fmt % args if args else fmt)


def tap(stage: str, tensor, meta=None):
    """Record an intermediate tensor (numpy, or a torch tensor on any
    device) under a stage name (level >= 2).

    The analogue of the reference's per-stage type-N dumps
    (tetra_lower_mac.c:175-255) and GNU Radio file_sink taps."""
    if _LEVEL < 2:
        return
    if hasattr(tensor, "detach"):
        tensor = tensor.detach().cpu().numpy()
    arr = np.asarray(tensor)
    _TAPS[stage].append((arr, meta))
    if _TAP_DIR:
        idx = len(_TAPS[stage]) - 1
        np.save(os.path.join(_TAP_DIR, f"{stage}_{idx}.npy"), arr)


def taps(stage: str) -> list:
    return _TAPS.get(stage, [])


def clear_taps():
    _TAPS.clear()


@contextlib.contextmanager
def timer(name: str):
    """Wall-clock section timer; aggregated in timings()."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _TIMINGS[name].append(time.perf_counter() - t0)


def timings() -> dict[str, dict]:
    return {k: {"n": len(v), "total_s": sum(v), "mean_ms": 1e3 * sum(v) / len(v)}
            for k, v in _TIMINGS.items() if v}


def clear_timings():
    _TIMINGS.clear()


@contextlib.contextmanager
def device_trace(logdir: str):
    """torch.profiler capture of the host and (where a card is present)
    the CUDA activity of the block, written to `logdir` as a Chrome
    trace (trace.json, readable by chrome://tracing or Perfetto).
    Yields the profiler, whose key_averages() summarise the block."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
