"""Tracing: spans, counters, per-chunk records, stage taps and device
traces (port of tetra_tpu.utils.trace).

Reference behaviour (SURVEY.md §5): DEBUGP printf tracing compiled in
with -DDEBUG (tetra_common.h:12-16) dumping per-stage type-2/3/4/5 bit
strings, GNU Radio file_sink taps on every demod stage (cqpsk.py
log=True), and external `time` wrapping for benchmarks
(tetra-rx-tests.sh:56-57).

Here, one process-wide level (TETRA_TPU_TRACE, or set_level):

* 0, the default: off. `span` returns one shared null context after one
  check of the level: no clock read, no allocation, no profiler range;
  `count` returns at once; no collector hook is installed.
* 1: spans and counters. Each span reads the host clock
  (perf_counter_ns) at entry and exit and keeps, per (name, parent
  name), its total, its count and its self time (its duration less the
  part its child spans cover, from a stack of open spans). Under a
  running torch.profiler it also opens record_function("tt:<name>"), so
  that each span is a host range on the profiler's timeline with the
  kernels and copies it launched on the same clock (without one, such a
  range records nothing and costs more than the rest of the span). A
  span given a chunk id (or opened inside one that has one) adds (name,
  start, end) to that chunk's record, in a ring of the last CHUNK_RING
  chunks. A gc.callbacks hook records a span "gc" from each
  collection's start to its stop, as a child of whatever span is open.
* 2: level 1 plus tensor taps (`tap`): intermediate tensors recorded,
  or dumped to files, per stage.

Read with spans(), counters(), chunk_records() and timings(); clear with
reset(). device_trace writes a Chrome trace of a block (with level 1 on,
the "tt:" ranges lie above the kernels they launched).
"""
from __future__ import annotations

import contextlib
import functools
import gc
import os
import time
from collections import defaultdict

import numpy as np
import torch

__all__ = ["set_level", "enabled", "span", "spanned", "count", "spans",
           "counters", "chunk_records", "timings", "reset", "tap", "taps",
           "clear_taps", "device_trace", "CHUNK_RING"]

CHUNK_RING = 65_536       # chunks whose records are kept, the newest

_LEVEL = 0
_TAPS: dict[str, list] = defaultdict(list)
_TAP_DIR: str | None = None
_NULL = contextlib.nullcontext()
_clock = time.perf_counter_ns
_record_function = torch.profiler.record_function
_profiling = torch.autograd._profiler_enabled
_STACK: list = []                  # open spans, innermost last
_STATS: dict[tuple, list] = {}     # (name, parent) -> [total, self ns, n]
_COUNTS: dict[str, int] = defaultdict(int)
_CHUNKS: dict[int, list] = {}      # chunk id -> [(name, start, end ns)]


class _Span:
    """One open span (level >= 1); see the module docstring."""
    __slots__ = ("name", "chunk", "t0", "child", "rf")

    def __init__(self, name: str, chunk):
        self.name, self.chunk = name, chunk

    def __enter__(self):
        if self.chunk is None and _STACK:
            self.chunk = _STACK[-1].chunk
        self.child = 0
        self.rf = _record_function("tt:" + self.name) if _profiling() \
            else None
        if self.rf is not None:
            self.rf.__enter__()
        _STACK.append(self)
        self.t0 = _clock()
        return self

    def __exit__(self, *exc):
        t1 = _clock()
        if _STACK and _STACK[-1] is self:
            _STACK.pop()
        elif self in _STACK:
            _STACK.remove(self)
        if self.rf is not None:
            self.rf.__exit__(*exc)
        dur = t1 - self.t0
        parent = _STACK[-1] if _STACK else None
        if parent is not None:
            parent.child += dur
        key = (self.name, parent.name if parent is not None else None)
        st = _STATS.get(key)
        if st is None:
            st = _STATS[key] = [0, 0, 0]
        st[0] += dur
        st[1] += dur - self.child
        st[2] += 1
        if self.chunk is not None:
            rec = _CHUNKS.get(self.chunk)
            if rec is None:
                rec = _CHUNKS[self.chunk] = []
                if len(_CHUNKS) > CHUNK_RING:
                    del _CHUNKS[next(iter(_CHUNKS))]
            rec.append((self.name, self.t0, t1))
        return False


def _on_gc(phase: str, info: dict) -> None:
    """gc.callbacks hook: a span "gc" over each collection."""
    if phase == "start":
        _Span("gc", None).__enter__()
        return
    for sp in reversed(_STACK):
        if sp.name == "gc":
            sp.__exit__(None, None, None)
            return


def set_level(level: int, tap_dir: str | None = None):
    """0 = off, 1 = spans and counters, 2 = spans, counters and tensor
    taps (dumped under tap_dir when given). Installs the collector hook
    at level >= 1 and removes it at 0."""
    global _LEVEL, _TAP_DIR
    _LEVEL = level
    _TAP_DIR = tap_dir
    hooked = _on_gc in gc.callbacks
    if level >= 1 and not hooked:
        gc.callbacks.append(_on_gc)
    elif level < 1 and hooked:
        gc.callbacks.remove(_on_gc)
        _STACK[:] = [sp for sp in _STACK if sp.name != "gc"]


def enabled(level: int = 1) -> bool:
    return _LEVEL >= level


def span(name: str, chunk: int | None = None):
    """Context manager: one span `name` (for chunk id `chunk`, or the
    enclosing span's) at level >= 1; the shared null context when off.
    Entered, it yields the span (None when off)."""
    if _LEVEL < 1:
        return _NULL
    return _Span(name, chunk)


def spanned(name: str):
    """Decorator: each call of the function is one span `name`."""
    def deco(fn):
        @functools.wraps(fn)
        def traced(*a, **k):
            if _LEVEL < 1:
                return fn(*a, **k)
            with _Span(name, None):
                return fn(*a, **k)
        return traced
    return deco


def count(name: str, n: int = 1) -> None:
    """Add n to counter `name` (level >= 1)."""
    if _LEVEL >= 1:
        _COUNTS[name] += n


def spans() -> dict[str, dict]:
    """{name: {total_s, self_s, count, parents {parent name or None:
    seconds of this span under it}}} since the last reset."""
    out: dict[str, dict] = {}
    for (name, parent), (tot, own, n) in _STATS.items():
        s = out.setdefault(name, {"total_s": 0.0, "self_s": 0.0, "count": 0,
                                  "parents": {}})
        s["total_s"] += tot / 1e9
        s["self_s"] += own / 1e9
        s["count"] += n
        s["parents"][parent] = s["parents"].get(parent, 0.0) + tot / 1e9
    return out


def counters() -> dict[str, int]:
    return dict(_COUNTS)


def chunk_records() -> dict[int, list]:
    """{chunk id: [(span name, start s, end s), ...] in the order the
    spans ended}, on time.perf_counter's clock, for the last CHUNK_RING
    chunks."""
    return {c: [(n, s / 1e9, e / 1e9) for n, s, e in rec]
            for c, rec in _CHUNKS.items()}


def timings() -> dict[str, dict]:
    """Per span name: {n, total_s, mean_ms}."""
    return {k: {"n": v["count"], "total_s": v["total_s"],
                "mean_ms": 1e3 * v["total_s"] / v["count"]}
            for k, v in spans().items() if v["count"]}


def reset():
    """Drop every span total, counter and chunk record."""
    _STATS.clear()
    _COUNTS.clear()
    _CHUNKS.clear()


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
def device_trace(logdir: str):
    """torch.profiler capture of the host and (where a card is present)
    the CUDA activity of the block, written to `logdir` as a Chrome
    trace (trace.json, readable by chrome://tracing or Perfetto); with
    tracing on, the program's "tt:" spans are host ranges in it. Yields
    the profiler, whose key_averages() summarise the block."""
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


set_level(int(os.environ.get("TETRA_TPU_TRACE", "0")))
