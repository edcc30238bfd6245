"""The benchmark's own instrumentation of the program, from outside it.

- `Spans`: synchronising wrappers around named program functions (a
  synchronize before and after each call, so a span's host-clock time
  holds its device work; tools/profile_torch_prod.py's `timed`), summed
  by span name over the traced window.
- `Annotations`: torch.profiler ranges around named program functions,
  with each call's arguments kept, for a profiled sub-window without
  synchronisation.
- `reduce_profile`: from a torch.profiler run, the device's busy time
  (the union of its kernel, copy and set intervals), kernel time by
  name, each annotated call's device time, and the longest idle gaps of
  the device named by what the host was running during each
  (tools/profile_torch_prod.py's `device_profile`, with the union in
  place of a sum).
"""
from __future__ import annotations

import collections
import functools
import heapq
import importlib
import time

import torch


def _resolve(target: tuple[str, str]):
    """(module path, attribute path) -> (owner object, attribute name)."""
    mod, attr = target
    owner = importlib.import_module(mod)
    parts = attr.split(".")
    for p in parts[:-1]:
        owner = getattr(owner, p)
    return owner, parts[-1]


class Patches:
    """Named program attributes replaced by wrappers, and put back by
    `restore`."""

    def __init__(self):
        self._saved = []

    def wrap(self, target, make):
        owner, name = _resolve(target)
        fn = owner.__dict__[name] if isinstance(owner, type) \
            else getattr(owner, name)
        self._saved.append((owner, name, fn))
        setattr(owner, name, functools.wraps(fn)(make(fn)))

    def restore(self):
        for owner, name, fn in reversed(self._saved):
            setattr(owner, name, fn)
        self._saved.clear()


class Spans(Patches):
    """Synchronised host-clock spans: spans {name: [targets]}; a target
    named by several spans counts in each. `on` gates the counting."""

    def __init__(self, spans: dict, sync):
        super().__init__()
        self.total = collections.defaultdict(float)
        self.calls = collections.defaultdict(int)
        self.on = False
        names = collections.defaultdict(list)
        for name, targets in spans.items():
            for t in targets:
                names[tuple(t)].append(name)
        for target, ns in names.items():
            def make(fn, ns=tuple(ns)):
                def wrapper(*a, **k):
                    if not self.on:
                        return fn(*a, **k)
                    sync()
                    t0 = time.perf_counter()
                    out = fn(*a, **k)
                    sync()
                    dt = time.perf_counter() - t0
                    for n in ns:
                        self.total[n] += dt
                        self.calls[n] += 1
                    return out
                return wrapper
            self.wrap(target, make)


class Annotations(Patches):
    """record_function ranges "pb:<name>" around the targets {name:
    [targets]}, with each call's (args, kwargs) kept in order."""

    def __init__(self, calls: dict):
        super().__init__()
        self.args = collections.defaultdict(list)
        for name, targets in calls.items():
            for t in targets:
                def make(fn, name=name):
                    def wrapper(*a, **k):
                        self.args[name].append((a, k))
                        with torch.profiler.record_function("pb:" + name):
                            return fn(*a, **k)
                    return wrapper
                self.wrap(tuple(t), make)


def _dev_time_us(e) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(e, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def reduce_profile(prof, window_s: float) -> dict:
    """{'busy_s', 'window_s', 'kernels' {name: (seconds, count)},
    'annotated' {name: [device seconds per call, in order]},
    'device_ops' [[name, s]] top 10, 'idle_gaps' [[name, s]] top 10}."""
    from torch.autograd import DeviceType
    evs = list(prof.events())
    dev, host = [], []
    for e in evs:
        if e.device_type != DeviceType.CUDA:
            host.append(e)
        elif not e.name.startswith("pb:"):
            # the annotations' own device-side ranges span the kernels
            # launched inside them, idle gaps included: not device work
            dev.append(e)
    kernels = collections.defaultdict(lambda: [0.0, 0])
    iv = []
    for e in dev:
        s, t = e.time_range.start, e.time_range.end
        iv.append((s, t))
        kernels[e.name][0] += (t - s) / 1e6
        kernels[e.name][1] += 1
    iv.sort()
    busy, merged = 0.0, []
    for s, t in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) / 1e6
    annotated = collections.defaultdict(list)
    for e in sorted(host, key=lambda e: e.time_range.start):
        if e.name.startswith("pb:"):
            annotated[e.name[3:]].append(_dev_time_us(e) / 1e6)
    # idle gaps between device intervals, named by the innermost host
    # range open at the gap's midpoint (a "pb:" annotation first): a
    # sweep over the midpoints with a max-heap by start of the ranges
    # begun so far, dropping those ended before the midpoint
    gaps = collections.defaultdict(float)
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in host)
    heaps = ([], [])
    j = 0
    for (_, t0), (s1, _) in zip(merged, merged[1:]):
        mid = (t0 + s1) / 2
        while j < len(spans) and spans[j][0] <= mid:
            s, t, name = spans[j]
            heapq.heappush(heaps[not name.startswith("pb:")], (-s, t, name))
            j += 1
        label = "host"
        for h in heaps:
            while h and h[0][1] < mid:
                heapq.heappop(h)
            if h:
                label = h[0][2]
                break
        gaps[label] += (s1 - t0) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                     [:10]]
    return {"busy_s": busy, "window_s": window_s,
            "kernels": {k: tuple(v) for k, v in kernels.items()},
            "annotated": dict(annotated),
            "device_ops": top({k[:120]: v[0] for k, v in kernels.items()}),
            "idle_gaps": top(gaps)}
