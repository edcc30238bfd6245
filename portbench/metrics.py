"""The end-to-end arithmetic, taken over the whole window."""
from __future__ import annotations

import math


def carriers_rt(n_carriers: int, stream_s: float, captures: int,
                window_s: float) -> float:
    """Carriers decoded in real time: carriers x stream seconds of every
    capture finished in the window, over the window's seconds."""
    return n_carriers * stream_s * captures / window_s


def chunk_latencies(calls: list[tuple]) -> list[float]:
    """Seconds from the start of the call that submits each chunk to the
    end of the first call after which that chunk's events are out.
    calls: per call of one pass (start, end, events out after it,
    submits a chunk). Chunk i is out once the event count exceeds i."""
    lat = []
    submitted = [c[0] for c in calls if c[3]]
    for i, start in enumerate(submitted):
        done = next(c[1] for c in calls if c[2] > i)
        lat.append(done - start)
    return lat


def p95(values: list[float]) -> float:
    """95th percentile, linear between order statistics (the (n-1) p
    rank)."""
    xs = sorted(values)
    if not xs:
        return math.nan
    r = 0.95 * (len(xs) - 1)
    lo = math.floor(r)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (r - lo)
