"""The program's own spans over one cell (tetra_tpu_torch.utils.trace):
the per-layer numbers that split `host_rest_ms`, read without the
benchmark's synchronising wrappers.

    python3 -m portbench.program_trace --workload <name> --seed <n> \\
        --seconds <s>

Set-up as portbench.run (the capture from the seed, the keystore,
run.WARM_PASSES passes). Then, closed loop, whole passes:

1. a wrapped window, a fifth of --seconds: the `walk_ms` reader's
   synchronising wrappers, so that parse_ms + native_walk_ms can be set
   beside walk_ms;
2. the program window, two fifths of --seconds: passes with tracing off
   and on in turn (trace.set_level; no wrapper, no profiler). Every
   host metric (`host_metrics`) comes from the traced passes; the
   on-cost is the median over pairs of a traced pass's time over the
   untraced pass's before it, less 1;
3. run.PROFILED_PASSES passes under torch.profiler with tracing on: the
   device time of the kernels and copies launched inside each "tt:"
   range (`device_metrics`), the device's idle share, and its idle
   time split by the innermost "tt:" range open on the host.

Tracing is off again at the end. No check is made: the cell's
`correct` is portbench.run's. Prints one JSON line. Nothing here is
read by portbench.run; its `--trace 1` lines do not carry these metrics
(PERF.md §7 names what run.py would need).
"""
from __future__ import annotations

import argparse
import collections
import json
import statistics
import sys
import time

import numpy as np

from portbench import run

SPAN_METRICS = {           # metric -> span whose total it reads
    "rx_build_ms": "rx.build",
    "gc_ms": "gc",
    "dispatch_ms": "chunk.submit",
    "fetch_wait_ms": "chunk.fetch_wait",
    "egress_ms": "chunk.egress",
    "parse_ms": "chunk.parse",
    "native_walk_ms": "chunk.walk",
}
DEVICE_METRICS = {         # metric -> "tt:" range whose device time it reads
    "frontend_dev_ms": "chunk.frontend",
    "sync_dev_ms": "chunk.sync",
    "fec_dev_ms": "chunk.fec",
}
TOP_LEVEL = ("rx.build", "call", "gc")


def quantiles(xs) -> list[float]:
    return np.quantile(xs, [0.1, 0.5, 0.9]).tolist()


def program_window(cell: "run.Cell", seconds: float) -> dict:
    """Pairs of passes, the program's tracing off then on, until
    `seconds` have passed: the traced passes' spans, counters and chunk
    records, their chunks, and both sides' pass seconds (`pass_s` traced,
    `base_s` untraced)."""
    from tetra_tpu_torch.utils import trace
    trace.reset()
    base, traced = [], []
    w0 = time.perf_counter()
    try:
        while not traced or time.perf_counter() - w0 < seconds:
            for level, side in ((0, base), (1, traced)):
                trace.set_level(level)
                p = cell.one_pass()
                side.append(p["t1"] - p["t0"])
                del p
    finally:
        trace.set_level(0)
    return {"spans": trace.spans(), "counters": trace.counters(),
            "chunk_records": trace.chunk_records(),
            "chunks": cell.chunks * len(traced),
            "pass_s": traced, "base_s": base}


def host_metrics(pw: dict) -> dict:
    """The host metrics of a program window, ms a chunk (rerun_share in
    %), and `coverage`: the top-level spans' time over the passes'."""
    sp, chunks = pw["spans"], pw["chunks"]
    if not chunks or "call" not in sp:
        return {}
    ms = lambda s: s / chunks * 1e3
    out = {m: ms(sp[n]["total_s"]) if n in sp else 0.0
           for m, n in SPAN_METRICS.items()}
    out["call_self_ms"] = ms(sp["call"]["self_s"])
    out["rerun_share"] = 100.0 * pw["counters"].get("chunk.reruns", 0) \
        / chunks
    waits = []
    for rec in pw["chunk_records"].values():
        end = [e for n, _, e in rec if n == "chunk.submit"]
        start = [s for n, s, _ in rec if n == "chunk.fetch_wait"]
        if end and start:
            waits.append(min(start) - max(end))
    out["chunk_queue_ms"] = 1e3 * statistics.fmean(waits) if waits else None
    top = sum(sp[n]["parents"].get(None, 0.0) for n in TOP_LEVEL if n in sp)
    out["coverage"] = top / sum(pw["pass_s"])
    return out


def span_table(pw: dict) -> dict:
    """Every span: total and self ms a chunk, count, and ms a chunk
    under each parent."""
    c = pw["chunks"]
    return {n: {"total_ms": s["total_s"] / c * 1e3,
                "self_ms": s["self_s"] / c * 1e3, "count": s["count"],
                "parents": {str(p): v / c * 1e3
                            for p, v in s["parents"].items()}}
            for n, s in sorted(pw["spans"].items())}


def _dev_us(e) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(e, attr, None)
        if v is not None:
            return float(v)
    return 0.0


def device_metrics(prof, chunks: int, window_s: float) -> dict:
    """From a torch.profiler run over the program with tracing on: the
    device ms a chunk of the kernels and copies launched inside each
    DEVICE_METRICS range (and its children), the device's busy seconds
    (the union of its kernel, copy and set intervals) and idle share,
    and its idle seconds split by the innermost "tt:" range open on the
    host at each instant ("host" where none is)."""
    from torch.autograd import DeviceType
    dev_us = collections.defaultdict(float)
    iv, ranges = [], []
    for e in prof.events():
        tagged = e.name.startswith(("tt:", "pb:"))
        if e.device_type == DeviceType.CUDA:
            if not tagged:       # annotations' device-side ranges: no work
                iv.append((e.time_range.start, e.time_range.end))
        elif e.name.startswith("tt:"):
            dev_us[e.name[3:]] += _dev_us(e)
            ranges.append((e.time_range.start, e.time_range.end,
                           e.name[3:]))
    iv.sort()
    merged = []
    for s, t in iv:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], t)
        else:
            merged.append([s, t])
    busy = sum(t - s for s, t in merged) / 1e6
    gaps = collections.defaultdict(float)
    for (_, t0), (s1, _) in zip(merged, merged[1:]):
        inside = [r for r in ranges if r[0] < s1 and r[1] > t0]
        cuts = sorted({t0, s1, *(x for r in inside for x in r[:2]
                                 if t0 < x < s1)})
        for a, b in zip(cuts, cuts[1:]):
            mid = (a + b) / 2
            inner = max((r for r in inside if r[0] <= mid <= r[1]),
                        key=lambda r: r[0], default=None)
            gaps[inner[2] if inner else "host"] += (b - a) / 1e6
    out = {m: dev_us[n] / 1e3 / chunks if dev_us.get(n) else None
           for m, n in DEVICE_METRICS.items()}
    out["busy_s"] = busy
    out["window_s"] = window_s
    out["device_idle_share"] = (100.0 * (1 - busy / window_s)
                                if busy > 0 else None)
    out["idle_gaps"] = [[k, v] for k, v in
                        sorted(gaps.items(), key=lambda kv: -kv[1])[:12]]
    return out


def profiled_passes(cell: "run.Cell", dev) -> dict:
    """run.PROFILED_PASSES passes under torch.profiler with the program's
    tracing on; device_metrics of them."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from tetra_tpu_torch.utils import trace
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if torch.device(dev).type == "cuda"
                                     else [])
    trace.set_level(1)
    try:
        with profile(activities=acts) as prof:
            cell.sync()
            t0 = time.perf_counter()
            for _ in range(run.PROFILED_PASSES):
                cell.one_pass()
            cell.sync()
            t1 = time.perf_counter()
    finally:
        trace.set_level(0)
        trace.reset()
    return device_metrics(prof, run.PROFILED_PASSES * cell.chunks, t1 - t0)


def wrapped_walk_ms(cell: "run.Cell", seconds: float):
    """walk_ms as its reader reads it (synchronising wrappers around the
    bundle parse and the native walk) over a window of `seconds`."""
    from portbench import registry, spans
    sp = spans.Spans(registry.load_reader("walk_ms").SPANS, cell.sync)
    sp.on = True
    try:
        win = run.run_window(cell, seconds)
    finally:
        sp.on = False
        sp.restore()
    chunks = cell.chunks * len(win["passes"])
    return sp.total["walk"] / chunks * 1e3 if sp.calls["walk"] else None


def trace_cell(cfg: dict, mix: dict, seed: int, seconds: float,
               device) -> dict:
    """The four segments of the module docstring over one cell."""
    import torch
    from portbench import capture
    run.set_cache_dirs(run.ROOT)
    dev = torch.device(device)
    if dev.type == "cuda":
        from tetra_tpu_torch import kernels
        kernels.lib()
    from tetra_tpu_torch.umac import native_exec  # noqa: F401  builds native/
    cap = capture.make_capture(cfg, mix, seed, dev)
    cap["samples_host"] = cap["samples"].cpu().numpy()
    part = seconds / 5
    with run.keystore(cfg) as ks_path:
        cell = run.Cell(cfg, cap, ks_path, dev)
        for _ in range(run.WARM_PASSES):
            cell.one_pass()
        walk_ms = wrapped_walk_ms(cell, part)
        pw = program_window(cell, 2 * part)
        prof = profiled_passes(cell, dev)
    base_s = pw["base_s"]
    host = host_metrics(pw)
    fe = prof.pop("frontend_dev_ms")
    prof["frontend_dev_ms." + ("pfb" if cfg["front_end"] == "pfb"
                               else "mixer")] = fe
    return {
        "untraced": {"passes": len(base_s),
                     "pass_s_q10_q50_q90": quantiles(base_s)},
        "wrapped": {"walk_ms": walk_ms},
        "program": {"passes": len(pw["pass_s"]), "chunks": pw["chunks"],
                    "pass_s_q10_q50_q90": quantiles(pw["pass_s"]),
                    "metrics": host, "counters": pw["counters"],
                    "spans": span_table(pw)},
        "profiled": prof,
        "on_cost": statistics.median(
            t / b for b, t in zip(base_s, pw["pass_s"])) - 1.0,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    from portbench import registry
    bench = registry.load_benchmark(run.ROOT)
    w = registry.cell(bench, args.workload)
    cfg = registry.load_config(run.ROOT, w["config_entry"])
    mix = registry.load_traffic(w["traffic"])
    import torch
    if not torch.cuda.is_available():
        print("portbench.program_trace: no CUDA card", file=sys.stderr)
        return 2
    res = trace_cell(cfg, mix, args.seed, args.seconds, "cuda")
    found = run.forbidden_modules()
    if found:
        print("portbench: loaded " + ", ".join(found), file=sys.stderr)
        return 3
    res = {"workload": args.workload, "seed": args.seed,
           "card": run.power_limit(), **res}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
