"""Runs one cell of the port's benchmark once and prints its result.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in setup_s, from this process's start): imports, the
kernel library (build/kernels) and the native walk (native/), the
capture made on the card from the seed and copied to the host as a
receiver gets it, the keystore file, and WARM_PASSES passes of the
cell's own shapes. The window then runs whole passes back to back,
closed loop, until --seconds have passed: each pass builds a fresh
receiver and feeds it one capture in the configuration's calls. With
--trace 0 the result holds the cell's end-to-end metrics; with --trace 1
the window runs under synchronising spans and is followed by a profiled
sub-window, and the result holds the cell's per-layer metrics. After the
window and the reading of the peak memory, one more pass of the same
receiver calls (the check pass) runs with its outputs recorded; they
are compared with the plain reference, and every pass of the window is
held to it (check.py). The last line of standard output is the result,
one JSON object.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402

import numpy as np  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "tetra_tpu")
PROFILED_PASSES = 2
WARM_PASSES = 2


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is jax,
    jaxlib, flax or the JAX package."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def set_cache_dirs(root: pathlib.Path) -> None:
    """Every build or kernel cache a library may open, at fixed paths
    inside the checkout (the port's kernels build into build/kernels and
    its walk into native/ by themselves)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / "build" / "portbench" / sub)


def _copied(x):
    """A copy of a recorded output, so that a buffer the program reuses
    later cannot change it."""
    if isinstance(x, (tuple, list)):
        return type(x)(_copied(v) for v in x)
    if isinstance(x, dict):
        return {k: _copied(v) for k, v in x.items()}
    return x.clone() if hasattr(x, "clone") else \
        (x.copy() if hasattr(x, "copy") else x)


def recorded_pass(cell: "Cell") -> dict:
    """One pass of `cell` (Cell.one_pass) with copies of what its timed
    path produced: each front-end call's (input samples, base, channels
    at the demod rate), each demod call's phasors before the slicer, the
    slicer's hard bits or soft values, and each collected chunk's dict.
    Returns the record check.evaluate reads."""
    from portbench.check import pass_summary
    from portbench.spans import Patches
    fe, dm, dec, collects = [], [], [], []

    def pfb(fn):
        def w(re, im, *a, **k):
            out = fn(re, im, *a, **k)
            fe.append((int(re.shape[0]), None, _copied(out)))
            return out
        return w

    def mixer(fn):
        def w(re, im, offsets, fs, *a, **k):
            out = fn(re, im, offsets, fs, *a, **k)
            fe.append((int(re.shape[-1]), int(k.get("base", 0)),
                       _copied(out)))
            return out
        return w

    def kept(into):
        def make(fn):
            def w(*a, **k):
                out = fn(*a, **k)
                into.append(_copied(out))
                return out
            return w
        return make

    def collect(fn):
        def w(self_, h):
            d = fn(self_, h)
            collects.append(_copied(d))
            return d
        return w

    p = Patches()
    try:
        p.wrap(("tetra_tpu_torch.phy.pfb", "pfb_to_demod_rate_ri"), pfb)
        p.wrap(("tetra_tpu_torch.phy.channelizer", "channelize_ri"), mixer)
        p.wrap(("tetra_tpu_torch.phy.dqpsk", "_stream_phasors"), kept(dm))
        for slicer in ("demodulate_hard_ri", "demodulate_soft_ri"):
            p.wrap(("tetra_tpu_torch.phy.dqpsk", slicer), kept(dec))
        p.wrap(("tetra_tpu_torch.fastpath", "FastChunkPipeline.collect"),
               collect)
        mrx = cell.one_pass()["mrx"]
    finally:
        p.restore()
    return {"fe": fe, "dm": dm, "dec": dec, "collects": collects,
            "carriers": mrx.carriers, "native_events": mrx.native_events}


class Cell:
    """One cell's receiver passes over its capture."""

    def __init__(self, cfg: dict, cap: dict, ks_path: str | None, device):
        import torch
        self.cfg, self.cap, self.ks_path = cfg, cap, ks_path
        self.device = torch.device(device)
        self.sync = (torch.cuda.synchronize if self.device.type == "cuda"
                     else (lambda: None))
        host = cap["samples_host"]
        from portbench.check import cuts_of
        if cfg["format"] == "u8":
            from tetra_tpu_torch.io.sdr import RtlTcpSource
            cuts = cuts_of(cfg, len(host) // 2)
            conv = RtlTcpSource._to_complex
            self.calls = [("iq", host[2 * a:2 * b], conv, False)
                          for a, b in zip(cuts, cuts[1:])]
            self.calls.append(("iq", None, None, True))
        else:
            cuts = cuts_of(cfg, len(host))
            self.calls = [("iq4c", host[a:b], None, k == len(cuts) - 2)
                          for k, (a, b) in enumerate(zip(cuts, cuts[1:]))]
        self.chunks = sum(c[1] is not None for c in self.calls)

    def receiver(self):
        from tetra_tpu_torch.rx_multi import MultiCarrierReceiver
        cfg = self.cfg
        if cfg["front_end"] == "pfb":
            n = int(cfg["n_chan"])
            mrx = MultiCarrierReceiver(
                [], fs=float(cfg["fs"]), pfb_channels=np.arange(n), n_chan=n,
                keystore_path=self.ks_path, control_plane="native",
                demod=cfg["demod"], device=self.device)
        else:
            mrx = MultiCarrierReceiver(
                self.cap["offsets_hz"], fs=float(cfg["fs"]),
                keystore_path=self.ks_path, control_plane="native",
                demod=cfg["demod"], device=self.device)
        if mrx.pipeline_depth != int(cfg["pipeline_depth"]):
            raise RuntimeError("the receiver's pipeline depth is not the "
                               "configuration's")
        return mrx

    def one_pass(self) -> dict:
        """One capture through a fresh receiver: {'t0', 't1', 'calls'
        [(start, end, events out after it, submits a chunk)], 'mrx'}."""
        from torch.profiler import record_function
        t0 = time.perf_counter()
        with record_function("pb:receiver"):
            mrx = self.receiver()
        calls = []
        for kind, data, conv, final in self.calls:
            s = time.perf_counter()
            with record_function("pb:call"):
                if kind == "iq4c":
                    mrx.process_iq4c(data, final=final)
                elif data is None:
                    mrx.process_iq(np.zeros(0, np.complex64), final=True)
                else:
                    mrx.process_iq(conv(data), final=final)
            e = time.perf_counter()
            calls.append((s, e, len(mrx.native_events), data is not None))
        self.sync()
        return {"t0": t0, "t1": time.perf_counter(), "calls": calls,
                "mrx": mrx}


@contextlib.contextmanager
def keystore(cfg: dict):
    """The configuration's keystore lines in a temporary file (under the
    process's TMPDIR); yields its path, or None without a keystore."""
    lines = cfg.get("keystore")
    if not lines:
        yield None
        return
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "keys.txt")
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        yield path


def run_window(cell: Cell, seconds: float) -> dict:
    """Passes back to back until `seconds` have passed since the first
    began; the last pass is the first to end at or after that. Each
    pass's per-carrier results are summarised and its receiver dropped
    before the next begins."""
    from portbench.check import pass_summary
    passes, summaries = [], []
    w0 = time.perf_counter()
    while True:
        p = cell.one_pass()
        mrx = p.pop("mrx")
        summaries.append(pass_summary(mrx.carriers, mrx.native_events))
        del mrx
        passes.append(p)
        if p["t1"] - w0 >= seconds:
            break
    return {"passes": passes, "summaries": summaries, "w0": w0,
            "w1": passes[-1]["t1"]}


def card_name() -> str:
    import torch
    return torch.cuda.get_device_name(0)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(root: pathlib.Path, bench: dict, w: dict, cfg: dict, mix: dict,
             seed: int, seconds: float, trace: bool, device,
             out=sys.stdout) -> int:
    """Set-up, window, check; prints the result line. Returns the exit
    code."""
    import torch
    from portbench import capture, check, metrics, registry, spans
    set_cache_dirs(root)
    dev = torch.device(device)
    if dev.type == "cuda":
        from tetra_tpu_torch import kernels
        kernels.lib()
    from tetra_tpu_torch.umac import native_exec  # noqa: F401  builds native/
    cap = capture.make_capture(cfg, mix, seed, dev)
    cap["samples_host"] = cap["samples"].cpu().numpy()
    e2e = registry.cell_metrics(bench, w["name"], "end_to_end")
    per_layer = registry.cell_metrics(bench, w["name"], "per_layer")
    readers = {m["name"]: registry.load_reader(m["name"])
               for m in per_layer} if trace else {}
    with keystore(cfg) as ks_path:
        cell = Cell(cfg, cap, ks_path, dev)
        for _ in range(WARM_PASSES):
            cell.one_pass()
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - T_START
        sp = None
        if trace:
            span_spec, call_spec = {}, {}
            for r in readers.values():
                span_spec.update(getattr(r, "SPANS", {}))
                call_spec.update(getattr(r, "CALLS", {}))
            sp = spans.Spans(span_spec, cell.sync)
            sp.on = True
        win = run_window(cell, seconds)
        if sp is not None:
            sp.on = False
        peak = (torch.cuda.max_memory_allocated() if dev.type == "cuda"
                else 0)
        prof = None
        if trace:
            sp.restore()
            if dev.type == "cuda":
                prof = profiled_window(cell, {**span_spec, **call_spec}, dev)
        record = recorded_pass(cell)
        summaries = win["summaries"]
        t_check = time.perf_counter()
        found = forbidden_modules()
        if found:
            print("portbench: loaded " + ", ".join(found), file=sys.stderr)
            return 3
        numbers, compared = check.evaluate(cfg, cap, record, summaries,
                                           seed, ks_path, dev)
    correct = check.verdict(numbers)
    check_s = time.perf_counter() - t_check
    passes = win["passes"]
    window_s = win["w1"] - win["w0"]
    attempted = cell.chunks * len(passes)
    bad_passes = (len(passes) if not correct
                  else numbers["passes_differing"])
    res_metrics, carriers_rt = {}, None
    if trace:
        ctx = TraceContext(sp, prof, cell.chunks * len(passes),
                           sum(p["t1"] - p["t0"] for p in passes))
        for m in per_layer:
            v = readers[m["name"]].read(ctx)
            if v is not None:
                res_metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        lat = [x for p in passes for x in metrics.chunk_latencies(p["calls"])]
        values = {
            "carriers_rt": metrics.carriers_rt(int(cfg["carriers"]),
                                               cap["stream_s"], len(passes),
                                               window_s),
            "chunk_p95_ms": metrics.p95(lat) * 1e3,
            "setup_s": setup_s}
        for m in e2e:
            res_metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
        carriers_rt = values["carriers_rt"]
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": card_name() if dev.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": attempted,
              "failed": bad_passes * cell.chunks,
              "metrics": res_metrics, "device": device_info}
    if prof is not None:
        device_info["busy_s"] = prof["busy_s"]
        device_info["window_s"] = prof["window_s"]
        result["breakdown"] = {"device_ops": prof["device_ops"],
                               "idle_gaps": prof["idle_gaps"]}
    pass_q = np.quantile([p["t1"] - p["t0"] for p in passes],
                         [0.1, 0.5, 0.9]).tolist()
    result["window"] = {"passes": len(passes), "seconds": window_s,
                        "pass_s_q10_q50_q90": pass_q, "check_s": check_s,
                        "carriers_rt": carriers_rt,
                        "chunks": attempted, "card": power_limit()
                        if dev.type == "cuda" else "cpu"}
    result["compared"] = compared
    result["check"] = {k: {"value": numbers[k], "limit": check.LIMITS[k]}
                       for k in check.LIMITS}
    for k in check.LIMITS:
        print(f"check {k} {numbers[k]!r} limit {check.LIMITS[k]!r}",
              file=sys.stderr)
    print(json.dumps(result), file=out, flush=True)
    return 0


class TraceContext:
    """What a per-layer reader reads: span totals (seconds) and call
    counts of the traced window, its chunks and pass seconds, and the
    profiled sub-window's reduction (`prof`: busy_s, window_s, kernels,
    annotated, args)."""

    def __init__(self, sp, prof: dict, chunks: int, pass_s: float):
        self.spans = dict(sp.total) if sp is not None else {}
        self.span_calls = dict(sp.calls) if sp is not None else {}
        self.prof = prof
        self.chunks = chunks
        self.pass_s = pass_s

    def span_ms(self, name: str):
        """A span's milliseconds a chunk, or None when it never ran."""
        if not self.span_calls.get(name):
            return None
        return self.spans[name] / self.chunks * 1e3


def profiled_window(cell: Cell, call_spec: dict, dev) -> dict:
    """PROFILED_PASSES passes under torch.profiler, with annotations
    around the readers' SPANS and CALLS targets (each pass already marks
    its receiver's construction and each call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from portbench import spans
    ann = spans.Annotations(call_spec)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if dev.type == "cuda" else [])
    with profile(activities=acts) as prof:
        cell.sync()
        t0 = time.perf_counter()
        for _ in range(PROFILED_PASSES):
            cell.one_pass()
        cell.sync()
        t1 = time.perf_counter()
    ann.restore()
    out = spans.reduce_profile(prof, t1 - t0)
    out["args"] = dict(ann.args)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from portbench import registry
    bench = registry.load_benchmark(ROOT)
    w = registry.cell(bench, args.workload)
    cfg = registry.load_config(ROOT, w["config_entry"])
    mix = registry.load_traffic(w["traffic"])
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(w["chips"]):
        print(f"portbench: the cell needs {w['chips']} CUDA card(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 2
    return run_cell(ROOT, bench, w, cfg, mix, args.seed, args.seconds,
                    bool(args.trace), "cuda")


if __name__ == "__main__":
    sys.exit(main())
