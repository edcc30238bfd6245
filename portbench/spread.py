"""Runs of one cell in a set, and the spread of each metric over them:
how the bounds in BENCHMARK.json were set (five times the wider of two
sets' spreads, a spread being the distance between the first and third
quartiles of statistics.quantiles(values, n=4) as a share of the
median).

    python3 -m portbench.spread --workload <name> --seeds 1,2,3,4,5,6 --sets 2 \\
        [--seconds S] [--out FILE]

Each run is a process of its own (`python3 -m portbench.run`), the runs
of a set in seed order, the sets one after another with the same seeds.
Prints each run's result line and then one JSON line a set and metric:
median, quartiles and spread, and whether every run was correct.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

from portbench import registry, run


def spread(values: list[float]) -> dict:
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return {"median": statistics.median(values), "q1": q1, "q3": q3,
            "spread": (q3 - q1) / statistics.median(values)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    bench = registry.load_benchmark(run.ROOT)
    seconds = args.seconds or bench["run_seconds"]
    seeds = [int(s) for s in args.seeds.split(",")]
    out = open(args.out, "a") if args.out else None
    for k in range(args.sets):
        results = []
        for s in seeds:
            t = time.time()
            p = subprocess.run(
                [sys.executable, "-m", "portbench.run", "--workload",
                 args.workload, "--seed", str(s), "--seconds", str(seconds),
                 "--trace", str(args.trace)], capture_output=True, text=True,
                cwd=run.ROOT)
            line = p.stdout.strip().splitlines()[-1] if p.stdout.strip() \
                else "{}"
            r = json.loads(line) if line.startswith("{") else {}
            r["_run"] = {"set": k, "seed": s, "rc": p.returncode,
                         "wall_s": time.time() - t}
            if p.returncode:
                r["_run"]["stderr"] = p.stderr[-2000:]
            results.append(r)
            print(json.dumps(r), flush=True)
            if out:
                out.write(json.dumps(r) + "\n")
                out.flush()
        names = sorted({m for r in results for m in r.get("metrics", {})})
        for m in names:
            vals = [r["metrics"][m]["value"] for r in results
                    if m in r.get("metrics", {})]
            if len(vals) >= 2:
                print(json.dumps({"set": k, "metric": m, "n": len(vals),
                                  **spread(vals),
                                  "all_correct": all(r.get("correct")
                                                     for r in results)}),
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
