#!/usr/bin/env python3
"""Times prod-1024 (the production receive path: 1024 carriers of
companded wideband IQ, 4 chunks, native control plane, keystore) on the
card for one checkout of the port, for comparing two trees on one card
in turns.

    python3 tetra_tpu_torch/bench_prod.py [--repo PATH] [--passes N] [--snr8]

Run it by path, not with -m: the tree named by --repo must be the first
`tetra_tpu_torch` that Python imports.

--repo names the checkout whose `tetra_tpu_torch` is imported and built
(default: the one holding this script), so that a parent tree unpacked
beside this one runs under the same script: run parent, change, change,
parent in one call. Prints one JSON line: the card (nvidia-smi name and
power limit), the tree, `wall_s` of one warm and then N timed passes
(prod_fixture.run_receiver; the clock stops after a synchronize), the
decode counts, and a sha256 digest of every carrier's (bursts, slots,
crc_ok, crc_wrong, TDMA time, cell, scrambling code) and of the native
plane's concatenated event arrays, which two trees must share when a
change keeps bundles, events and stats; with --snr8 the same for one
pass of snr8-1024 (demod="soft").
"""
import argparse
import hashlib
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent
N_CAR, N_CHUNKS = 1024, 4


def digest(mrx) -> dict:
    """sha256 of the receiver's per-carrier state and of its events."""
    import numpy as np
    st = np.asarray([(c.stats.bursts, c.stats.slots, c.stats.crc_ok,
                      c.stats.crc_wrong, c.time.tn, c.time.fn, c.time.mn,
                      c.colour_code, c.mcc, c.mnc, c.scramb_init)
                     for c in mrx.carriers], np.int64)
    h = hashlib.sha256()
    for key in ("carrier", "kind", "a", "b", "c", "d", "payload"):
        h.update(np.ascontiguousarray(np.concatenate(
            [e[key] for e in mrx.native_events])).tobytes())
    return {"stats_sha256": hashlib.sha256(st.tobytes()).hexdigest(),
            "events_sha256": h.hexdigest(),
            "crc_ok": int(st[:, 2].sum()), "crc_err": int(st[:, 3].sum())}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=str(ROOT))
    ap.add_argument("--passes", type=int, default=5)
    ap.add_argument("--snr8", action="store_true")
    args = ap.parse_args()
    repo = pathlib.Path(args.repo).resolve()
    # Python put this file's directory (the package) first on the path:
    # replace it with the tree to time, so that no module of the package
    # shadows a top-level name and that tree's package is the one found
    sys.path[0] = str(repo)
    import torch
    if not torch.cuda.is_available():
        print("bench_prod: no CUDA card", file=sys.stderr)
        return 2
    from tetra_tpu_torch import kernels, prod_fixture
    if not pathlib.Path(kernels.__file__).resolve().is_relative_to(repo):
        raise RuntimeError(f"imported {kernels.__file__}, not from {repo}")
    from tetra_tpu_torch.fastpath import FastChunkPipeline
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    kernels.lib()
    res = {"repo": str(repo), "card": card,
           "early_fetch": hasattr(FastChunkPipeline, "prefetch")}
    fx = prod_fixture.load()
    bits, _ = prod_fixture.mixed_bits(N_CAR, 0.1, fx)
    packed = prod_fixture.wideband_capture(bits)
    del bits
    with prod_fixture.keystore_file() as ks:
        walls = []
        for _ in range(args.passes + 1):
            mrx, wall = prod_fixture.run_receiver(packed, N_CAR, ks, dev,
                                                  N_CHUNKS)
            walls.append(wall)
    res["prod"] = {"warm_s": walls[0], "wall_s": walls[1:],
                   "realtime_carriers": [
                       N_CAR * packed.size / (25_000.0 * N_CAR) / w
                       for w in walls[1:]], **digest(mrx)}
    if args.snr8:
        t0 = time.perf_counter()
        snr8 = prod_fixture.snr8_capture(N_CAR)
        mrx, wall = prod_fixture.run_receiver(snr8, N_CAR, None, dev,
                                              N_CHUNKS, demod="soft")
        res["snr8"] = {"wall_s": wall, "build_s": time.perf_counter() - t0,
                       **digest(mrx)}
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
