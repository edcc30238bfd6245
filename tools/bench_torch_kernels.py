#!/usr/bin/env python3
"""Times the port's kernels K1, K2, K4, K5 (with K7's stage bisect), K6
and the steady-4096 pass of one checkout on the card, for comparing two
trees in one session.

    python3 tools/bench_torch_kernels.py [--repo PATH] [--reps N]
                                         [--no-steady] [--only k3|s1]

--repo names the checkout whose `tetra_tpu_torch` is imported and built
(default: the one holding this script), so that a parent tree unpacked
beside this one runs under the same script: run parent, change, change,
parent in one call. Prints one JSON line:

- the card (nvidia-smi name and power limit) and the tree;
- K1 (`decode_assembled`) at n_sym 288 (the fused decode's three maps,
  K 512, restarts at 80/144/224), 80 (SB1, K 120) and 144 (NDB, K 216),
  on 20,000 and 262,144 rows of random signs; K4 (`decode_segmented_k4`)
  at n_sym 288 on 21,504 rows of the soft path's alphabet with random
  restarts, and at n_sym 80 on 32 rows;
- K6 (`decode_k6`) at n_sym 112 and 72 (speech code) at the voice-1024
  pass's per-launch row counts (VOICE_ROWS) and at 3,072 rows, and at
  n_sym 292 (control code) on 256 rows, on the voice alphabet; an
  empty kernel launch where the tree has one (the floor of a one-launch
  design); and the host microseconds a K6 call takes (`host_us`: the
  wrapper at n112 x 3,072, the stream-handle getters, the output's
  allocation);
- K2 (`pfb_channelize_rows`) at the prod-1024 shape: C 1024 on
  6,672,000 samples of Gaussian noise (one chunk and its overlap-save
  history), and `torch.fft.fft` over the [M, C] complex frames alone;
- with `--only k3`, nothing but K3 and the front end's span after K2 at
  the prod-1024 and wide-512 shapes, and wide-512's step (`k3` and
  `wide512_step` below);
- with `--only s1`, nothing but what the burst synchroniser (S1's
  `sync_scan`) moves, each with the tree's own code: one `sync_scan`
  call at prod-1024's shape, the tree's `tools/profile_torch_prod.py`
  and `--soft` (layer tables and device idle share, in subprocesses),
  mixer-64 on both planes and two prod-1024-python passes through the
  tree's `chip_smoke.run_mixer` and `python_run`, and the caching
  allocator's counters over four prod-1024 passes (`s1` below);
- K5 at the steady shape [4096, 32,768] (the clean steady capture):
  `demod_fused` (the kernel's launch) and `demodulate_hard_ri_pallas`
  (the wrapper the steady chain calls), and K7's stage bisect
  (tools/profile_torch_demod.stage_times at 512 and 4,096 carriers);
- each as the CUDA-event mean over `reps` launches after a warm-up
  (tools/profile_torch_demod.cuda_ms, `ms`) and as the kernel's own
  device time from torch.profiler (`device_ms`), with its bound computed
  as chip_smoke.py computes it and, where the tree exports it, the
  kernel's occupancy;
- with the steady pass: `wall_s` of locked_step_ri(fast="pallas") on
  4096 clean carriers x 64 slots under decoders=("fused",) and the
  default three, one warm pass and then `reps` timed passes each, and
  the CRC-OK count of the last.

The inputs come from fixed seeds, so both trees see the same data; the
Viterbi kernels run every step whatever the data, so random rows time
as real ones do.
"""
import argparse
import importlib.util
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def _chip_smoke():
    """This tree's chip_smoke.py (its bound formulas), by path: the
    other tree has one of the same name."""
    spec = importlib.util.spec_from_file_location("_cs_bench",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_ms(fn, reps: int, key: str = "viterbi"):
    """Mean device time in ms of the kernels named `key` per fn() call,
    from torch.profiler over `reps` calls (None where the profiler sees
    no such kernel): the kernel alone, without the host's launch cost
    that a CUDA-event mean includes for a short kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "device_time_total", 0) for e in prof.key_averages()
             if key in e.key)
    return us / reps / 1e3 if us else None


def k1_cases(dev, rows: int):
    """(name, code, x, tab, rm) of the three K1 shapes at `rows`."""
    import torch
    from tetra_tpu_torch.lmac.fused import fused_tables
    from tetra_tpu_torch.lmac.pipeline import _block_decoder
    g = torch.Generator().manual_seed(rows)
    tables = fused_tables(dev)
    out = []
    for name, code, K in (("n288", tables.code, 512),
                          ("n80", _block_decoder("SB1", dev).code, 120),
                          ("n144", _block_decoder("NDB", dev).code, 216)):
        n_tab = code.pidx.shape[0]
        x = torch.randint(-1, 2, (rows, K), generator=g).to(torch.int8)
        tab = torch.randint(0, n_tab, (rows,), generator=g).to(torch.int32)
        rm = (tables.rmask.cpu()[tab.long()] if code.boundaries
              else torch.zeros((rows, 0), dtype=torch.int8))
        out.append((name, code, x.to(dev), tab.to(dev), rm.to(dev)))
    return out


def k4_case(dev, rows: int, n_sym: int, bnd: tuple):
    import torch
    g = torch.Generator().manual_seed(rows + n_sym)
    x = (torch.randint(-124, 125, (rows, 4 * n_sym), generator=g) * 127
         ).to(torch.float32)
    x[torch.rand(x.shape, generator=g) < 0.375] = 0
    rm = torch.randint(0, 2, (rows, len(bnd)), generator=g).to(torch.int8)
    return x.to(dev), rm.to(dev)


# K6's row count at each launch of the voice-1024 pass (chip_smoke.py's
# voice phase, k6_rows_per_launch)
VOICE_ROWS = (286, 1018, 1220, 1221, 1369, 2245, 2392, 2536)


def k6(dev, cs, kernels, reps: int) -> dict:
    """K6 at the voice pass's shapes (n112 and n72 at VOICE_ROWS and
    3,072 rows) and TCH/4.8's n292 at 256 rows; the empty launch."""
    import torch
    from profile_torch_demod import cuda_ms
    from tetra_tpu_torch import constants as C
    from tetra_tpu_torch.ops.viterbi_decode import decode_k6
    res = {}
    cases = [(r, n, C.CONV_GENERATORS_TCH) for r in VOICE_ROWS + (3072,)
             for n in (112, 72)] + [(256, 292, C.CONV_GENERATORS_CCH)]
    for rows, n_sym, gens in cases:
        x = cs.k6_rows(rows, n_sym, len(gens), rows + n_sym, dev)
        run = lambda: decode_k6(x, n_sym, gens)
        res[f"n{n_sym}_{rows}"] = {
            "rows": rows, "ms": cuda_ms(run, reps),
            "device_ms": device_ms(run, reps),
            **cs.bound(4 * x.numel() + rows * n_sym,
                       cs.viterbi_ops(rows, n_sym, len(gens)), cs.F32_OPS),
            "occupancy": occupancy(kernels, "tt_viterbi_decode", len(gens),
                                   n_sym)}
    if hasattr(kernels.lib(), "tt_empty_launch"):
        stream = kernels.stream_ptr(dev)
        res["empty_launch_ms"] = cuda_ms(
            lambda: kernels.lib().tt_empty_launch(stream), 100)
    # host seconds a call: the wrapper at the largest voice shape, and
    # the stream-handle getters and allocation it may spend them on
    x = cs.k6_rows(3072, 112, 3, 1, dev)
    gens = C.CONV_GENERATORS_TCH
    res["host_us"] = {
        "decode_k6_n112_3072": host_us(lambda: decode_k6(x, 112, gens)),
        "kernels_stream_ptr": host_us(lambda: kernels.stream_ptr(dev)),
        "current_stream": host_us(
            lambda: torch.cuda.current_stream(dev).cuda_stream),
        "raw_stream": host_us(
            lambda: torch._C._cuda_getCurrentRawStream(0)),
        "empty_int8_3072x112": host_us(
            lambda: torch.empty((3072, 112), dtype=torch.int8, device=dev))}
    return res


def host_us(fn, n: int = 1000) -> float:
    """Mean host microseconds of fn() over n calls after a warm-up (the
    card is synchronised before and after, not between calls)."""
    import torch
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return dt / n * 1e6


def occupancy(kernels, name: str, *args):
    """kernels.occupancy where the tree exports `<name>_occupancy`, else
    None (a parent tree may not)."""
    occ = getattr(kernels, "occupancy", None)
    if occ is None or not hasattr(kernels.lib(), f"{name}_occupancy"):
        return None
    return occ(name, *args)


def k2(dev, cs, kernels, reps: int) -> dict:
    """K2 at the prod-1024 shape, and the DFT stage alone."""
    import torch
    from profile_torch_demod import cuda_ms
    from tetra_tpu_torch.phy.pfb import PfbFrontEnd, pfb_channelize_rows
    n_chan, T = 1024, 6_672_000
    fe = PfbFrontEnd(n_chan, 25_000.0 * n_chan).to(dev)
    g = torch.Generator().manual_seed(1)
    re = torch.randn(T, generator=g).to(dev)
    im = torch.randn(T, generator=g).to(dev)
    run = lambda: pfb_channelize_rows(re, im, fe.h, fe.twc, fe.tws, n_chan,
                                      fe.J)
    yr, yi = run()
    z = torch.complex(yr, yi)
    return {"n_chan": n_chan, "samples": T, "frames": int(yr.shape[0]),
            "ms": cuda_ms(run, reps), "device_ms": device_ms(run, reps,
                                                             "pfb_wola"),
            "dft_only_ms": cuda_ms(lambda: torch.fft.fft(z, dim=1), reps),
            **cs.k2_bound(n_chan, T, int(yr.shape[0]), fe.J),
            "occupancy": occupancy(kernels, "tt_pfb_wola", n_chan)}


def k3(dev, cs, kernels, reps: int) -> dict:
    """K3 and the front end's span after K2 at prod-1024's chunk (C 1024,
    6,672,000 samples) and wide-512's n_slots-168 step (C 512): K2's
    rows, K3 time-major (the call both trees have), the whole front end
    (`pfb_to_demod_rate_ri`, [C, T_out] x2, over all channels and over a
    permuted half as int64) and K2 alone; `after_k2_ms` = front end - K2
    is what K3 and any layout copies cost the front end."""
    import torch
    from profile_torch_demod import cuda_ms
    from tetra_tpu_torch.phy.pfb import (PfbFrontEnd, pfb_channelize_rows,
                                         pfb_to_demod_rate_ri, resample_rows)
    res = {}
    for name, n_chan, T in (("prod", 1024, 6_672_000),
                            ("wide512", 512, cs.wide_samples(168))):
        fs = 25_000.0 * n_chan
        fe = PfbFrontEnd(n_chan, fs).to(dev)
        g = torch.Generator().manual_seed(n_chan)
        re = torch.randn(T, generator=g).to(dev)
        im = torch.randn(T, generator=g).to(dev)
        sub = torch.randperm(n_chan, generator=g)[:n_chan // 2].to(dev)
        k2 = lambda: pfb_channelize_rows(re, im, fe.h, fe.twc, fe.tws,
                                         n_chan, fe.J)
        yr, yi = k2()
        n_out = fe.n_out(yr.shape[0])
        rows = lambda: resample_rows(yr, yi, fe.rs_taps, fe.rs_off, fe.W,
                                     fe.bmin, fe.L, fe.M, n_out)
        front = lambda: pfb_to_demod_rate_ri(re, im, None, n_chan, fs)
        front_sub = lambda: pfb_to_demod_rate_ri(re, im, sub, n_chan, fs)
        r = {"n_chan": n_chan, "samples": T, "frames": int(yr.shape[0]),
             "n_out": n_out, "k2_ms": cuda_ms(k2, reps),
             "k3_time_major_ms": cuda_ms(rows, reps),
             "k3_time_major_device_ms": device_ms(rows, reps, "resample"),
             "front_end_ms": cuda_ms(front, reps),
             "front_end_device_ms": device_ms(front, reps, ""),
             "front_end_subset_ms": cuda_ms(front_sub, reps),
             "k3_in_front_end_device_ms": device_ms(front, reps, "resample"),
             "k3_bound": cs.k3_bound(int(yr.shape[0]), n_chan, n_out),
             "occupancy": occupancy(kernels, "tt_resample_rows", 25, 18, 8,
                                    31, 1)}
        r["after_k2_ms"] = r["front_end_ms"] - r["k2_ms"]
        res[name] = r
        del yr, yi, re, im
        torch.cuda.empty_cache()
    res["wide512_step"] = wide512_step(dev, cs, reps)
    return res


def wide512_step(dev, cs, reps: int) -> dict:
    """wide-512's step as chip_smoke.py's wide512 phase times it: the
    bench's Gaussian noise (default_rng(1)) at n_slots 8 and 168 through
    chip_smoke.wide_step (the 512-channel front end, K2 + K3, into
    locked_step_ri), median of `reps` passes each after a warm one, and
    the differential samples per second."""
    import numpy as np
    import torch
    from tetra_tpu_torch import steady_fixture as sf
    inits = torch.full((cs.WIDE_CHAN,), sf.load()["init"],
                       dtype=torch.int64, device=dev)
    rng = np.random.default_rng(1)
    res = {}
    for n_slots in (8, 168):
        T = cs.wide_samples(n_slots)
        a = torch.as_tensor(rng.normal(0, 1, T).astype(np.float32),
                            device=dev)
        b = torch.as_tensor(rng.normal(0, 1, T).astype(np.float32),
                            device=dev)
        cs.wide_step(a, b, inits, n_slots)
        ts = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = cs.wide_step(a, b, inits, n_slots)
            int(out["crc_ok"].sum())
            ts.append(time.perf_counter() - t0)
        res[str(n_slots)] = {"samples": T, "step_s": ts,
                             "median_s": float(np.median(ts))}
        del a, b, out
    d = res["168"]["samples"] - res["8"]["samples"]
    res["samples_per_s"] = d / (res["168"]["median_s"]
                                - res["8"]["median_s"])
    return res


def k5(dev, cs, kernels, re, im, reps: int) -> dict:
    """K5 at the steady shape: its launch alone and the steady chain's
    wrapper; then K7's stage bisect."""
    from profile_torch_demod import cuda_ms, stage_times
    from tetra_tpu_torch.phy import demod_fused
    kern = lambda: demod_fused.demod_fused(re, im)
    wrap = lambda: demod_fused.demodulate_hard_ri_pallas(re, im)
    return {"carriers": int(re.shape[0]), "samples": int(re.shape[1]),
            "kernel_ms": cuda_ms(kern, reps),
            "kernel_device_ms": device_ms(kern, reps, "demod_fused"),
            "wrapper_ms": cuda_ms(wrap, reps),
            "wrapper_device_ms": device_ms(wrap, reps, ""),
            **cs.k5_bound(re.numel()),
            "occupancy": occupancy(kernels, "tt_demod_fused_sps", 2),
            "k7": stage_times(dev, reps=reps)}


def s1(dev, cs, repo: pathlib.Path, reps: int) -> dict:
    """What the tree's burst synchroniser costs: a sync_scan call on
    chip_smoke.sync_case's 1024 carriers x 146 steps (the call, and where
    the tree has them the next-match maps and S1 alone; the tree's plain
    loop where it has no S1), the layer tables of prod-1024 and
    snr8-1024, mixer-64 on both planes, prod-1024-python and the caching
    allocator's counters over prod-1024 passes."""
    import subprocess
    import torch
    from profile_torch_demod import cuda_ms
    from tetra_tpu_torch import prod_fixture as P
    from tetra_tpu_torch.phy import sync_vec as sv
    from tetra_tpu_torch.utils import trace
    res = {"profiles": {}}
    for name, extra in (("prod", []), ("snr8", ["--soft"])):
        out = subprocess.run(
            [sys.executable, str(repo / "tools" / "profile_torch_prod.py"),
             *extra], capture_output=True, text=True, timeout=900)
        if out.returncode:
            raise RuntimeError(f"profile_torch_prod {extra}: "
                               f"{out.stderr[-2000:]}")
        res["profiles"][name] = [json.loads(x) for x in out.stdout.splitlines()
                                 if x.startswith("{")]
    steps = 146
    bits, carry = cs.sync_case(1024, steps, 13, dev)
    call = lambda: sv.sync_scan(bits, *carry, 0, steps)
    has_s1 = hasattr(sv, "sync_steps")
    res["sync_scan"] = {"carriers": 1024, "window_bits": int(bits.shape[1]),
                        "steps": steps, "kernel": has_s1,
                        "ms": cuda_ms(call, reps if has_s1 else 2),
                        **cs.sync_bound(1024, int(bits.shape[1]), steps, 0)}
    if has_s1:
        nm = sv.next_match_maps(bits)
        c = torch.stack(carry)
        res["sync_scan"] |= {
            "maps_ms": cuda_ms(lambda: sv.next_match_maps(bits), reps),
            "steps_kernel_ms": cuda_ms(lambda: sv.sync_steps(bits, nm, c,
                                                             steps), reps)}
        del nm, c
    del bits, carry
    tree = _tree_chip_smoke(repo)
    card = cs.smi()
    fx, fxm = P.load(), P.load_mixer()
    with P.keystore_file() as ks:
        mix, _ = tree.run_mixer(ks, dev, fx, fxm, card)
        res["mixer"] = {
            p: {k: mix[p][k] for k in ("wall_s", "warm_s", "crc_ok",
                                       "carriers_differing_from_jax")}
            | ({"host_split": mix[p]["host_split"]} if p == "python"
               else {})
            for p in ("python", "native")}
        res["mixer"]["native_profile"] = {
            k: mix["native_profile"][k] for k in
            ("profiled_wall_s", "device_busy_s", "device_idle_share",
             "top_kernels")}
        res["mixer"]["python_equals_native"] = mix["python_equals_native"]
        bits_p, _ = P.mixed_bits(1024, 0.1, fx)
        packed = P.wideband_capture(bits_p)
        res["prod_python"] = []
        for _ in range(2):
            mrx, _, _, wall = tree.python_run(packed, 1024, ks, dev,
                                              "process_iq4c", 4,
                                              log_carriers={}, sink=False)
            res["prod_python"].append({
                "wall_s": wall,
                "host_split": {k: v["total_s"] for k, v in
                               trace.timings().items()
                               if k.startswith("pyplane.")},
                "crc_ok": sum(c.stats.crc_ok for c in mrx.carriers)})
        keys = ("num_alloc_retries", "num_device_alloc", "num_device_free")
        P.run_receiver(packed, 1024, ks, dev, 4)
        res["allocator"] = []
        for _ in range(4):
            m0 = torch.cuda.memory_stats()
            mrx, wall = P.run_receiver(packed, 1024, ks, dev, 4)
            m1 = torch.cuda.memory_stats()
            res["allocator"].append(
                {"wall_s": wall, "counts": cs.counts(mrx),
                 **{k: m1.get(k, 0) - m0.get(k, 0) for k in keys},
                 "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
                 "reserved_gb": torch.cuda.memory_reserved() / 1e9})
    return res


def _tree_chip_smoke(repo: pathlib.Path):
    """The chip_smoke.py of the tree under test, by path (its run_mixer
    and python_run drive that tree's receiver as it was written)."""
    spec = importlib.util.spec_from_file_location("_cs_tree",
                                                  repo / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def steady_planes(dev):
    """The clean steady capture at 4096 carriers on dev: (fx, re, im)."""
    import torch
    from tetra_tpu_torch import steady_fixture as sf
    fx = sf.load()
    re_np, im_np = sf.capture(4096, fx=fx)
    return (fx, torch.as_tensor(re_np, device=dev),
            torch.as_tensor(im_np, device=dev))


def steady(dev, fx, re, im, reps: int) -> dict:
    import torch
    from tetra_tpu_torch import steady_fixture as sf
    from tetra_tpu_torch.lmac.steady import locked_step_ri
    inits = torch.full((4096,), fx["init"], dtype=torch.int64, device=dev)
    res = {}
    for name, dec in (("fused", ("fused",)), ("all3", ("sync", "schf", "ndb"))):
        run = lambda: locked_step_ri(re, im, inits, phase_bit=sf.PHASE_BIT,
                                     n_slots=sf.N_SLOTS, fast="pallas",
                                     decoders=dec)
        run()
        walls = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        res[name] = {"wall_s": walls, "crc_ok": int(out["crc_ok"].sum())}
        del out
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--repo", default=str(ROOT))
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--no-steady", action="store_true")
    ap.add_argument("--only", choices=("k3", "s1"),
                    help="time only this kernel (k3: K3 and the front end "
                         "after K2; s1: the burst synchroniser and the "
                         "passes it moves)")
    args = ap.parse_args()
    repo = pathlib.Path(args.repo).resolve()
    sys.path[:0] = [str(repo), str(HERE)]
    import torch
    if not torch.cuda.is_available():
        print("bench_torch_kernels: no CUDA card", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    # the package first: profile_torch_demod puts this tree's root on
    # sys.path, and the package already imported is the one it then uses
    from tetra_tpu_torch import kernels
    from tetra_tpu_torch.ops.viterbi_segmented import decode_segmented_k4
    from profile_torch_demod import cuda_ms
    if not pathlib.Path(kernels.__file__).resolve().is_relative_to(repo):
        raise RuntimeError(f"imported {kernels.__file__}, not from {repo}")
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    kernels.lib()
    res = {"repo": str(repo), "card": cs.smi(),
           "build_s": time.perf_counter() - t0}
    if args.only == "k3":
        res["k3"] = k3(dev, cs, kernels, args.reps)
        print(json.dumps(res), flush=True)
        return 0
    if args.only == "s1":
        res["s1"] = s1(dev, cs, repo, args.reps)
        print(json.dumps(res), flush=True)
        return 0
    res.update({"k1": {}, "k4": {}, "k6": k6(dev, cs, kernels, args.reps)})
    for rows in (20_000, 262_144):
        for name, code, x, tab, rm in k1_cases(dev, rows):
            n = rows
            res["k1"][f"{name}_{rows}"] = {
                "ms": cuda_ms(lambda: code(x, tab, rm), args.reps),
                "device_ms": device_ms(lambda: code(x, tab, rm), args.reps),
                **cs.bound(x.numel() + 4 * tab.numel() + rm.numel()
                           + n * (code.n_sym + len(code.crc_segs)),
                           cs.viterbi_ops(n, code.n_sym, 4) + n * code.n_sym,
                           cs.INT32_OPS)}
            if rows == 20_000:
                res["k1"][f"{name}_{rows}"]["occupancy"] = occupancy(
                    kernels, "tt_viterbi_assembled", x.shape[1],
                    code.pidx.shape[0], code.n_sym)
            del x, tab, rm
    for name, rows, ns, bnd in (("n288", 21_504, 288, (80, 144, 224)),
                                ("n80", 32, 80, ())):
        x, rm = k4_case(dev, rows, ns, bnd)
        res["k4"][name] = {
            "rows": rows,
            "ms": cuda_ms(lambda: decode_segmented_k4(x, rm, ns, bnd),
                          args.reps),
            "device_ms": device_ms(lambda: decode_segmented_k4(x, rm, ns, bnd),
                                   args.reps),
            **cs.bound(4 * rows * 4 * ns + rm.numel() + rows * ns,
                       cs.viterbi_ops(rows, ns, 4), cs.F32_OPS),
            "occupancy": occupancy(kernels, "tt_viterbi_segmented", 4, ns)}
    torch.cuda.empty_cache()
    res["k2"] = k2(dev, cs, kernels, args.reps)
    torch.cuda.empty_cache()
    fx, re, im = steady_planes(dev)
    res["k5"] = k5(dev, cs, kernels, re, im, args.reps)
    if not args.no_steady:
        torch.cuda.empty_cache()
        res["steady"] = steady(dev, fx, re, im, args.reps)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
