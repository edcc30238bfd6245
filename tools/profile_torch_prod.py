"""Where the time goes in the PyTorch port's production path, on a card.

Runs the 1024-carrier production capture (tetra_tpu_torch.prod_fixture,
4 chunks) through tetra_tpu_torch's MultiCarrierReceiver three times
(with --soft: the 8 dB snr8 capture through demod="soft"; with
--voice: the production capture with traffic dumps into a temporary
directory and voice decode (K6), beside a pass without them; with
--steady: the steady fixture at 4096 carriers x 64 slots through
lmac.steady.locked_step_ri(fast="pallas"), input already on the card,
for decoders=("fused",) and the default three):
  1. warm-up;
  2. layer breakdown: each layer is wrapped with a synchronize before
     and after, so its host-clock time includes its device work (this
     pass is slower than an uninstrumented one by the added syncs);
  3. torch.profiler over an uninstrumented pass: device time by kernel
     name, summed device busy time and the device idle share of the
     pass's wall time.
Prints one JSON line per result.

    python3 tools/profile_torch_prod.py [--soft | --voice | --steady] [n_carriers]
"""
import collections
import functools
import json
import pathlib
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import torch

from tetra_tpu_torch.umac.native_exec import NativeControlPlane
from tetra_tpu_torch import fastpath, prod_fixture, rx_multi
from tetra_tpu_torch.lmac import fused, pipeline

N_CHUNKS = 4


def run(packed, n_car, ks_path, demod, voice=False):
    """Wall seconds of one pass (with voice: dumps into a fresh
    temporary directory and decode_voice)."""
    if not voice:
        return prod_fixture.run_receiver(packed, n_car, ks_path, "cuda",
                                         N_CHUNKS, demod)[1]
    with tempfile.TemporaryDirectory() as tmp:
        return prod_fixture.run_receiver(packed, n_car, ks_path, "cuda",
                                         N_CHUNKS, demod, dumpdir=tmp,
                                         decode_voice=True)[1]


def timed(acc, name, fn):
    # wraps copies fn's attributes (a kernel wrapper's launch count), so
    # a wrapped kernel wrapper still finds its own count
    @functools.wraps(fn)
    def wrapper(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*a, **k)
        torch.cuda.synchronize()
        acc[name] += time.perf_counter() - t0
        return out
    return wrapper


def device_profile(fn, card: str) -> dict:
    """torch.profiler over one synchronised run of fn: device busy time
    (kernels, copies, sets), idle share of the run's wall time and the
    largest device items."""
    from torch.autograd import DeviceType
    from torch.profiler import profile, ProfilerActivity
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    busy_us = 0.0
    for e in prof.key_averages():
        # device-side events only (kernels, memcpy, memset): the CPU ops
        # that launched them carry the same time again
        if e.device_type != DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
        rows.append((dev_us, e.key, e.count))
        busy_us += dev_us
    rows.sort(reverse=True)
    return {"card": card, "profiled_wall_s": wall,
            "device_busy_s": busy_us / 1e6,
            "device_idle_share": 1.0 - busy_us / 1e6 / wall,
            "top_kernels": [{"name": k[:80], "device_ms": u / 1e3,
                             "calls": c} for u, k, c in rows[:15]]}


def main_steady(n_car: int, card: str):
    """Layer breakdown and device profile of the steady chain."""
    from tetra_tpu_torch import steady_fixture as sf
    from tetra_tpu_torch.lmac import steady
    from tetra_tpu_torch.ops import viterbi_assembled
    from tetra_tpu_torch.phy import demod_fused
    fx = sf.load()
    re_np, im_np = sf.capture(n_car, fx=fx)
    re = torch.as_tensor(re_np, device="cuda")
    im = torch.as_tensor(im_np, device="cuda")
    inits = torch.full((n_car,), fx["init"], dtype=torch.int64,
                       device="cuda")
    stream_s = re.shape[1] / prod_fixture.BITRATE
    # top-level layers (their sum plus "rest" is the instrumented pass)
    # and K1 alone, which runs inside the FEC layers
    top = [(demod_fused, "demodulate_hard_slots_ri_pallas",
            "demod (K5 with its phase pick and bits; slots a view)"),
           (steady, "verify_train_seq", "training-sequence check"),
           (fused, "decode_slots_fused", "fused FEC (assembly + K1 n288)"),
           (pipeline, "decode_sync_burst", "sync bursts (SB1, BBK, SB2)"),
           (pipeline, "decode_schf_burst", "SCH/F bursts (BBK, SCH_F)"),
           (pipeline, "decode_ndb_burst", "NDB bursts (BBK, NDB x2)")]
    inner = [(viterbi_assembled, "decode_assembled", "of which K1")]
    for decoders in (("fused",), ("sync", "schf", "ndb")):
        def run():
            return steady.locked_step_ri(re, im, inits, phase_bit=64,
                                         n_slots=64, fast="pallas",
                                         decoders=decoders)

        def timed_pass():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            return time.perf_counter() - t0
        warm = timed_pass()
        plain_wall = timed_pass()
        acc = collections.defaultdict(float)
        saved = [(m, a, getattr(m, a)) for m, a, _ in top + inner]
        for m, a, name in top + inner:
            setattr(m, a, timed(acc, name, getattr(m, a)))
        try:
            inst_wall = timed_pass()
        finally:
            for m, a, fn in saved:
                setattr(m, a, fn)
        layers = {k: v for k, v in acc.items() if k != "of which K1"}
        layers["rest (slot views, result selects, Python)"] = \
            inst_wall - sum(layers.values())
        print(json.dumps({"card": card, "carriers": n_car,
                          "decoders": list(decoders), "warm_s": warm,
                          "wall_s": plain_wall,
                          "realtime_carriers": n_car * stream_s / plain_wall,
                          "instrumented_wall_s": inst_wall,
                          "layers_s": layers,
                          "k1_inside_fec_s": acc["of which K1"]}),
              flush=True)
        print(json.dumps({"decoders": list(decoders),
                          **device_profile(run, card)}), flush=True)


def main():
    args = sys.argv[1:]
    demod = "soft" if "--soft" in args else "hard"
    steady_mode = "--steady" in args
    voice = "--voice" in args
    args = [a for a in args if a not in ("--soft", "--steady", "--voice")]
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    if steady_mode:
        return main_steady(int(args[0]) if args else 4096, card)
    n_car = int(args[0]) if args else 1024
    if demod == "soft":
        fx = prod_fixture.load_snr8()
        packed = prod_fixture.snr8_capture(n_car, fx)
        stream_s = len(fx["row"]) / prod_fixture.BITRATE
    else:
        bits, _ = prod_fixture.mixed_bits(n_car, 0.1)
        packed = prod_fixture.wideband_capture(bits)
        stream_s = bits.shape[1] / prod_fixture.BITRATE
    with prod_fixture.keystore_file() as ks_file:
        ks = ks_file if demod == "hard" else None    # snr8 is unencrypted
        warm = run(packed, n_car, ks, demod, voice)
        plain_wall = run(packed, n_car, ks, demod, voice)
        no_dump_wall = run(packed, n_car, ks, demod) if voice else None

        acc = collections.defaultdict(float)
        patches = [
            (fastpath, "_iq_frontend", "front end (dequant+K2+K3+demod)"),
            (fastpath, "sync_scan", "sync_scan"),
            (pipeline, "decode_block", "SB1 pre-decode (K1 n80)"),
            (fused, "decode_slots_fused",
             "fused FEC (assembly+K1 n288)" if demod == "hard"
             else "soft FEC (soft assembly+K4+CRC)"),
            (fastpath.FastChunkPipeline, "_decode_segments",
             "host bundle parse"),
            (NativeControlPlane, "walk2", "host native walk"),
        ]
        if voice:
            patches += [
                (rx_multi, "voice_frames",
                 "voice decode (K6, reorder, XOR, pack)"),
                (rx_multi, "dump_blocks", "host dump blocks"),
                (rx_multi, "append_files", "host dump file appends")]
        saved = [(m, a, getattr(m, a)) for m, a, _ in patches]
        for m, a, name in patches:
            setattr(m, a, timed(acc, name, getattr(m, a)))
        try:
            inst_wall = run(packed, n_car, ks, demod, voice)
        finally:
            for m, a, fn in saved:
                setattr(m, a, fn)
        layers = dict(acc)
        layers["rest (compaction, fill, packing, transfers, Python)"] = \
            inst_wall - sum(acc.values())
        print(json.dumps({"card": card, "carriers": n_car, "demod": demod,
                          "voice": voice, "warm_s": warm, "wall_s": plain_wall,
                          "wall_s_without_dumps": no_dump_wall,
                          "realtime_carriers": n_car * stream_s / plain_wall,
                          "instrumented_wall_s": inst_wall,
                          "layers_s": layers}), flush=True)

        print(json.dumps(device_profile(
            lambda: run(packed, n_car, ks, demod, voice), card)), flush=True)


if __name__ == "__main__":
    main()
