"""Stage bisect of the fused hard demod (kernel K5) on a card.

The PyTorch port's counterpart of tools/profile_demod_stages.py, at its
shapes: one random-bit row of n_sym = 64·255 + 64 symbols (T = 32,768
samples at sps 2) tiled over C = 512 and 4,096 carriers. Three stages,
each a mean of CUDA-event times after a warm-up:

  plain    dqpsk.demodulate_hard_ri (os=1), the decisions of K5's
           plain version;
  kernel   K5 alone (phy.demod_fused.demod_fused) on device-resident
           planes: bits of the picked phase, the pick, the metric sums;
  wrapper  demodulate_hard_slots_ri_pallas at the steady chain's slot
           framing (64 slots from bit 64): K5 and the slots as a view.

For each stage it also reports the differential rate
(C_big - C_small)·T / (t_big - t_small) in samples per second, as the
JAX tool does, and at each carrier count it holds the wrapper's bits
against the plain stage's (they must be identical: the signal is
clean). Prints one JSON line with the card's nvidia-smi name and power
limit.

    python3 tools/profile_torch_demod.py
"""
import json
import pathlib
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

import numpy as np
import torch

from tetra_tpu_torch.device import resolve_device
from tetra_tpu_torch.phy import demod_fused, dqpsk

N_SYM = 64 * 255 + 64
N_SLOTS, PHASE_BIT = 64, 64
CARRIERS = (512, 4096)


def cuda_ms(fn, reps: int = 10) -> float:
    """Mean device time of fn() in ms over `reps` runs, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def stage_times(dev, carriers=CARRIERS, reps: int = 10,
                plain_reps: int = 3) -> dict:
    """ms of the plain, kernel and wrapper stages at each carrier count,
    their differential rates (samples/s) between the first and the last
    count, and the wrapper's bits against the plain stage's (mismatches
    and max_abs_err over all counts; raises if any bit differs)."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 2, size=2 * N_SYM).astype(np.uint8)
    iq = dqpsk.modulate(bits[None], sps=2)[0]
    T = iq.shape[-1]
    row_re = torch.as_tensor(iq.real.astype(np.float32), device=dev)
    row_im = torch.as_tensor(iq.imag.astype(np.float32), device=dev)
    stages = {
        "plain": (lambda re, im: dqpsk.demodulate_hard_ri(re, im), plain_reps),
        "kernel": (lambda re, im: demod_fused.demod_fused(re, im), reps),
        "wrapper": (lambda re, im: demod_fused.demodulate_hard_slots_ri_pallas(
            re, im, N_SLOTS, phase_bit=PHASE_BIT), reps)}
    ms = {}
    mismatches = max_abs = 0
    for cc in carriers:
        re = row_re.expand(cc, T).contiguous()
        im = row_im.expand(cc, T).contiguous()
        ms[cc] = {name: cuda_ms(lambda: fn(re, im), r)
                  for name, (fn, r) in stages.items()}
        slots, got = stages["wrapper"][0](re, im)
        want = stages["plain"][0](re, im)
        mismatches += int((got != want).sum()) + int(
            (slots.reshape(cc, -1)
             != want[:, PHASE_BIT:PHASE_BIT + N_SLOTS * 510]).sum())
        max_abs = max(max_abs, int((got - want).abs().max()))
        del re, im, got, want, slots
        torch.cuda.empty_cache()
    lo, hi = carriers[0], carriers[-1]
    rates = {f"{name}_samples_per_s":
             (hi - lo) * T / ((ms[hi][name] - ms[lo][name]) / 1e3)
             for name in stages}
    res = {"samples": T, "ms": {str(k): v for k, v in ms.items()}, **rates,
           "mismatches": mismatches, "max_abs_err": max_abs}
    if mismatches:
        raise AssertionError(f"K5 differs from its plain version: {res}")
    return res


def main():
    dev = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(json.dumps({"card": card, **stage_times(dev)}), flush=True)


if __name__ == "__main__":
    main()
