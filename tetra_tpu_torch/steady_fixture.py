"""The steady locked-step capture, rebuilt without jax.

`data/steady_mixed.npz` (written by tools/make_torch_fixture.py steady)
holds 64 slots made by the JAX TX chain (slot s has kind s % 3: SYNC,
SCH/F, NDB, each with its own payload), bit-packed, their scrambling
code and each slot's expected kind and type-1 payloads. One carrier is
the 64 slots with 64 zero bits at each end: 32,768 bits, i.e. 32,768
samples at sps 2, slot grid at bit 64. Carrier c carries the slots
rolled by c whole slots, so that no two neighbouring carriers are
equal; `capture` modulates them with the port's numpy dqpsk.modulate
and adds AWGN to chosen carriers from a seeded numpy generator.
"""
from __future__ import annotations

import pathlib

import numpy as np

from tetra_tpu_torch import constants as C
from tetra_tpu_torch.phy.dqpsk import modulate

__all__ = ["STEADY_PATH", "N_SLOTS", "PHASE_BIT", "BLOCKS", "load",
           "slot_index", "carrier_bits", "capture"]

STEADY_PATH = pathlib.Path(__file__).parent / "data" / "steady_mixed.npz"
N_SLOTS = 64
PHASE_BIT = 64
# type-1 payload key -> (result key of locked_step_ri, kind it is valid on)
BLOCKS = {"sb1": ("sb1", 0), "sb2": ("sb2", 0), "schf": ("schf", 1),
          "ndb1": ("ndb1", 2), "ndb2": ("ndb2", 2), "aach": ("bbk", None)}
_WIDTH = {"sb1": 60, "sb2": 124, "schf": 268, "ndb1": 124, "ndb2": 124,
          "aach": 14}


def load(path=STEADY_PATH) -> dict:
    """'slots' [64, 510] uint8, 'kinds' [64], 'init' (the scrambling
    code), 'pad' and the type-1 payloads by block key of BLOCKS
    ([64, width] uint8, zero on slots of another kind)."""
    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    d["slots"] = np.unpackbits(d["slots_packed"], axis=1)[:, :C.BITS_PER_TS]
    for k, w in _WIDTH.items():
        d[k] = np.unpackbits(d[f"{k}_packed"], axis=1)[:, :w]
    d["init"] = int(d["init"])
    return d


def slot_index(n_car: int) -> np.ndarray:
    """[n_car, 64]: fixture slot carried by (carrier c, slot s) =
    (s + c) % 64."""
    return (np.arange(N_SLOTS)[None, :] + np.arange(n_car)[:, None]) \
        % N_SLOTS


def carrier_bits(n_car: int, fx: dict | None = None) -> np.ndarray:
    """[n_car, 32,768] uint8: each carrier's rolled slots between 64
    zero bits at each end."""
    fx = load() if fx is None else fx
    pad = np.zeros((n_car, int(fx["pad"])), np.uint8)
    slots = fx["slots"][slot_index(n_car)].reshape(n_car, -1)
    return np.concatenate([pad, slots, pad], axis=1)


def capture(n_car: int, noisy=(), snr_db: float = 8.0, seed: int = 0,
            fx: dict | None = None):
    """Planar baseband (re, im) float32 [n_car, 32,768] of carrier_bits
    at sps 2. Carriers listed in `noisy` get AWGN at snr_db relative to
    the clean capture's mean power, from default_rng(seed), in carrier
    order (real part, then imaginary part, per carrier). Only the
    distinct rolls are modulated."""
    fx = load() if fx is None else fx
    n_mod = min(n_car, N_SLOTS)
    base = modulate(carrier_bits(n_mod, fx), sps=2)
    rows = np.arange(n_car) % N_SLOTS
    re = np.ascontiguousarray(base.real.astype(np.float32)[rows])
    im = np.ascontiguousarray(base.imag.astype(np.float32)[rows])
    if len(noisy):
        p = float(np.mean(np.abs(base) ** 2))
        sigma = np.float32(np.sqrt(p / (2 * 10 ** (snr_db / 10.0))))
        rng = np.random.default_rng(seed)
        T = re.shape[1]
        for c in noisy:
            re[c] += sigma * rng.standard_normal(T, dtype=np.float32)
            im[c] += sigma * rng.standard_normal(T, dtype=np.float32)
    return re, im
