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
`tx_slots` rebuilds the 64 slots with the port's own transmitter.

`eq_capture` is the degraded capture of the equaliser's checks: each
quarter of the carriers through one multipath channel (EQ_GROUPS, the
channels of tests/test_degraded.py::TestEqualized, 3-6 dB above the
equaliser's measured floors), AWGN from a numpy generator seeded per
carrier, so any subset of carriers is rebuilt alone. `data/eq_degraded.npz`
(tools/make_torch_fixture.py eq) holds the JAX chain's per-slot kinds
and CRC flags on the EQ_RECORD carriers of the 4096-carrier capture.
"""
from __future__ import annotations

import pathlib

import numpy as np

from tetra_tpu_torch import constants as C
from tetra_tpu_torch.phy.dqpsk import modulate

__all__ = ["STEADY_PATH", "EQ_PATH", "N_SLOTS", "PHASE_BIT", "BLOCKS",
           "EQ_GROUPS", "EQ_SEED", "EQ_CAR", "EQ_RECORD", "load", "tx_slots",
           "slot_index", "carrier_bits", "capture", "eq_group", "eq_capture",
           "eq_record"]

STEADY_PATH = pathlib.Path(__file__).parent / "data" / "steady_mixed.npz"
EQ_PATH = pathlib.Path(__file__).parent / "data" / "eq_degraded.npz"
N_SLOTS = 64
PHASE_BIT = 64
# type-1 payload key -> (result key of locked_step_ri, kind it is valid on)
BLOCKS = {"sb1": ("sb1", 0), "sb2": ("sb2", 0), "schf": ("schf", 1),
          "ndb1": ("ndb1", 2), "ndb2": ("ndb2", 2), "aach": ("bbk", None)}
FS = 36_000.0          # sample rate at sps 2
# equaliser groups: name -> (channel taps at T/2, CFO Hz, SNR dB)
EQ_GROUPS = {
    "A": ((1.0,), 0.0, 16.0),
    "B": ((1.0, 0.25 * np.exp(1j * 0.7)), 0.0, 16.0),
    "C": ((1.0, 0.0, 0.5 * np.exp(1j * 2.1)), 0.0, 22.0),
    "D": ((1.0, 0.25 * np.exp(1j * 0.7)), 800.0, 18.0),
}
EQ_SEED = 1010
EQ_CAR = 4096          # the full-width degraded capture
# its recorded carriers: 16 a group, rolls 3k % 64 apart
EQ_RECORD = tuple(1024 * g + 67 * k for g in range(4) for k in range(16))
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


def tx_slots(seed: int = 0, device=None):
    """The fixture's slots [64, 510] uint8, kinds [64] and type-1
    payloads by block key, made by the port's tx and testpdu (encoding
    on `device`, the card unless the caller asks for the CPU) with the
    recipe of tools/make_torch_fixture.py steady_slots: slot s has kind
    s % 3, ACCESS-ASSIGN (s % 4, s % 64, 7s % 64), SYNC tn s % 4 + 1 and
    fn s // 4 + 1, SYSINFO la 1000 + s, MAC-RESOURCE ssi 0x500 + s, NDB
    halves from default_rng(seed)."""
    from tetra_tpu_torch import testpdu, tx
    from tetra_tpu_torch.ops.scramble import scramb_get_init
    init = scramb_get_init(262, 42, 1)
    rng = np.random.default_rng(seed)
    slots = np.zeros((N_SLOTS, C.BITS_PER_TS), np.uint8)
    kinds = np.arange(N_SLOTS, dtype=np.int32) % 3
    pay = {k: np.zeros((N_SLOTS, w), np.uint8) for k, w in _WIDTH.items()}
    for s in range(N_SLOTS):
        aa = testpdu.make_access_assign_bits(hdr=s % 4, f1=s % 64,
                                             f2=(7 * s) % 64)
        pay["aach"][s] = aa
        if kinds[s] == 0:
            p1 = testpdu.make_sync_pdu(cc=1, tn=s % 4 + 1, fn=s // 4 + 1,
                                       mcc=262, mnc=42)
            p2 = testpdu.make_sysinfo_pdu(la=1000 + s)
            pay["sb1"][s], pay["sb2"][s] = p1, p2
            b = tx.make_sync_burst(p1, p2, aa, init, device)
        elif kinds[s] == 1:
            p = testpdu.make_resource_pdu(ssi=0x500 + s)
            pay["schf"][s] = p
            b = tx.make_schf_burst(p, aa, init, device)
        else:
            b1 = rng.integers(0, 2, 124).astype(np.int8)
            b2 = rng.integers(0, 2, 124).astype(np.int8)
            pay["ndb1"][s], pay["ndb2"][s] = b1, b2
            b = tx.make_ndb_burst(b1, b2, aa, init, device)
        slots[s] = b
    return slots, kinds, pay, init


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
            fx: dict | None = None, sps: int = 2):
    """Planar baseband (re, im) float32 [n_car, 16,384·sps] of
    carrier_bits at `sps` samples a symbol. Carriers listed in `noisy` get AWGN at snr_db relative to
    the clean capture's mean power, from default_rng(seed), in carrier
    order (real part, then imaginary part, per carrier). Only the
    distinct rolls are modulated."""
    fx = load() if fx is None else fx
    n_mod = min(n_car, N_SLOTS)
    base = modulate(carrier_bits(n_mod, fx), sps=sps)
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


def eq_group(n_car: int, carriers=None) -> np.ndarray:
    """Group index (0..3 for EQ_GROUPS A..D) of each carrier: carrier c
    of n_car is in quarter 4c // n_car."""
    c = np.arange(n_car) if carriers is None else np.asarray(carriers)
    return (4 * c) // n_car


def eq_capture(n_car: int, carriers=None, seed: int = EQ_SEED,
               fx: dict | None = None):
    """Planar baseband (re, im) float32 [len(carriers), 32,768] of the
    listed carriers (default all) of an n_car-carrier degraded capture:
    carrier c holds carrier_bits' row c modulated at sps 2, convolved
    with its group's channel taps (truncated to the stream), rotated by
    the group's CFO, plus AWGN at the group's SNR relative to that
    carrier's own mean power (tests/test_degraded.py's _awgn), drawn
    from default_rng([seed, c]): real part, then imaginary part."""
    fx = load() if fx is None else fx
    carriers = np.arange(n_car) if carriers is None else \
        np.asarray(carriers)
    rolls = np.unique(carriers % N_SLOTS)
    base = dict(zip(rolls.tolist(), modulate(
        carrier_bits(N_SLOTS, fx)[rolls], sps=2)))
    groups = list(EQ_GROUPS.values())
    T = next(iter(base.values())).shape[0]
    tt = np.arange(T) / FS
    re = np.empty((len(carriers), T), np.float32)
    im = np.empty((len(carriers), T), np.float32)
    for i, (c, g) in enumerate(zip(carriers, eq_group(n_car, carriers))):
        taps, cfo, snr = groups[g]
        iq = np.convolve(base[int(c % N_SLOTS)],
                         np.asarray(taps, np.complex64))[:T]
        if cfo:
            iq = iq * np.exp(2j * np.pi * cfo * tt)
        npow = np.mean(np.abs(iq) ** 2) / (10 ** (snr / 10))
        rng = np.random.default_rng([seed, int(c)])
        sd = np.sqrt(npow / 2)
        re[i] = iq.real + rng.normal(0, sd, T)
        im[i] = iq.imag + rng.normal(0, sd, T)
    return re, im


def eq_record(path=EQ_PATH) -> dict:
    """The JAX fast="eq" chain's record: 'carriers' [64] (EQ_RECORD of an
    EQ_CAR-carrier eq_capture with seed 'seed'), 'kinds' [64, 64] and
    'crc_ok' [64, 64] per slot, and the channel table 'taps' [4, 3]
    complex, 'cfo' [4], 'snr_db' [4] (EQ_GROUPS A..D) it was made with."""
    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    d["n_car"], d["seed"] = int(d["n_car"]), int(d["seed"])
    return d
