"""The equalised steady chain of the PyTorch port vs tetra_tpu on the
CPU: locked_step_ri(fast="eq") on the five scenarios of
tests/test_degraded.py::TestEqualized and on an 8-carrier x 64-slot
degraded capture of the steady fixture (steady_fixture.eq_capture: one
channel of EQ_GROUPS per carrier pair), the equalised symbols, and
fast=False (the angle demod and slicer).

Tolerance of the equalised symbols: max |port - JAX| <= 1e-3 of the
symbols' peak on every slot the chain decodes (measured 6.5e-5 clean,
1.5e-4 with a -12 dB echo, 4.5e-4 with the -6 dB one-symbol echo,
4.9e-4 on the 8-carrier capture). The ridge solves amplify the
frameworks' different summation orders (matched filter, einsum) by the
normal equations' condition number. The JAX symbols are the arguments
of the equaliser's last two `_shift` calls (the differential
detector's lags), returned by a jitted trace of its undecorated body.

NDB slots (training sequence p) are not equalised by either framework:
the pilot hypotheses are the normal (n) and sync (y) sequences only, so
those slots lose their training sequence (kind -1) and their CRC in
both. There the fit is ill-posed and near-tie picks fall either way, so
their bits are compared as a fraction (<= 1e-3 differing) and their
kinds and CRC flags exactly; every other slot is bit-identical."""
from unittest import mock

import functools

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from tests._torch_util import t, n
from tests.test_degraded import _schf_iq, _awgn, FS, INIT

from tetra_tpu import testpdu as j_testpdu, tx as j_tx
from tetra_tpu.lmac import steady as j_steady
from tetra_tpu.phy import dqpsk as j_dqpsk, equalize as j_eq

from tetra_tpu_torch import steady_fixture as sf
from tetra_tpu_torch.lmac import steady
from tetra_tpu_torch.phy import equalize

SYM_TOL = 1e-3
ECHO = np.array([1.0, 0.25 * np.exp(1j * 0.7)], np.complex64)
STRONG = np.array([1.0, 0.0, 0.5 * np.exp(1j * 2.1)], np.complex64)


def _mixed_iq():
    """test_mixed_sync_normal's stream: SYNC every third slot, SCH/F
    otherwise, through the -12 dB T/2 echo (no noise)."""
    slots = []
    for s in range(8):
        if s % 3 == 0:
            slots.append(j_tx.make_sync_burst(
                j_testpdu.make_sync_pdu(mcc=262, mnc=42, cc=1),
                j_testpdu.make_sysinfo_pdu(),
                j_testpdu.make_access_assign_bits(), jnp.uint32(INIT)))
        else:
            slots.append(j_tx.make_schf_burst(
                j_testpdu.make_resource_pdu(ssi=0x700 + s),
                j_testpdu.make_access_assign_bits(), jnp.uint32(INIT)))
    bits = np.concatenate([np.zeros(64, np.int8),
                           np.concatenate(slots).astype(np.int8),
                           np.zeros(64, np.int8)])
    iq = np.asarray(j_dqpsk.modulate(bits[None], sps=2))[0]
    return np.convolve(iq, ECHO)[: iq.shape[0]], 8


def _scenario(name):
    """TestEqualized's captures: (re [1, T], im [1, T], n_slots)."""
    if name == "mixed_sync_normal":
        iq, n_slots = _mixed_iq()
    else:
        iq, p = _schf_iq()
        n_slots = len(p)
        if name == "clean":
            iq = _awgn(iq, 12)
        elif name == "two_tap_low_snr":
            iq = _awgn(np.convolve(iq, ECHO)[: iq.shape[0]], 12, seed=5)
        elif name == "strong_echo":
            iq = _awgn(np.convolve(iq, STRONG)[: iq.shape[0]], 16, seed=6)
        else:
            faded = np.convolve(iq, ECHO)[: iq.shape[0]]
            tt = np.arange(faded.shape[0]) / FS
            iq = _awgn(faded * np.exp(2j * np.pi * 800.0 * tt), 14, seed=7)
    return (np.real(iq)[None].astype(np.float32),
            np.imag(iq)[None].astype(np.float32), n_slots)


@functools.lru_cache(maxsize=4)
def _jax_symbols_fn(n_slots: int):
    body = j_eq.demodulate_hard_eq_slotwise_ri.__wrapped__
    shift = j_eq._shift

    def symbols(re, im):
        seen = []

        def spy(x, l, axis=-1):
            seen.append(x)
            return shift(x, l, axis)

        with mock.patch.object(j_eq, "_shift", spy):
            body(re, im, n_slots, phase_bit=64)
        return seen[-2], seen[-1]

    return jax.jit(symbols)


def _jax_symbols(re, im, n_slots):
    """The JAX equaliser's symbols (yr, yi) [C, S, 255]."""
    yr, yi = _jax_symbols_fn(n_slots)(jnp.asarray(re), jnp.asarray(im))
    return np.asarray(yr), np.asarray(yi)


def _sym_err(re, im, n_slots):
    """Per-slot max |port - JAX| of the equalised symbols [C, S], and
    the JAX symbols' peak."""
    jr, ji = _jax_symbols(re, im, n_slots)
    yr, yi = (n(a) for a in equalize.equalised_symbols(t(re), t(im), n_slots,
                                                       phase_bit=64))
    d = np.maximum(np.abs(yr - jr), np.abs(yi - ji)).max(-1)
    return d, max(np.abs(jr).max(), np.abs(ji).max())


def _run(re, im, n_slots, fast, decoders=("fused",)):
    inits = np.full(re.shape[0], INIT, np.uint32)
    got = steady.locked_step_ri(t(re), t(im), t(inits), phase_bit=64,
                                n_slots=n_slots, fast=fast,
                                decoders=decoders)
    want = j_steady.locked_step_ri(jnp.asarray(re), jnp.asarray(im),
                                   jnp.asarray(inits), phase_bit=64,
                                   n_slots=n_slots, fast=fast,
                                   decoders=decoders)
    return got, want


def _differs(got, want, on=None) -> list:
    """Keys (or block fields) that differ; on [C, S] bool restricts the
    per-slot comparison to those slots (kinds and crc_ok: everywhere)."""
    bad = []
    assert got.keys() == want.keys()
    for k, v in want.items():
        for f, a, b in (zip(v._fields, got[k], v) if isinstance(v, tuple)
                        else [("", got[k], v)]):
            a, b = n(a), np.asarray(b)
            if on is not None and k not in ("kinds", "crc_ok"):
                S = on.shape[1]
                a = a.reshape(on.shape[0], S, -1)[on]
                b = b.reshape(on.shape[0], S, -1)[on]
            if not np.array_equal(a, b):
                bad.append(f"{k}.{f}" if f else k)
    return bad


@pytest.mark.parametrize("name", ["clean", "two_tap_low_snr", "strong_echo",
                                  "multipath_plus_cfo", "mixed_sync_normal"])
def test_eq_scenarios_match_jax(name):
    """Hard bits, kinds, crc_ok and every type-1 block identical to the
    JAX chain; every slot decodes, as TestEqualized asserts."""
    re, im, n_slots = _scenario(name)
    got, want = _run(re, im, n_slots, "eq")
    assert not _differs(got, want)
    assert n(got["crc_ok"]).all()


@pytest.mark.parametrize("name", ["clean", "two_tap_low_snr", "strong_echo",
                                  "multipath_plus_cfo", "mixed_sync_normal"])
def test_eq_symbols_within_tolerance(name):
    re, im, n_slots = _scenario(name)
    d, peak = _sym_err(re, im, n_slots)
    assert d.max() <= SYM_TOL * peak, d.max() / peak


def test_eq_steady_capture_8_carriers():
    """eq_capture(8): every group's channel on a carrier pair. Kinds and
    crc_ok identical everywhere; bits, blocks and symbols as the module
    docstring says (NDB slots fail in both, as the JAX equaliser
    fits only n and y pilots)."""
    fx = sf.load()
    re, im = sf.eq_capture(8, fx=fx)
    got, want = _run(re, im, sf.N_SLOTS, "eq")
    kinds = fx["kinds"][sf.slot_index(8)]
    ndb = kinds == 2
    assert not _differs(got, want, on=~ndb)
    assert np.array_equal(n(got["kinds"])[~ndb], kinds[~ndb])
    assert n(got["crc_ok"])[~ndb].all() and not n(got["crc_ok"])[ndb].any()
    bits = [np.asarray(x).reshape(8, sf.N_SLOTS, 510)[ndb]
            for x in (n(got["bits"]), want["bits"])]
    assert np.mean(bits[0] != bits[1]) <= 1e-3
    d, peak = _sym_err(re, im, sf.N_SLOTS)
    assert d[~ndb].max() <= SYM_TOL * peak, d[~ndb].max() / peak


@pytest.mark.parametrize("capture", ["clean", "snr8"])
@pytest.mark.parametrize("decoders", [("fused",), ("sync", "schf", "ndb")])
def test_angle_path_matches_jax(capture, decoders):
    """fast=False (angle demod + slicer) on 8 carriers of the steady
    fixture, clean and at 8 dB: every output identical."""
    re, im = (sf.capture(8) if capture == "clean" else
              sf.capture(8, noisy=range(8), snr_db=8.0, seed=3))
    got, want = _run(re, im, sf.N_SLOTS, False, decoders)
    assert not _differs(got, want)
    assert n(got["crc_ok"]).sum() > (500 if capture == "clean" else 400)


def test_eq_needs_sps_2():
    re, im = sf.capture(1)
    with pytest.raises(ValueError):
        steady.locked_step_ri(t(re), t(im), t(np.asarray([INIT])),
                              phase_bit=64, n_slots=32, fast="eq", sps=4)


def test_eq_record_carriers():
    """The port's chain on the recorded carriers of the 4096-carrier
    degraded capture equals the JAX record (tools/make_torch_fixture.py
    eq): per-slot kinds and CRC flags; every NDB slot fails in both."""
    fx = sf.load()
    rec = sf.eq_record()
    assert rec["n_car"] == sf.EQ_CAR and rec["seed"] == sf.EQ_SEED
    assert np.array_equal(rec["carriers"], sf.EQ_RECORD)
    re, im = sf.eq_capture(rec["n_car"], rec["carriers"], rec["seed"], fx)
    out = steady.locked_step_ri(t(re), t(im),
                                t(np.full(len(re), fx["init"], np.uint32)),
                                phase_bit=64, n_slots=sf.N_SLOTS, fast="eq",
                                decoders=("fused",))
    assert np.array_equal(n(out["kinds"]), rec["kinds"])
    assert np.array_equal(n(out["crc_ok"]), rec["crc_ok"])
    ndb = fx["kinds"][sf.slot_index(sf.EQ_CAR)[rec["carriers"]]] == 2
    assert rec["crc_ok"][~ndb].all() and not rec["crc_ok"][ndb].any()
    groups = list(sf.EQ_GROUPS.values())
    for g, (h, cfo, snr) in enumerate(groups):
        assert np.allclose(rec["taps"][g, :len(h)], h)
        assert rec["cfo"][g] == cfo and rec["snr_db"][g] == snr
