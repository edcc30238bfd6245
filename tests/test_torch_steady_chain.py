"""Steady locked-step chain of the PyTorch port vs tetra_tpu on the CPU:
locked_step_bits, locked_step_ri for every ported `fast` mode on clean,
8 dB and CFO-ramp captures of the steady fixture, locked_step_iq, the
modes ported last (fast="eq" and False; tests/test_torch_equalize.py
holds them on degraded captures), the jax-free run and the fixture
itself.

Kinds, crc_ok, every block and the bits are compared exactly. The soft
values of demodulate_soft_slotwise_ri are held to |d| <= 1e-5 (values
are clipped at ±4; the FIR's summation order differs between the
frameworks, measured max |d| 4.8e-7)."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import jax.numpy as jnp

from tests._torch_util import t, n
from tests.test_steady import _mixed_slots, INIT

from tetra_tpu.lmac import steady as j_steady
from tetra_tpu.phy import dqpsk as j_dqpsk

from tetra_tpu_torch import steady_fixture
from tetra_tpu_torch.lmac import steady
from tetra_tpu_torch.phy import dqpsk

ROOT = pathlib.Path(__file__).resolve().parent.parent
FS = 36_000.0


def _same(got: dict, want: dict):
    """Every key of the JAX result, BlockResults field by field."""
    assert got.keys() == want.keys()
    for k, v in want.items():
        if isinstance(v, tuple):
            for a, b in zip(got[k], v):
                assert np.array_equal(n(a), np.asarray(b)), k
        else:
            assert np.array_equal(n(got[k]), np.asarray(v)), k


def _capture(kind: str):
    """Two carriers of the steady fixture: clean; AWGN at 8 dB on both;
    or a CFO ramp 0 -> 1.5 kHz across the chunk at 10 dB
    (tests/test_degraded.py's recipe)."""
    if kind == "clean":
        return steady_fixture.capture(2)
    if kind == "snr8":
        return steady_fixture.capture(2, noisy=(0, 1), snr_db=8.0, seed=3)
    re, im = steady_fixture.capture(2)
    tt = np.arange(re.shape[1]) / FS
    ph = 2 * np.pi * np.cumsum(1500.0 * tt / tt[-1]) / FS
    iq = (re + 1j * im) * np.exp(1j * ph)
    rng = np.random.default_rng(4)
    sigma = np.sqrt(np.mean(np.abs(iq) ** 2) / (2 * 10 ** (10 / 10)))
    iq = iq + sigma * (rng.standard_normal(iq.shape)
                       + 1j * rng.standard_normal(iq.shape))
    return iq.real.astype(np.float32), iq.imag.astype(np.float32)


@pytest.mark.parametrize("decoders", [("sync", "schf", "ndb"), ("schf",),
                                      ("fused",)])
def test_locked_step_bits(decoders):
    slots, _, _ = _mixed_slots(n_carriers=3, n_slots=5, seed=6)
    slots[0, 1, 240:250] ^= 1            # a lost training sequence
    slots[1, 2, 100:104] ^= 1
    slots[2, 3, 300:340] ^= 1
    inits = np.asarray([INIT, INIT, 3], np.uint32)
    got = steady.locked_step_bits(t(slots), t(inits), decoders=decoders)
    want = j_steady.locked_step_bits(jnp.asarray(slots), jnp.asarray(inits),
                                     decoders=decoders)
    _same(got, want)


@pytest.mark.parametrize("capture", ["clean", "snr8", "cfo_ramp"])
@pytest.mark.parametrize("fast,phase_bit,decoders", [
    (True, 64, ("fused",)),
    ("pallas", 64, ("fused",)),
    ("pallas", 64, ("sync", "schf", "ndb")),
    ("pallas", 63, ("fused",)),
    ("slotwise", 64, ("fused",)),
    ("soft", 64, ("fused",)),
])
def test_locked_step_ri(capture, fast, phase_bit, decoders):
    re, im = _capture(capture)
    inits = np.full(2, steady_fixture.load()["init"], np.uint32)
    n_slots = 64 if phase_bit == 64 else None
    got = steady.locked_step_ri(t(re), t(im), t(inits), phase_bit=phase_bit,
                                n_slots=n_slots, fast=fast, decoders=decoders)
    want = j_steady.locked_step_ri(jnp.asarray(re), jnp.asarray(im),
                                   jnp.asarray(inits), phase_bit=phase_bit,
                                   n_slots=n_slots, fast=fast,
                                   decoders=decoders)
    _same(got, want)
    if capture == "clean" and phase_bit == 64:
        assert n(got["crc_ok"]).all()


def test_soft_slotwise_values():
    re, im = _capture("snr8")
    got = n(dqpsk.demodulate_soft_slotwise_ri(t(re), t(im), 64,
                                              phase_bit=64))
    want = np.asarray(j_dqpsk.demodulate_soft_slotwise_ri(
        jnp.asarray(re), jnp.asarray(im), 64, phase_bit=64))
    assert np.abs(got - want).max() <= 1e-5
    assert np.array_equal(got <= 0, want <= 0)


def test_locked_step_iq():
    re, im = _capture("clean")
    iq = re + 1j * im
    inits = np.full(2, INIT, np.uint32)
    got = steady.locked_step_iq(iq, inits, phase_bit=64, n_slots=64,
                                device="cpu")
    want = j_steady.locked_step_iq(jnp.asarray(iq), jnp.asarray(inits),
                                   phase_bit=64, n_slots=64)
    _same(got, want)


@pytest.mark.parametrize("fast", ["eq", False])
def test_unported_fast_modes_raise(fast):
    """The two modes that raised NotImplementedError until they were
    ported now run and equal the JAX chain on the clean capture; what
    stays refused raises ValueError: the equaliser at sps 4 (the JAX
    package asserts sps 2) and an unknown mode."""
    re, im = steady_fixture.capture(1)
    inits = np.asarray([INIT], np.uint32)
    got = steady.locked_step_ri(t(re), t(im), t(inits), phase_bit=64,
                                n_slots=64, fast=fast, decoders=("fused",))
    want = j_steady.locked_step_ri(jnp.asarray(re), jnp.asarray(im),
                                   jnp.asarray(inits), phase_bit=64,
                                   n_slots=64, fast=fast,
                                   decoders=("fused",))
    _same(got, want)
    with pytest.raises(ValueError):
        steady.locked_step_ri(t(re), t(im), t(inits), phase_bit=64,
                              n_slots=32, fast=fast if fast else "angle",
                              sps=4)


def test_slice_runs_without_jax():
    """A fresh interpreter decodes the fixture through fast="pallas" with
    both decoder sets and never imports jax."""
    code = """
import sys
import numpy as np
import torch
from tetra_tpu_torch import steady_fixture as sf
from tetra_tpu_torch.lmac.steady import locked_step_ri
fx = sf.load()
re, im = sf.capture(2, fx=fx)
for dec in (("fused",), ("sync", "schf", "ndb")):
    out = locked_step_ri(torch.as_tensor(re), torch.as_tensor(im),
                         np.full(2, fx["init"]), phase_bit=64, n_slots=64,
                         fast="pallas", decoders=dec)
    assert bool(out["crc_ok"].all())
    idx = sf.slot_index(2)
    assert np.array_equal(out["kinds"].numpy(), fx["kinds"][idx])
    assert np.array_equal(out["schf"].type1.numpy()[fx["kinds"][idx] == 1],
                          fx["schf"][idx][fx["kinds"][idx] == 1])
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("ok")
"""
    env = dict(os.environ, OMP_NUM_THREADS="2")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_fixture_rebuilds_tx_slots():
    """The committed fixture equals the JAX TX chain's slots, kinds and
    payloads bit for bit, and the rebuilt carriers are the slots rolled
    by whole slots between 64 zero bits."""
    sys.path.insert(0, str(ROOT / "tools"))
    import make_torch_fixture
    slots, kinds, pay, init = make_torch_fixture.steady_slots()
    fx = steady_fixture.load()
    assert np.array_equal(fx["slots"], slots) and fx["init"] == init
    assert np.array_equal(fx["kinds"], kinds)
    for k, v in pay.items():
        assert np.array_equal(fx[k], v), k
    bits = steady_fixture.carrier_bits(3, fx)
    assert bits.shape == (3, 32_768)
    assert np.array_equal(bits[2, 64:64 + 510], slots[2])
    assert not bits[:, :64].any() and not bits[:, -64:].any()
