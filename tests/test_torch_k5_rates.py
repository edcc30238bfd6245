"""Kernel K5 (the fused hard demod) at the rates other than 2 samples a
symbol, on the CPU: its plain version (what the CPU runs and what the
card's kernel is held to) against the JAX XLA demod and the Pallas
kernel in interpret mode at sps 1, 4 and 8, and the steady chain
locked_step_ri(fast="pallas", sps=4 and 1) against the JAX chain on a
4-carrier capture of the steady fixture modulated at that rate. Bits and
phase picks identical; metric sums within 1e-5 relative of the JAX
demod's own sums. At sps 1 both chains lose the same few slots of the
clean capture: the 11-tap RRC pair aliases at one sample a symbol."""
import numpy as np
import pytest
import jax.numpy as jnp

from tests._torch_util import t, n
from tests.test_demod_pallas import _signal
from tests.test_torch_steady import _jax_metric_sums

from tetra_tpu.lmac import steady as j_steady
from tetra_tpu.phy import dqpsk as j_dqpsk, demod_pallas as j_dp

from tetra_tpu_torch import steady_fixture as sf
from tetra_tpu_torch.lmac import steady
from tetra_tpu_torch.phy import demod_fused


@pytest.mark.parametrize("sps", [1, 4, 8])
@pytest.mark.parametrize("case", ["clean", "ragged"])
def test_k5_plain_vs_xla_and_pallas(sps, case):
    seed, C_, n_sym, trim, tc, tt = {"clean": (30, 3, 400, 0, 4, 256),
                                     "ragged": (31, 5, 301, 3, 4, 512)}[case]
    re, im = (np.array(x) for x in _signal(np.random.default_rng(seed + sps),
                                             C_, n_sym, sps=sps))
    if trim:                      # T no multiple of sps
        re, im = re[:, :-trim].copy(), im[:, :-trim].copy()
    bits, best, met = (n(x) for x in demod_fused.demod_fused(t(re), t(im),
                                                             sps))
    n_out = re.shape[1] // sps
    xla = np.asarray(j_dqpsk.demodulate_hard_ri(jnp.asarray(re),
                                                jnp.asarray(im), sps=sps))
    # the Pallas kernel's packed decisions of the picked phase (b0 | b1 << 1)
    sel = np.asarray(j_dp._demod_sel(jnp.asarray(re), jnp.asarray(im),
                                     sps=sps, tile_c=tc, tile_t=tt,
                                     interpret=True))
    assert bits.shape == (C_, 2 * n_out)
    assert np.array_equal(bits, xla)
    assert np.array_equal(sel, bits[:, 0::2] | (bits[:, 1::2] << 1))
    want = _jax_metric_sums(re, im, sps)
    assert met.shape == (C_, sps)
    assert np.array_equal(best, np.argmax(want, axis=-1))
    np.testing.assert_allclose(met, want, rtol=1e-5)


@pytest.mark.parametrize("sps,decoders", [(4, ("fused",)),
                                          (4, ("sync", "schf", "ndb")),
                                          (1, ("fused",))])
def test_locked_step_pallas_rates(sps, decoders):
    fx = sf.load()
    re, im = sf.capture(4, fx=fx, sps=sps)
    inits = np.full(4, fx["init"], np.uint32)
    got = steady.locked_step_ri(t(re), t(im), t(inits), phase_bit=64,
                                n_slots=64, sps=sps, fast="pallas",
                                decoders=decoders)
    want = j_steady.locked_step_ri(jnp.asarray(re), jnp.asarray(im),
                                   jnp.asarray(inits), phase_bit=64,
                                   n_slots=64, sps=sps, fast="pallas",
                                   decoders=decoders)
    assert got.keys() == want.keys()
    for k, v in want.items():
        for a, b in (zip(got[k], v) if isinstance(v, tuple)
                     else [(got[k], v)]):
            assert np.array_equal(n(a), np.asarray(b)), k
    ok = n(got["crc_ok"])
    assert ok.all() if sps == 4 else 0.95 < ok.mean() < 1


@pytest.mark.parametrize("sps", [0, 12])
def test_k5_rejects_other_rates(sps):
    re = np.zeros((1, 240), np.float32)
    with pytest.raises(ValueError):
        demod_fused.demod_fused(t(re), t(re), sps)
