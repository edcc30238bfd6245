"""PHY front end of the PyTorch port vs tetra_tpu on the CPU: ingest
dequantization, the PFB channelizer + resampler (kernels K2/K3, plain
versions here) and the hard demod."""
import numpy as np
import pytest
import jax.numpy as jnp

from tests._torch_util import t, n

from tetra_tpu.io import stream as j_stream
from tetra_tpu.phy import pfb as j_pfb, dqpsk as j_dqpsk, burst as j_burst
from tetra_tpu.phy.pfb_pallas import (pfb_channelize_rows_pallas,
                                      resample_rows_pallas)

from tetra_tpu_torch.io import stream
from tetra_tpu_torch.phy import pfb, dqpsk, burst
from tetra_tpu_torch import prod_fixture


def _noise(T, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(T).astype(np.float32),
            rng.standard_normal(T).astype(np.float32))


def test_dequantize_iq4c_exact():
    raw = np.random.default_rng(0).integers(0, 256, 5000).astype(np.uint8)
    for x, y in zip(stream.dequantize_iq4c(t(raw)),
                    j_stream.dequantize_iq4c(jnp.asarray(raw))):
        assert np.array_equal(n(x), np.asarray(y))
    for x, y in zip(stream.dequantize_iq4(t(raw)),
                    j_stream.dequantize_iq4(jnp.asarray(raw))):
        assert np.array_equal(n(x), np.asarray(y))


@pytest.mark.parametrize("n_chan", [8, 16])
def test_pfb_resampler_vs_pallas_interpret(n_chan):
    """K2 + K3 plain versions == the Pallas kernels in interpret mode
    at f32 (zero fill at the stream edges on both sides): atol 1e-5."""
    T = 2400 * n_chan
    re, im = _noise(T, n_chan)
    fe = pfb.PfbFrontEnd(n_chan, 25_000.0 * n_chan)
    yr, yi = pfb.pfb_channelize_rows(t(re), t(im), fe.h, fe.twc, fe.tws,
                                     n_chan, fe.J)
    jr, ji = pfb_channelize_rows_pallas(jnp.asarray(re), jnp.asarray(im),
                                        n_chan, interpret=True,
                                        dft_bf16=False)
    np.testing.assert_allclose(n(yr), np.asarray(jr), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(yi), np.asarray(ji), atol=1e-5, rtol=0)
    n_out = fe.n_out(yr.shape[0])
    orr, oi = pfb.resample_rows(yr, yi, fe.rs_taps, fe.rs_off, fe.W,
                                fe.bmin, fe.L, fe.M, n_out)
    pr, pi = resample_rows_pallas(jr, ji, fe.chan_rate, 36_000.0,
                                  skew=fe.skew, interpret=True, bf16=False)
    assert orr.shape == pr.shape
    np.testing.assert_allclose(n(orr), np.asarray(pr), atol=1e-5, rtol=0)
    np.testing.assert_allclose(n(oi), np.asarray(pi), atol=1e-5, rtol=0)


def test_pfb_to_demod_rate_vs_xla_path():
    """The port's front end == tetra_tpu's CPU (XLA) path, whose
    resampler replicates edge samples: atol 1e-4 outside a 40-row
    margin at each end."""
    n_chan = 8
    re, im = _noise(30_000, 3)
    sel = np.asarray([5, 0, 3], np.int32)
    ar, ai = pfb.pfb_to_demod_rate_ri(t(re), t(im), t(sel, None).long(),
                                      n_chan, 2e5)
    br, bi = j_pfb.pfb_to_demod_rate_ri(jnp.asarray(re), jnp.asarray(im),
                                        jnp.asarray(sel), n_chan, 2e5)
    m = ar.shape[1]
    assert (ar.shape, ai.shape) == (br.shape, bi.shape)
    np.testing.assert_allclose(n(ar)[:, 40:m - 40],
                               np.asarray(br)[:, 40:m - 40], atol=1e-4,
                               rtol=0)
    np.testing.assert_allclose(n(ai)[:, 40:m - 40],
                               np.asarray(bi)[:, 40:m - 40], atol=1e-4,
                               rtol=0)


def test_pfb_odd_sizes():
    """A stream shorter than one filter and a non-power-of-two channel
    count both run (the kernel's direct-DFT branch, here the plain
    version) and match the XLA channelizer."""
    for n_chan, T in ((8, 100), (12, 4000)):
        re, im = _noise(T, T)
        fe = pfb.PfbFrontEnd(n_chan, 25_000.0 * n_chan)
        yr, yi = pfb.pfb_channelize_rows(t(re), t(im), fe.h, fe.twc,
                                         fe.tws, n_chan, fe.J)
        if T >= 16 * n_chan:
            jr, ji = j_pfb.pfb_channelize_ri(jnp.asarray(re),
                                             jnp.asarray(im), n_chan)
            np.testing.assert_allclose(n(yr), np.asarray(jr).T, atol=1e-5)
            np.testing.assert_allclose(n(yi), np.asarray(ji).T, atol=1e-5)
        else:
            assert yr.shape == (1, n_chan)


def test_demod_hard_identical_bits():
    """demodulate_hard_ri(os=4): identical bits on a clean 8-carrier
    baseband with a fractional timing offset (decisions with margin)."""
    bits, _ = prod_fixture.mixed_bits(8, 0.25)
    base = j_dqpsk.modulate(bits[:, :6000], sps=2)
    # half-sample delay through the upsampled domain
    up = np.fft.ifft(np.fft.fft(base, axis=1)
                     * np.exp(-1j * np.pi * np.fft.fftfreq(base.shape[1])),
                     axis=1)
    re, im = up.real.astype(np.float32), up.imag.astype(np.float32)
    got = n(dqpsk.demodulate_hard_ri(t(re), t(im), sps=2, os=4))
    want = np.asarray(j_dqpsk.demodulate_hard_ri(jnp.asarray(re),
                                                 jnp.asarray(im), sps=2,
                                                 os=4))
    assert got.shape == want.shape and np.array_equal(got, want)
    assert (got[:, 100:-100] != bits[:, 100:got.shape[1] - 100]).mean() \
        < 0.01


def test_split_norm_burst():
    x = np.random.default_rng(0).integers(0, 2, (3, 510)).astype(np.int8)
    for a, b in zip(burst.split_norm_burst(t(x)),
                    j_burst.split_norm_burst(jnp.asarray(x))):
        assert np.array_equal(n(a), np.asarray(b))


@pytest.mark.parametrize("n_chan", [8, 16])
def test_pfb_channelize_ri_vs_jax(n_chan):
    """The XLA-path channelizer (channel-major, DFT as two real matmuls)
    within 1e-5 of the JAX function's peak, on one stream and on a batch
    of two, and equal in layout to K2's plain rows transposed."""
    T = n_chan * 16 + 37 * n_chan // 2 + 5
    re, im = _noise(T, n_chan)
    jr, ji = (np.asarray(x) for x in j_pfb.pfb_channelize_ri(
        jnp.asarray(re), jnp.asarray(im), n_chan))
    r, i = (n(x) for x in pfb.pfb_channelize_ri(t(re), t(im), n_chan))
    peak = max(np.abs(jr).max(), np.abs(ji).max())
    assert r.shape == jr.shape == (n_chan, (T - 16 * n_chan) // (n_chan // 2) + 1)
    assert max(np.abs(r - jr).max(), np.abs(i - ji).max()) <= 1e-5 * peak
    br, bi = pfb.pfb_channelize_ri(t(np.stack([re, re[::-1]])),
                                   t(np.stack([im, im[::-1]])), n_chan)
    assert np.array_equal(n(br[0]), r) and np.array_equal(n(bi[0]), i)
    fe = pfb.PfbFrontEnd(n_chan, 25_000.0 * n_chan)
    yr, yi = pfb.pfb_channelize_rows(t(re), t(im), fe.h, fe.twc, fe.tws,
                                     n_chan, 16)
    assert max(np.abs(n(yr.T) - r).max(), np.abs(n(yi.T) - i).max()) \
        <= 1e-5 * peak
