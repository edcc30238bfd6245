"""The PyTorch port's mixer-bank channelizer (tetra_tpu_torch.phy.
channelizer) vs tetra_tpu.phy.channelizer on the CPU.

The plans and the host synthesiser must equal the JAX package's byte for
byte. The device path (mix, 127-tap FIR, polyphase resampler) is held in
two parts, because the two oscillators differ on purpose: the JAX one
evaluates f32(n)/f32(fs) and its phase in float32, which at these
lengths is already 1e-4 to 1e-2 (of the output's peak) off a float64
oscillator, while the port's phase is exact (float64, (f*n) mod fs).

- The port's output against the JAX package's own FIR and resampler
  applied to the float64 oscillator's mix: max|d| <= 1e-4 * max|ref|.
- The port's output against the JAX package's channelize_ri: the
  difference is the JAX oscillator's own error, no more.
- Past 2^24 samples the port stays within 1e-5 of the float64 reference
  while the JAX output is off by the order of its peak.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_util import n, t

from tetra_tpu.phy import channelizer as J
from tetra_tpu.phy import dqpsk as JD

from tetra_tpu_torch.phy import channelizer as P

TOL = 1e-4
OFFSETS = np.array([-31_400.0, 13_700.0], np.float32)


def _planes(T: int, seed: int):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=T).astype(np.float32),
            rng.normal(size=T).astype(np.float32))


def _ref64(re, im, offsets, fs: float, base: int):
    """The float64 numpy oscillator's mix (phase 2*pi*((f*n) mod fs)/fs),
    cast to float32, through the JAX package's FIR and resampler."""
    nn = np.arange(len(re), dtype=np.float64) + base
    ph = 2 * np.pi * np.mod(offsets.astype(np.float64)[:, None] * nn, fs) / fs
    z = (re + 1j * im).astype(np.complex128)[None] * np.exp(-1j * ph)
    taps = J.design_lowpass(fs, 12_500.0, 127)
    return [np.asarray(J._resample_ri_one(
        JD._fir_real(jnp.asarray(m.astype(np.float32)), taps), len(re), fs,
        36_000.0)) for m in (z.real, z.imag)]


def _jax(re, im, offsets, fs: float, base: int):
    jr, ji = J.channelize_ri(jnp.asarray(re), jnp.asarray(im),
                             jnp.asarray(offsets), fs=fs,
                             base=np.int32(base))
    return [np.asarray(jr), np.asarray(ji)]


def _port(re, im, offsets, fs: float, base: int):
    return [n(x) for x in P.channelize_ri(t(re), t(im), offsets, fs,
                                          base=base)]


def _err(a, b) -> float:
    return max(float(np.abs(x - y).max()) for x, y in zip(a, b))


@pytest.mark.parametrize("fs", [96_000.0, 144_000.0, 400_000.0, 1.8e6,
                                2.048e6, 150_001.0])
def test_plans_equal_jax(fs):
    """design_lowpass, _resample_plan, _rational_ratio and
    _resample_block_plan give the JAX package's arrays byte for byte."""
    assert np.array_equal(P.design_lowpass(fs, 12_500.0, 127),
                          J.design_lowpass(fs, 12_500.0, 127))
    assert P._rational_ratio(fs, 36_000.0) == J._rational_ratio(fs, 36_000.0)
    for n_in in (0, 9, 5_000, 20_011):
        for a, b in zip(P._resample_plan(n_in, fs, 36_000.0),
                        J._resample_plan(n_in, fs, 36_000.0)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        pa = P._resample_block_plan(n_in, fs, 36_000.0)
        pb = J._resample_block_plan(n_in, fs, 36_000.0)
        assert (pa is None) == (pb is None)
        if pa is not None:
            assert np.array_equal(pa[0], pb[0]) and pa[1:] == pb[1:]


@pytest.mark.parametrize("fs,base", [(144_000.0, 0), (144_000.0, 100_000),
                                     (150_001.0, 0), (150_001.0, 100_000),
                                     (96_000.0, 0), (2.048e6, 0)])
def test_channelize_ri_matches_jax(fs, base):
    """The port against the JAX FIR + resampler on the exact mix within
    TOL, and against the JAX channelize_ri output up to that output's own
    oscillator error (the generic gather branch at 150,001 Hz)."""
    re, im = _planes(20_000, int(fs) % 97 + base % 89)
    ref = _ref64(re, im, OFFSETS, fs, base)
    got = _port(re, im, OFFSETS, fs, base)
    jax_out = _jax(re, im, OFFSETS, fs, base)
    scale = max(float(np.abs(x).max()) for x in ref)
    assert [g.shape for g in got] == [r.shape for r in jax_out]
    assert _err(got, ref) <= TOL * scale
    assert _err(got, jax_out) <= _err(jax_out, ref) + TOL * scale


def test_channelize_complex_matches_jax():
    """channelize (complex in, complex64 out) against the JAX package's
    channelize, which mixes with a complex64 oscillator at base 0."""
    re, im = _planes(6_000, 3)
    fs = 144_000.0
    wide = (re + 1j * im).astype(np.complex64)
    got = n(P.channelize(torch.as_tensor(wide), OFFSETS, fs))
    want = np.asarray(J.channelize(jnp.asarray(wide), jnp.asarray(OFFSETS),
                                   fs=fs))
    ref = _ref64(re, im, OFFSETS, fs, 0)
    ref = ref[0] + 1j * ref[1]
    assert got.dtype == np.complex64 and got.shape == want.shape
    scale = float(np.abs(ref).max())
    assert np.abs(got - ref).max() <= TOL * scale
    assert np.abs(got - want).max() <= np.abs(want - ref).max() + TOL * scale


@pytest.mark.parametrize("base", [(1 << 24) + 12_345, (1 << 31) + 777])
def test_long_stream_oscillator(base):
    """Past 2^24 samples (and past the int32 range) the port stays within
    1e-5 of the float64 oscillator; the JAX output (where its int32 base
    exists at all) is off by the order of its peak."""
    re, im = _planes(8_000, 5)
    fs = 144_000.0
    ref = _ref64(re, im, OFFSETS, fs, base)
    scale = max(float(np.abs(x).max()) for x in ref)
    assert _err(_port(re, im, OFFSETS, fs, base), ref) <= 1e-5 * scale
    if base < 1 << 31:
        assert _err(_jax(re, im, OFFSETS, fs, base), ref) > 0.1 * scale


def test_chunked_oscillator_is_bit_identical():
    """The mix at absolute sample indices: a slice of a whole-stream mix
    equals the mix of that slice at its base, bit for bit."""
    re, im = _planes(10_000, 7)
    whole = P._mix_ri(t(re), t(im), OFFSETS, 1.8e6, base=3)
    part = P._mix_ri(t(re[4_097:]), t(im[4_097:]), OFFSETS, 1.8e6,
                     base=3 + 4_097)
    for a, b in zip(whole, part):
        assert torch.equal(a[:, 4_097:], b)


def test_resampler_edges_replicate():
    """The block resampler pads by edge replication, as the JAX XLA path
    does (K3 zero-fills): a constant input resamples to that constant."""
    x = torch.full((2, 4_001), 0.75)
    for fs in (144_000.0, 2.048e6, 150_001.0):
        y = P._resample_ri_one(x, 4_001, fs, 36_000.0)
        want = np.asarray(J._resample_ri_one(jnp.asarray(n(x)), 4_001, fs,
                                             36_000.0))
        assert y.shape == want.shape
        assert np.abs(n(y) - want).max() <= 1e-6
        assert np.abs(n(y) - 0.75).max() <= 1e-5


def test_synthesize_wideband_equals_jax():
    """The host synthesisers equal the JAX package's byte for byte; the
    bin form at a channel's bins is synthesize_wideband_fft."""
    rng = np.random.default_rng(11)
    base = (rng.normal(size=(3, 900))
            + 1j * rng.normal(size=(3, 900))).astype(np.complex64)
    offs = np.array([-31_400.0, 0.0, 25_000.0], np.float32)
    assert np.array_equal(P.synthesize_wideband(base, offs, 144_000.0),
                          J.synthesize_wideband(base, offs, 144_000.0))
    chans = [1, 6, 3]
    fft = J.synthesize_wideband_fft(base, chans, 8)
    assert np.array_equal(P.synthesize_wideband_fft(base, chans, 8), fft)
    dur = 900 / 36_000.0
    bins = [round(c * 25_000.0 * dur) for c in chans]
    assert np.array_equal(P.synthesize_wideband_bins(base, bins, 2e5), fft)


# kernel M1 (csrc/mixer_bank.cu): a lane sums this many outputs at once
M1_RO = 8
M1_RATES = [1.8e6, 2.4e6, 2.048e6]      # L/M = 50/1, 200/3, 512/9
M1_BASES = [0, 100_000, (1 << 24) + 7]
M1_OFFSETS = np.array([-31_400.0, 413_700.25], np.float32)


def m1_model(re, im, offsets, fs: float, base: int, ntaps: int = 127):
    """Kernel M1's arithmetic in numpy, from the wrapper's own tables
    (_fused_tables) and tile (_fused_shape), summed in float64: block
    t * n_ct + ct owns carrier tile ct and the tile of QB q-blocks x RB
    phases t; its window of SPAN samples starts at max(Q0*L + b[R0], 0)
    - pad, zero outside [0, T); groups of M1_RO outputs in phase-major
    order, each output its window at max(p, 0) - pad with filter r (M +
    m for the E first), rotated by the float64 oscillator at the
    window's absolute index (cos and sin cast to float32), through the
    [2, 32, TP] tile in q-major order. Returns (yr, yi) and asserts that
    every output is written once, every window read lies in the block's
    window and the resampler's reads never clamp at the far end."""
    G, f, b, L, M, E, K, pad = P._fused_tables(
        fs, tuple(np.asarray(offsets, np.float32).tolist()), ntaps, 36_000.0)
    QB, RB, SPAN, TP, _ = P._fused_shape(L, M, b, K)
    T = len(re)
    n_out = P._resample_block_plan(T, fs, 36_000.0)[5]
    C, Cp = len(offsets), G.shape[2]
    n_q, n_rt, n_ct = -(-n_out // M), -(-M // RB), Cp // 32
    x = re.astype(np.float64) + 1j * im.astype(np.float64)
    Gd = G.astype(np.complex128)
    y = np.zeros((2, C, n_out))
    hits = np.zeros((C, n_out), np.int64)
    for blk in range(-(-n_q // QB) * n_rt * n_ct):
        t_, ct = divmod(blk, n_ct)
        qt, rt = divmod(t_, n_rt)
        Q0, R0 = qt * QB, rt * RB
        Qn, Rn = min(QB, n_q - Q0), min(RB, M - R0)
        ws = max(Q0 * L + int(b[R0]), 0) - pad
        idx = ws + np.arange(SPAN)
        win = np.where((idx >= 0) & (idx < T), x[np.clip(idx, 0, T - 1)], 0)
        cs = ct * 32 + np.arange(32)
        tile = np.zeros((2, 32, TP))
        n_tile = Qn * Rn
        for g in range(-(-n_tile // M1_RO)):
            for j in range(M1_RO):
                rr, qq = divmod(g * M1_RO + j, Qn)
                q, r = Q0 + qq, R0 + rr
                m = q * M + r
                if g * M1_RO + j >= n_tile or m >= n_out:
                    continue
                p = q * L + int(b[r])
                assert p + 7 <= T - 1
                off = max(p, 0) - pad - ws
                assert 0 <= off and off + K <= SPAN
                fi = M + m if m < E else r
                acc = (Gd[fi][:, cs] * win[off:off + K, None]).sum(0)
                ph = np.remainder(f[cs] * float(base + ws + off), fs) \
                    * (2.0 * np.pi / fs)
                osc = (np.cos(ph).astype(np.float32)
                       - 1j * np.sin(ph).astype(np.float32))
                val = osc * acc
                u = qq * Rn + rr
                assert u < TP
                tile[0, :, u], tile[1, :, u] = val.real, val.imag
        for v in range(n_tile):
            qq, rr = divmod(v, Rn)
            m = (Q0 + qq) * M + R0 + rr
            for k, c in enumerate(cs):
                if m < n_out and c < C:
                    y[:, c, m] = tile[:, k, v]
                    hits[c, m] += 1
    assert (hits == 1).all()
    return y[0].astype(np.float32), y[1].astype(np.float32)


def _m1_feeds(fs: float) -> list[int]:
    """Feed lengths from shorter than the FIR to a few of the mixer
    stream's BLOCKs."""
    from tetra_tpu_torch.rx_multi import mixer_block
    block = mixer_block(fs)[0]
    return [60, 126, 1_000, block + 3, 3 * block + 77]


@pytest.mark.parametrize("base", M1_BASES)
@pytest.mark.parametrize("fs", M1_RATES)
def test_m1_model_matches_plain(fs, base):
    """The model of kernel M1 (composed, modulated taps; only the outputs
    the resampler reads) equals the plain path (_mix_ri, _fir_real,
    _resample_ri_one) within 1e-5 of max|plain|, including its zero-
    padded FIR and replicated resampler edges, on feeds from shorter
    than the FIR to a few BLOCKs."""
    for T in _m1_feeds(fs):
        re, im = _planes(T, T % 101 + base % 7)
        want = [n(v) for v in P.channelize_ri_plain(
            t(re), t(im), M1_OFFSETS, fs, base=base)]
        got = m1_model(re, im, M1_OFFSETS, fs, base)
        assert [g.shape for g in got] == [w.shape for w in want]
        if want[0].size:
            scale = max(float(np.abs(w).max()) for w in want)
            assert _err(got, want) <= 1e-5 * scale, \
                (T, _err(got, want) / scale)


@pytest.mark.parametrize("fs", M1_RATES + [96_000.0, 24_000.0, 25.6e6])
def test_m1_tables_follow_the_block_plan(fs):
    """_fused_tables places phase r where _resample_block_plan put W's
    column r (all its weight inside the 8 rows from b[r]); the E edge
    filters are the outputs whose first FIR read lies before the feed;
    the tile fits a block and holds every output's window."""
    W, bmin, width, L, M, _, _ = P._resample_block_plan(0, fs, 36_000.0)
    G, f, b, L2, M2, E, K, pad = P._fused_tables(
        fs, tuple(M1_OFFSETS.tolist()), 127, 36_000.0)
    assert (L2, M2, K, pad) == (L, M, 134, 63)
    assert G.shape == (M + E, K, 32) and not G[:, :, 2:].any()
    for r in range(M):
        lo = b[r] - bmin
        assert not W[:lo, r].any() and not W[lo + 8:, r].any()
        assert np.abs(W[lo:lo + 8, r]).sum() > 0
    p = [(e // M) * L + b[e % M] for e in range(E + 1)]
    assert all(v < 0 for v in p[:E]) and p[E] >= 0
    QB, RB, SPAN, TP, smem = P._fused_shape(L, M, b, K)
    assert TP % 2 == 1 and TP >= QB * RB and smem <= P.M1_SMEM_MAX
    # the uploaded copy: G as interleaved float32 pairs, carriers last
    Gt, ft, bt, ints, shape = P._fused_constants(
        torch.device("cpu"), fs, tuple(M1_OFFSETS.tolist()), 127, 36_000.0)
    assert Gt.is_contiguous() and Gt.shape == (M + E, K, 64)
    assert np.array_equal(n(Gt)[..., 0::2] + 1j * n(Gt)[..., 1::2], G)
    assert np.array_equal(n(ft), f) and np.array_equal(n(bt), b)
    assert ints == (L, M, E, K, pad) and shape == (QB, RB, SPAN, TP, smem)


def test_channelize_ri_counts_the_plain_path():
    """On the CPU every channelize_ri call takes the plain path and says
    so in the counters (utils.trace, tracing on); nothing counts with
    tracing off."""
    from tetra_tpu_torch.utils import trace
    re, im = _planes(3_000, 2)
    trace.reset()
    trace.set_level(1)
    try:
        P.channelize_ri(t(re), t(im), OFFSETS, 1.8e6)
        P.channelize_ri(t(re), t(im), OFFSETS, 150_001.0)
        counts = trace.counters()
    finally:
        trace.set_level(0)
    assert counts.get("mixer.plain") == 2 and "mixer.fused" not in counts
    trace.reset()
    P.channelize_ri(t(re), t(im), OFFSETS, 1.8e6)
    assert trace.counters() == {}
