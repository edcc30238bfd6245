"""The PyTorch port's mixer-bank MultiCarrierReceiver (offsets_hz without
pfb_channels) vs tetra_tpu's on the CPU.

The capture is the two-cell scenario of tests/test_rx_multi at 144 kHz
with the carriers off the 25 kHz grid (-31,400 and +13,700 Hz), fed as
complex samples (process_iq), interleaved int8 (process_iq8) and
companded 4+4-bit IQ (process_iq4c). Per carrier the stats, cell
identity, RESOURCE SSIs and log lines (Python plane) and the native
event arrays (native plane) must equal the JAX package's; a chunked
stream must equal a whole one; demod="soft" must give the JAX stats
and warn that the mixer bank demodulates hard.
"""
import numpy as np
import pytest

from tests._torch_util import CPU
from tests.test_rx_multi import _capture_bits
from tests.test_torch_rx_multi import _same_receivers

from tetra_tpu import rx_multi as jax_rx_multi
from tetra_tpu.rx_multi import MultiCarrierReceiver as JaxReceiver
from tetra_tpu.umac import native_exec

from tetra_tpu_torch import prod_fixture
from tetra_tpu_torch.io import stream
from tetra_tpu_torch.phy import channelizer, dqpsk
from tetra_tpu_torch.rx_multi import MultiCarrierReceiver, \
    mixer_demod_bits_len

FS = 144_000.0
OFFSETS = np.array([-31_400.0, 13_700.0], np.float32)
CUTS = [4097, 11_003, 23_456]      # the JAX test's unaligned cuts
CELLS = [(262, 42, 1), (901, 7, 5)]
SSIS = [[0x200, 0x201, 0x202], [0x300, 0x301, 0x302]]


@pytest.mark.parametrize("fs", [96_000.0, 144_000.0, 400_000.0, 1.8e6,
                                2.048e6, 150_001.0])
def test_bits_len_matches_jax_probe(fs):
    """The closed form equals the JAX package's jax.eval_shape probe."""
    for L in (0, 9, 4_097, 23_456, 100_003):
        assert mixer_demod_bits_len(L, fs, 2) == \
            jax_rx_multi._mixer_demod_bits_len(L, fs, 2), L


@pytest.fixture(scope="module")
def capture():
    """The two-cell capture: complex samples, iq8 and iq4c bytes."""
    a = _capture_bits(262, 42, 1, 0x200, seed=1)
    b = _capture_bits(901, 7, 5, 0x300, seed=2)
    n = min(len(a), len(b)) & ~1
    wide = channelizer.synthesize_wideband(
        dqpsk.modulate(np.stack([a[:n], b[:n]]), sps=2), OFFSETS, fs=FS)
    sig = float(np.sqrt(np.mean(np.abs(wide) ** 2) / 2))
    qr, qi = stream.quantize_iq(wide.real / (6 * sig), wide.imag / (6 * sig))
    return {"process_iq": wide,
            "process_iq8": np.stack([qr, qi], 1).reshape(-1),
            "process_iq4c": stream.quantize_iq4c(wide.real, wide.imag)}


def _run(cls, method, data, plane, cuts=None, **kw):
    """One receiver over `data` whole (cuts None) or cut at the given
    complex-sample indices: (receiver, per-carrier log lines)."""
    logs = [[], []]
    rx = cls(OFFSETS, fs=FS, control_plane=plane,
             log=[prod_fixture.line_logger(lg) for lg in logs], **kw)
    k = 2 if method == "process_iq8" else 1
    S = len(data) // k
    edges = [0] + [c for c in (cuts or []) if c < S] + [S]
    for i in range(len(edges) - 1):
        getattr(rx, method)(data[edges[i] * k:edges[i + 1] * k],
                            final=i == len(edges) - 2)
    return rx, logs


def _ssis(rx):
    return [e[1].addr.ssi for e in rx.umac.events
            if e[0] == "RESOURCE" and e[1].addr.type == 1]


def _stats(rx):
    return [(c.stats.bursts, c.stats.slots, c.stats.crc_ok, c.stats.crc_wrong,
             c.mcc, c.mnc, c.colour_code) for c in rx.carriers]


@pytest.mark.parametrize("method", ["process_iq", "process_iq8",
                                    "process_iq4c"])
def test_python_plane_matches_jax(capture, method):
    """Per carrier: stats, identity, SSIs and log lines equal the JAX
    Python plane's, whole and in the JAX test's cuts; both cells decode."""
    data = capture[method]
    ref, ref_logs = _run(JaxReceiver, method, data, "python")
    for cuts in (None, CUTS):
        got, logs = _run(MultiCarrierReceiver, method, data, "python", cuts,
                         device=CPU)
        assert _stats(got) == _stats(ref), cuts
        assert logs == ref_logs, cuts
        for c in range(2):
            assert _ssis(got.carriers[c]) == _ssis(ref.carriers[c]) == SSIS[c]
    assert [s[4:] for s in _stats(ref)] == CELLS
    assert all(s[2] > 0 and s[3] == 0 for s in _stats(ref))


@pytest.mark.skipif(not native_exec.available(),
                    reason="native library unavailable")
@pytest.mark.parametrize("method", ["process_iq", "process_iq4c"])
def test_native_plane_matches_jax(capture, method):
    """Native plane: stats, TDMA state, identity and the concatenated
    event arrays equal the JAX native plane's, whole and chunked."""
    data = capture[method]
    for cuts in (None, CUTS):
        ref, _ = _run(JaxReceiver, method, data, "native", cuts)
        got, _ = _run(MultiCarrierReceiver, method, data, "native", cuts,
                      device=CPU)
        _same_receivers(ref, got, 2)
        assert all(c.stats.crc_ok > 0 for c in ref.carriers)


def test_chunked_equals_whole(capture):
    """Overlap-save + the absolute-index oscillator: bits of a chunked
    stream equal the whole run's, so stats and logs do too (native plane
    carries no logs; the Python plane's are compared)."""
    wide = capture["process_iq"]
    whole, wl = _run(MultiCarrierReceiver, "process_iq", wide, "python",
                     device=CPU)
    for cuts in (CUTS, [2_050, 4_100, 8_200], [1, 5_000, 5_100, 9_999]):
        got, gl = _run(MultiCarrierReceiver, "process_iq", wide, "python",
                       cuts, device=CPU)
        assert _stats(got) == _stats(whole) and gl == wl, cuts


@pytest.mark.skipif(not native_exec.available(),
                    reason="native library unavailable")
def test_soft_demod_on_mixer_warns_and_matches_jax(capture):
    """demod="soft" with offsets: the JAX stats (hard bits enter the soft
    pipeline as full-confidence values) and a RuntimeWarning."""
    wide = capture["process_iq"]
    ref, _ = _run(JaxReceiver, "process_iq", wide, "native", CUTS,
                  demod="soft")
    with pytest.warns(RuntimeWarning, match="mixer bank"):
        got, _ = _run(MultiCarrierReceiver, "process_iq", wide, "native",
                      CUTS, demod="soft", device=CPU)
    _same_receivers(ref, got, 2)
    assert all(c.stats.crc_ok > 0 for c in got.carriers)


def test_non_rational_rate_is_stateless():
    """A rate whose fs/36k is not rational (150,001 Hz) runs per call
    with the oscillator at 0, as in the JAX package: equal stats."""
    a = _capture_bits(262, 42, 1, 0x200, seed=1)
    fs = 150_001.0
    wide = channelizer.synthesize_wideband(
        dqpsk.modulate(a[None, :len(a) & ~1], sps=2), OFFSETS[:1], fs=fs)
    out = []
    for cls, kw in ((JaxReceiver, {}), (MultiCarrierReceiver,
                                        {"device": CPU})):
        rx = cls(OFFSETS[:1], fs=fs, **kw)
        rx.process_iq(wide[:6_000], final=False)
        rx.process_iq(wide[6_000:], final=True)
        out.append(_stats(rx))
    assert out[0] == out[1]
    assert out[0][0][2] > 0
