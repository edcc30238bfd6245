"""The PyTorch port's live receiver CLI (tetra_tpu_torch.receiver), its
sources (io.sdr, io.udp, io.audio) and the carrier scan
(tetra_tpu_torch.scan) vs tetra_tpu's on the CPU.

The rtl_tcp client is driven by a mock rtl_tcp server on 127.0.0.1
(tools/rtl_tcp_mock.py, a process speaking the wire protocol); the UDP
path gets bits over loopback; the fcdp audio path reads 96 kHz stereo
s16le PCM with a +5 kHz calibration offset. Each runs through the JAX
package's entry point and the port's on the same bytes, and the
results (stats, cell identities, log lines, scan candidates, the
spectrum plot's text) must be equal.
"""
import io
import pathlib
import sys
import threading

import numpy as np
import pytest

from tests.test_audio import FS_AUDIO, _carrier_iq, _pcm_bytes
from tests.test_sdr import make_wideband

from tetra_tpu import receiver as jax_receiver
from tetra_tpu import scan as jax_scan
from tetra_tpu.io.sdr import RtlTcpSource as JaxRtlTcpSource
from tetra_tpu.phy import channelizer as jax_channelizer
from tetra_tpu.rx import TetraReceiver as JaxTetraReceiver
from tetra_tpu.umac import native_exec

from tetra_tpu_torch import prod_fixture, receiver, scan
from tetra_tpu_torch.io import sdr
from tetra_tpu_torch.io.audio import AudioPipeSource
from tetra_tpu_torch.io.udp import UdpSink, UdpSource

ROOT = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "tools"))
import rtl_tcp_mock  # noqa: E402

CPU = ["--device", "cpu"]
FS = 400_000.0


def test_rtltcp_protocol_and_samples():
    """Banner, tuner name, the command wire format and the u8 -> complex
    conversion of the port's copy against a mock server process."""
    rng = np.random.default_rng(0)
    payload = rng.integers(0, 256, size=8192, dtype=np.uint8)
    with rtl_tcp_mock.serve(payload) as srv:
        src = sdr.RtlTcpSource("127.0.0.1", srv.port, timeout=5.0)
        assert (src.tuner_name, src.tuner_gain_count) == ("R820T", 29)
        src.configure(freq_hz=392.5e6, rate_hz=1.8e6, gain_db=38.0, ppm=-2)
        iq = src.read(1024)
        re, im = src.read_ri(1024)
        src.close()
    f = (payload.astype(np.float32) - 127.5) / 127.5
    assert np.array_equal(iq, JaxRtlTcpSource._to_complex(payload[:2048]))
    np.testing.assert_allclose(re, f[2048:4096:2], rtol=1e-6)
    np.testing.assert_allclose(im, f[2049:4096:2], rtol=1e-6)
    cmds = dict(srv.commands)
    assert cmds[sdr.CMD_SAMPLE_RATE] == 1_800_000
    assert cmds[sdr.CMD_FREQ] == 392_500_000
    assert cmds[sdr.CMD_FREQ_CORRECTION] == (-2) & 0xFFFFFFFF
    assert cmds[sdr.CMD_GAIN_MODE] == 1 and cmds[sdr.CMD_GAIN] == 380


def _u8_formula(raw_u8: np.ndarray) -> np.ndarray:
    """The conversion _to_complex replaced: float32, then the complex sum
    of the strided halves through a complex temporary."""
    f = (raw_u8.astype(np.float32) - 127.5) * (1.0 / 127.5)
    return (f[0::2] + 1j * f[1::2]).astype(np.complex64)


def _u8_input(case: str) -> np.ndarray:
    if case == "all_pairs":          # every (I, Q) byte pair once
        k = np.arange(1 << 16)
        return np.stack([k & 255, k >> 8], 1).astype(np.uint8).ravel()
    if case == "sliced":             # a 0.5 s call cut at an even offset
        host = np.random.default_rng(2_147_483_653).integers(
            0, 256, 2 * 900_037, dtype=np.uint8)
        return host[2 * 37:]
    if case == "read_only":          # as RtlTcpSource.read passes it
        raw = np.frombuffer(np.random.default_rng(7).integers(
            0, 256, 4096, dtype=np.uint8).tobytes(), dtype=np.uint8)
        assert not raw.flags.writeable
        return raw
    return np.zeros(0, np.uint8)


@pytest.mark.parametrize("case", ["all_pairs", "sliced", "read_only",
                                  "empty"])
def test_u8_conversion_is_bit_exact(case):
    """_to_complex equals, bit for bit, the formula it replaced and the
    JAX package's conversion; its result is a fresh, C-contiguous,
    writable complex64 array that leaves the input as it was."""
    raw = _u8_input(case)
    before = raw.copy()
    got = sdr.RtlTcpSource._to_complex(raw)
    assert got.dtype == np.complex64 and got.shape == (len(raw) // 2,)
    assert got.flags.c_contiguous and got.flags.writeable
    for ref in (_u8_formula(raw), JaxRtlTcpSource._to_complex(raw)):
        assert ref.dtype == np.complex64
        assert np.array_equal(got.view(np.uint32), ref.view(np.uint32))
    assert np.array_equal(raw, before)
    again = sdr.RtlTcpSource._to_complex(raw)
    assert np.array_equal(again.view(np.uint32), got.view(np.uint32))
    assert not np.shares_memory(got, again)
    assert not np.shares_memory(got, raw)


def test_u8_conversion_odd_length_raises():
    """Half a sample is an error, as in the JAX package."""
    raw = np.arange(7, dtype=np.uint8)
    with pytest.raises(ValueError):
        JaxRtlTcpSource._to_complex(raw)
    with pytest.raises(ValueError):
        sdr.RtlTcpSource._to_complex(raw)


def _lines(out: list):
    return prod_fixture.line_logger(out)


def _rx_state(rx):
    return (rx.stats.bursts, rx.stats.crc_ok, rx.stats.crc_wrong, rx.mcc,
            rx.mnc, rx.colour_code)


def test_run_udp_bits_matches_jax():
    """receiver1udp analogue: one carrier's bits over UDP loopback in
    1024-byte datagrams, batched into 4096-bit chunks: the JAX
    receiver's log lines and stats."""
    bits = prod_fixture.rx_small_bits()[:12_000]
    out = []
    for run_udp, rx_cls, kw in (
            (jax_receiver.run_udp, JaxTetraReceiver, {}),
            (receiver.run_udp, receiver.TetraReceiver, {"device": "cpu"})):
        src = UdpSource(0, host="127.0.0.1", dtype=np.uint8)
        port = src.sock.getsockname()[1]
        src.close()

        def feed():
            sink = UdpSink("127.0.0.1", port)
            for i in range(0, len(bits), 1024):
                sink.send(bits[i:i + 1024])
            sink.close()

        lines = []
        rx = rx_cls(log=_lines(lines), **kw)
        timer = threading.Timer(0.3, feed)
        timer.start()
        run_udp(rx, port, "bits", sps=2, chunk_symbols=4096, timeout=1.5)
        timer.join()
        out.append((lines, _rx_state(rx)))
    assert out[0] == out[1]
    assert out[1][1][1] > 0


def test_audio_chain_matches_jax(tmp_path):
    """fcdp --audio: 96 kHz s16le PCM with a +5 kHz calibration through
    the port's CLI and through tetra_tpu.receiver.run_audio: the same log
    lines and stats, and the cell decoded."""
    cal = 5_000.0
    wide = jax_channelizer.synthesize_wideband(_carrier_iq(), [cal],
                                               fs=FS_AUDIO)
    pcm = tmp_path / "cap.s16"
    pcm.write_bytes(_pcm_bytes(wide))
    argv = ["--audio", str(pcm), "--calibration", str(cal)]
    ref_lines, got_lines = [], []
    ref = JaxTetraReceiver(log=_lines(ref_lines))
    jax_receiver.run_audio(ref, _audio_args(argv))
    got = receiver.TetraReceiver(log=_lines(got_lines), device="cpu")
    receiver.run_audio(got, _audio_args(argv))
    assert got_lines == ref_lines
    assert _rx_state(got) == _rx_state(ref)
    assert got.stats.crc_ok >= 8 and (got.mcc, got.mnc) == (262, 42)
    # the CLI entry point gives the same walk
    cli_lines = []
    receiver.main(argv + CPU, log=_lines(cli_lines))
    assert cli_lines == ref_lines


def _audio_args(argv):
    """The --audio options of the receiver CLI, parsed (both packages'
    run_audio read these)."""
    import argparse
    p = argparse.ArgumentParser()
    p.add_argument("--audio")
    p.add_argument("--calibration", default="0")
    p.add_argument("--audio-rate", type=float, default=96_000.0)
    p.add_argument("--audio-fmt", default="s16le")
    p.add_argument("--swap-iq", action="store_true")
    return p.parse_args(argv)


def _cli(main, payload, n, fs, carriers, plane, extra=()):
    """One --rtltcp CLI run against a mock server serving `payload`,
    streaming n samples after any scan: per-carrier (bursts, crc_ok,
    crc_wrong, mcc, mnc, cc), and whether the receiver took the PFB."""
    with rtl_tcp_mock.serve(payload) as srv:
        mrx = main(["--rtltcp", f"127.0.0.1:{srv.port}", "--freq",
                    "392500000", "--rate", str(fs), f"--carriers={carriers}",
                    "--secs", repr((n + 0.5) / fs), "--control-plane", plane,
                    *extra])
    assert dict(srv.commands)[sdr.CMD_FREQ] == 392_500_000
    return [_rx_state(c) for c in mrx.carriers], mrx.pfb_channels is not None


@pytest.fixture(scope="module")
def offgrid_u8():
    return make_wideband(FS, offsets_khz=(-31.4, 13.7))[0]


@pytest.mark.parametrize("plane", ["python", "native"])
def test_rtltcp_offgrid_matches_jax(offgrid_u8, plane):
    """Explicit off-grid carriers take the mixer bank: the JAX CLI's
    per-carrier stats and cells on both planes."""
    if plane == "native" and not native_exec.available():
        pytest.skip("native library unavailable")
    carriers = "-31400,13700"
    n = len(offgrid_u8) // 2
    ref = _cli(jax_receiver.main, offgrid_u8, n, FS, carriers, plane)
    got = _cli(receiver.main, offgrid_u8, n, FS, carriers, plane, CPU)
    assert got == ref and got[1] is False
    assert [s[3:] for s in got[0]] == [(262, 42, 1), (901, 7, 5)]
    assert all(s[1] > 0 and s[2] == 0 for s in got[0])


def test_rtltcp_auto_matches_jax():
    """--carriers auto: 1 s scan, confirm, then the on-grid carriers
    through the PFB, both planes of the port equal to the JAX CLI."""
    u8, _ = make_wideband(FS)
    payload = rtl_tcp_mock.scan_payload(u8, FS)
    n = len(u8) // 2
    ref = _cli(jax_receiver.main, payload, n, FS, "auto", "python")
    planes = ["python"] + (["native"] if native_exec.available() else [])
    for plane in planes:
        got = _cli(receiver.main, payload, n, FS, "auto", plane, CPU)
        assert got == ref, plane
    assert ref[1] is True
    assert sorted(s[3:] for s in ref[0]) == [(262, 42, 1), (901, 7, 5)]


def test_scan_matches_jax():
    """detect + confirm on the 400 kHz two-cell capture, and the plot."""
    u8, _ = make_wideband(FS)
    iq = sdr.RtlTcpSource._to_complex(u8)
    ref, (rc, rp, rf) = jax_scan.scan(iq, FS, confirm=True)
    got, (gc, gp, gf) = scan.scan(iq, FS, confirm=True, device="cpu")
    assert [sorted(r) for r in got] == [sorted(r) for r in ref]
    for a, b in zip(got, ref):
        assert abs(a.pop("snr_db") - b.pop("snr_db")) <= 1e-3
        assert a == b
    assert sorted(r["offset_hz"] for r in got if r["confirmed"]) == \
        [-25_000.0, 25_000.0]
    assert np.array_equal(gc, rc) and np.abs(gp - rp).max() <= 1e-3
    marks = [r["offset_hz"] for r in ref]
    txt = scan.render_spectrum(gc, gp, gf, marks=marks)
    assert txt == jax_scan.render_spectrum(rc, rp, rf, marks=marks)
    assert txt.count("<== carrier") == 2
    off, snr, _ = scan.detect_carriers(iq, FS, device="cpu")
    joff, jsnr, _ = jax_scan.detect_carriers(iq, FS)
    assert np.array_equal(off, joff) and np.abs(snr - jsnr).max() <= 1e-3


def test_scan_narrow_capture_fallback():
    """The narrow-capture fallback (96 kHz: fewer than 3 raster
    channels): the same PSD-peak offset estimate and confirmation."""
    wide = jax_channelizer.synthesize_wideband(_carrier_iq(n_sync=20),
                                               [25_000.0], fs=FS_AUDIO)
    ref, _ = jax_scan.scan(wide, FS_AUDIO, confirm=True)
    got, _ = scan.scan(wide, FS_AUDIO, confirm=True, device="cpu")
    assert len(got) == len(ref) == 1
    assert abs(got[0].pop("snr_db") - ref[0].pop("snr_db")) <= 1e-3
    assert got == ref and got[0]["confirmed"]


def test_audio_source_copy_reads_pcm():
    """The port's AudioPipeSource on a PCM byte stream in both formats."""
    rng = np.random.default_rng(1)
    z = (rng.normal(0, 0.2, 500) + 1j * rng.normal(0, 0.2, 500)) \
        .astype(np.complex64)
    for fmt in ("s16le", "f32le"):
        src = AudioPipeSource(io.BytesIO(_pcm_bytes(z, fmt)), fmt=fmt)
        got = np.concatenate(list(src.stream(chunk=171)))
        scale = np.abs(z).max() / np.abs(got).max()
        np.testing.assert_allclose(got * scale, z, atol=2e-2)
