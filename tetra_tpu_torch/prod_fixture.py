"""The production capture, rebuilt without jax.

`data/prod_mixed.npz` (written by tools/make_torch_fixture.py) holds the
two padded 16-frame protocol-mix rows of tools/bench_mc_e2e.mixed_batch
(plain and TEA1-encrypted) before the per-carrier circular roll, the
noise-window length the rolls are confined to, the JAX package's
recorded decode counts for the 1024-carrier production stage, and the
traffic dump and voice files its bits path writes for one plain and one
encrypted carrier (`expected_traffic`), and its wideband path's stats
and files on 8 named carriers of the 1024-carrier capture
(`wideband_record`), and its Python control plane's record
(`python_record`): the single-carrier TetraReceiver's log lines, TMV
records and files on one carrier of the 8-carrier capture, and the
per-carrier stats and log digests of the 1024-carrier capture's 8
named carriers. From them
this module rebuilds the bench's companded wideband capture with numpy
copies of the fixture chain: safe_rolls -> dqpsk.modulate ->
channelizer.synthesize_wideband_fft -> stream.quantize_iq4c.

`data/mixer_offgrid.npz` holds what the mixer-bank checks need
(`load_mixer`): the full-width off-grid configuration mixer-64 (carrier
k of mixed_bits(64, 0.1) at the exact spectrum bin nearest 25 kHz x
(k - 32) + 1,370 Hz of a 1.8 MS/s capture, the live CLI's default rate;
`mixer_capture` rebuilds its rtl_tcp u8 bytes: modulate,
channelizer.synthesize_wideband_bins, `u8_iq`), the two-cell capture's
bits of the JAX mixer test at 144 kHz (`small_capture`), the 400 kHz
two-cell u8 capture of the JAX scan test, and the JAX package's records
on all three (`mixer_record`).

`data/snr8_clean.npz` holds the padded clean 16-frame SYNC/SCH_F row of
tools/bench_mc_e2e.run_snr8 (bit-packed), its n_tail, the JAX package's
recorded counts for that stage and its soft path's stats on 16 named
carriers of the 1024-carrier capture (`soft_record`); `snr8_capture`
rebuilds the stage's noisy capture from it: tile, safe_rolls, modulate,
synthesize, AWGN at the per-channel SNR from default_rng(99),
quantize_iq4c.
"""
from __future__ import annotations

import contextlib
import os
import pathlib
import tempfile
import time

import numpy as np
import torch

from tetra_tpu_torch.io.stream import quantize_iq4c
from tetra_tpu_torch.phy.channelizer import DEMOD_RATE, \
    synthesize_wideband, synthesize_wideband_bins, synthesize_wideband_fft
from tetra_tpu_torch.phy.dqpsk import modulate

__all__ = ["DATA_PATH", "SNR8_PATH", "KEYSTORE", "BITRATE", "load",
           "load_snr8", "safe_rolls", "mixed_bits", "wideband_capture",
           "snr8_bits", "snr8_capture", "keystore_file", "run_receiver",
           "expected_traffic", "wideband_record", "soft_record",
           "python_record", "rx_small_bits", "line_logger", "digest",
           "read_tree", "MIXER_PATH", "MIXER_FS", "MIXER_CHUNK",
           "MIXER_LOG_CHANNELS", "mixer_bins", "u8_iq", "load_mixer",
           "mixer_capture", "small_capture", "mixer_record"]

DATA_PATH = pathlib.Path(__file__).parent / "data" / "prod_mixed.npz"
SNR8_PATH = pathlib.Path(__file__).parent / "data" / "snr8_clean.npz"
MIXER_PATH = pathlib.Path(__file__).parent / "data" / "mixer_offgrid.npz"
HEAD_NOISE = 731
BITRATE = 36_000.0     # bits/s per carrier: the real-time reference

# keystore of the encrypted carriers (tools/bench_mc_e2e.KEYSTORE):
# network 262/42, TEA1 static cipher key 7 = bytes 0xA0..0xA9
KEYSTORE = ("network mcc 262 mnc 42 ksg_type 1 security_class 2\n"
            "key mcc 262 mnc 42 addr 0 key_type 1 key_num 7 "
            "key A0A1A2A3A4A5A6A7A8A9\n")


def load(path=DATA_PATH) -> dict:
    """The fixture: rows 'plain' / 'enc' [L] uint8, 'n_tail', the JAX
    package's recorded counts ('ref_<key>' = [wideband path, bits
    path]) and its bits path's per-carrier (bursts, crc_ok, crc_wrong)
    on the 1024-carrier rows ('jax_bits_stats' [1024, 3])."""
    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    L = int(d["length"])
    d["plain"] = np.unpackbits(d["plain_packed"])[:L]
    d["enc"] = np.unpackbits(d["enc_packed"])[:L]
    return d


def expected_traffic(fx: dict) -> dict:
    """The fixture's traffic outputs: {'plain': {file name: bytes},
    'enc': {...}}, the files every plain (encrypted) carrier's dump
    directory must hold."""
    out = {"plain": {}, "enc": {}}
    ends = np.cumsum(fx["traffic_sizes"])
    blob = fx["traffic_bytes"].tobytes()
    for name, end, size in zip(fx["traffic_names"], ends,
                               fx["traffic_sizes"]):
        tag, fname = str(name).split("/", 1)
        out[tag][fname] = blob[end - size:end]
    return out


def wideband_record(fx: dict) -> dict:
    """The JAX wideband path's per-carrier record on the 1024-carrier
    capture (tools/make_torch_fixture.py wideband_parity): {channel:
    ((bursts, crc_ok, crc_wrong), {dump file name: bytes})}."""
    files = {int(c): {} for c in fx["jax_wideband_channels"]}
    ends = np.cumsum(fx["jax_wideband_traffic_sizes"])
    blob = fx["jax_wideband_traffic_bytes"].tobytes()
    for name, end, size in zip(fx["jax_wideband_traffic_names"], ends,
                               fx["jax_wideband_traffic_sizes"]):
        ch, fname = str(name).split("/", 1)
        files[int(ch)][fname] = blob[end - size:end]
    return {int(c): (tuple(int(v) for v in st), files[int(c)])
            for c, st in zip(fx["jax_wideband_channels"],
                             fx["jax_wideband_stats"])}


# the single-carrier receiver's capture: carrier 7 (TEA1-encrypted) of
# mixed_bits(8, 0.25), the 8-carrier capture of the CPU tests
RX_SMALL = (8, 0.25, 7)


def rx_small_bits(fx: dict | None = None) -> np.ndarray:
    """The single-carrier receiver's capture [L] uint8 (RX_SMALL)."""
    n_car, enc_frac, c = RX_SMALL
    return mixed_bits(n_car, enc_frac, fx)[0][c]


def line_logger(lines: list):
    """A receiver `log` callable appending each line to `lines` as the
    tests join print's arguments."""
    return lambda *a: lines.append(" ".join(str(x) for x in a))


def digest(items) -> str:
    """sha256 hex of log lines (str) or TMV records (tuples), one per
    line."""
    import hashlib
    text = "\n".join(x if isinstance(x, str) else ",".join(map(str, x))
                     for x in items)
    return hashlib.sha256(text.encode()).hexdigest()


def python_record(fx: dict) -> dict:
    """The JAX Python control plane's record (tools/make_torch_fixture.py
    pyplane): {"rx_small": {"log": [lines], "tmv": digest, "stats":
    (bursts, crc_ok, crc_wrong), "files": {name: bytes}} of tetra_tpu's
    TetraReceiver on rx_small_bits with the keystore, dumps and voice;
    "channels": {channel: ((bursts, crc_ok, crc_wrong), log digest)} of
    its MultiCarrierReceiver(control_plane="python") on 8 carriers of the
    1024-carrier capture}."""
    files = {}
    ends = np.cumsum(fx["jax_rx_small_file_sizes"])
    blob = fx["jax_rx_small_file_bytes"].tobytes()
    for name, end, size in zip(fx["jax_rx_small_file_names"], ends,
                               fx["jax_rx_small_file_sizes"]):
        files[str(name)] = blob[end - size:end]
    log = fx["jax_rx_small_log"].tobytes().decode().split("\0")
    return {"rx_small": {"log": log, "tmv": str(fx["jax_rx_small_tmv"]),
                         "stats": tuple(int(v) for v in
                                        fx["jax_rx_small_stats"]),
                         "files": files},
            "channels": {int(c): (tuple(int(v) for v in st), str(dg))
                         for c, st, dg in zip(fx["jax_python_channels"],
                                              fx["jax_python_stats"],
                                              fx["jax_python_log_digests"])}}


def soft_record(fx: dict) -> dict:
    """The JAX soft path's per-carrier record on the 1024-carrier snr8
    capture (tools/make_torch_fixture.py soft_parity): {channel:
    (bursts, crc_ok, crc_wrong)}."""
    return {int(c): tuple(int(v) for v in st)
            for c, st in zip(fx["jax_soft_channels"], fx["jax_soft_stats"])}


def read_tree(root) -> dict:
    """Every file under root: {relative path: bytes}, sorted by path."""
    root = pathlib.Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob("*")) if p.is_file()}


def load_snr8(path=SNR8_PATH) -> dict:
    """The snr8 fixture: 'row' [L] uint8 (the padded clean row),
    'n_tail', 'snr_db', the JAX record 'snr8_crc_ok', 'snr8_crc_err',
    'clean_crc_ok' (1024 carriers) and its soft path's per-carrier
    'jax_soft_channels' [16], 'jax_soft_stats' [16, 3]."""
    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    d["row"] = np.unpackbits(d["row_packed"])[:int(d["length"])]
    return d


def safe_rolls(n_car: int, L: int, n_tail: int, head: int = HEAD_NOISE,
               guard: int = 64) -> np.ndarray:
    """Per-carrier circular roll offsets whose start lands in the
    capture's screened noise (tail span or head span)."""
    W = n_tail + head - 2 * guard
    start0 = L - n_tail + guard
    pos = (start0 + (np.arange(n_car, dtype=np.int64) * 997
                     + np.arange(n_car) % 17) % W)
    return (L - pos % L) % L


def mixed_bits(n_car: int, enc_frac: float = 0.1, fixture: dict | None = None):
    """[n_car, L] protocol-mix bits (the last round(enc_frac * n_car)
    carriers encrypted), each row circularly rolled into the screened
    noise window — tools/bench_mc_e2e.mixed_batch(n_car, 16, enc_frac)."""
    fx = load() if fixture is None else fixture
    plain, enc = fx["plain"], fx["enc"]
    L = len(plain)
    n_enc = max(1, int(round(n_car * enc_frac)))
    bits = np.empty((n_car, L), np.uint8)
    bits[: n_car - n_enc] = plain
    bits[n_car - n_enc:] = enc
    rolls = safe_rolls(n_car, L, int(fx["n_tail"]))
    for c in range(n_car):
        bits[c] = np.roll(bits[c], rolls[c])
    return bits, n_enc


def wideband_capture(bits: np.ndarray,
                     snr_db: float | None = None) -> np.ndarray:
    """Per-carrier bits [C, L] -> the companded 4+4-bit wideband capture
    (one byte per complex sample) with carrier c on PFB channel c of C.
    snr_db adds AWGN at that per-channel SNR before quantisation, drawn
    from default_rng(99) in the order of bench_mc_e2e._wideband_pass
    (real part, then imaginary part)."""
    n_car = bits.shape[0]
    base = modulate(bits, sps=2)
    wide = synthesize_wideband_fft(base, np.arange(n_car), n_car)
    if snr_db is not None:
        rng = np.random.default_rng(99)
        sig = np.mean(np.abs(wide) ** 2) / n_car       # per-carrier power
        npow = sig * n_car / (10 ** (snr_db / 10))     # full-band noise
        wide = (wide + rng.normal(0, np.sqrt(npow / 2), wide.shape)
                + 1j * rng.normal(0, np.sqrt(npow / 2), wide.shape)
                ).astype(np.complex64)
    return quantize_iq4c(wide.real, wide.imag)


def snr8_bits(n_car: int, fixture: dict | None = None) -> np.ndarray:
    """[n_car, L] clean bits of the snr8 stage: the row tiled and each
    carrier circularly rolled into the screened noise window."""
    fx = load_snr8() if fixture is None else fixture
    row = fx["row"]
    bits = np.tile(row, (n_car, 1))
    rolls = safe_rolls(n_car, len(row), int(fx["n_tail"]))
    for c in range(n_car):
        bits[c] = np.roll(bits[c], rolls[c])
    return bits


def snr8_capture(n_car: int, fixture: dict | None = None) -> np.ndarray:
    """The snr8 stage's noisy companded capture at n_car carriers
    (bench_mc_e2e.run_snr8 at 1024)."""
    fx = load_snr8() if fixture is None else fixture
    return wideband_capture(snr8_bits(n_car, fx), float(fx["snr_db"]))


@contextlib.contextmanager
def keystore_file():
    """KEYSTORE written to a temporary file; yields its path."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "keys.txt")
        with open(path, "w") as f:
            f.write(KEYSTORE)
        yield path


def run_receiver(packed: np.ndarray, n_car: int, ks_path: str | None,
                 device, n_chunks: int = 4, demod: str = "hard",
                 gsmtap_addr: tuple | None = None, **egress):
    """One pass of the production path: a fresh MultiCarrierReceiver
    (carrier c on PFB channel c of n_car, native plane, keystore, demod,
    and the egress options dumpdir, decode_voice, gsmtap_host and
    tl_sdu_sink as given) fed `packed` in n_chunks process_iq4c calls.
    gsmtap_addr (host, port), if given, is where its GSMTAP packets go
    instead of gsmtap_host's GSMTAP port. Returns (receiver, wall
    seconds; on a card the clock stops after a synchronize)."""
    from tetra_tpu_torch.rx_multi import MultiCarrierReceiver
    dev = torch.device(device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    cuts = np.linspace(0, len(packed), n_chunks + 1).astype(int)
    sync()
    t0 = time.perf_counter()
    mrx = MultiCarrierReceiver(
        [], fs=25_000.0 * n_car, pfb_channels=np.arange(n_car),
        n_chan=n_car, keystore_path=ks_path, control_plane="native",
        demod=demod, device=dev, **egress)
    if gsmtap_addr is not None:
        mrx.gsmtap.addr = gsmtap_addr
    for k in range(n_chunks):
        mrx.process_iq4c(packed[cuts[k]:cuts[k + 1]],
                         final=k == n_chunks - 1)
    sync()
    return mrx, time.perf_counter() - t0


# mixer-64: the live CLI's defaults (tetra_tpu/receiver.py: --rate 1.8e6,
# 0.5 s chunks); 64 carriers 25 kHz apart, each 1,370 Hz off the grid
MIXER_FS = 1_800_000.0
MIXER_CHUNK = int(MIXER_FS // 2)
MIXER_CARRIERS = 64
MIXER_SKEW_HZ = 1_370.0
# carriers whose Python-plane log digests the record holds (57: the last
# plain one; 58-63 are TEA1-encrypted)
MIXER_LOG_CHANNELS = (0, 32, 57, 63)


def mixer_bins(n_car: int, n_in: int) -> np.ndarray:
    """Spectrum bins of the off-grid carriers of an n_in-sample stream at
    the demod rate: carrier k at the bin (1/dur Hz each) nearest 25 kHz x
    (k - n_car/2) + MIXER_SKEW_HZ, so the FFT synthesis places it
    exactly."""
    dur = n_in / DEMOD_RATE
    hz = 25_000.0 * (np.arange(n_car) - n_car // 2) + MIXER_SKEW_HZ
    return np.round(hz * dur).astype(np.int64)


def u8_iq(wide: np.ndarray) -> np.ndarray:
    """Complex capture -> rtl_tcp's interleaved u8 I/Q, as
    tests/test_sdr.make_wideband makes it: complex AWGN of 3e-3 per
    component from default_rng(9), scaled to 1/1.05 of full scale,
    rounded about 127.5."""
    rng = np.random.default_rng(9)
    wide = wide + 3e-3 * (rng.standard_normal(len(wide))
                           + 1j * rng.standard_normal(len(wide))
                           ).astype(np.complex64)
    wide /= np.abs(wide).max() * 1.05
    u8 = np.empty(2 * len(wide), np.uint8)
    u8[0::2] = np.round(wide.real * 127.5 + 127.5).astype(np.uint8)
    u8[1::2] = np.round(wide.imag * 127.5 + 127.5).astype(np.uint8)
    return u8


def load_mixer(path=MIXER_PATH) -> dict:
    """The mixer fixture's arrays, with 'small_bits' [2, L] unpacked."""
    with np.load(path) as z:
        d = {k: z[k] for k in z.files}
    d["small_bits"] = np.unpackbits(d["small_bits_packed"], axis=1)[
        :, :int(d["small_len"])]
    return d


def mixer_capture(bits: np.ndarray, bins: np.ndarray) -> np.ndarray:
    """Per-carrier bits [C, L] -> the u8 capture at MIXER_FS with carrier
    c on spectrum bin bins[c] (mixer-64: mixed_bits(64, 0.1) and the
    stored mixer_bins)."""
    wide = synthesize_wideband_bins(modulate(bits, sps=2), bins, MIXER_FS)
    return u8_iq(wide)


def small_capture(fxm: dict) -> tuple[np.ndarray, np.ndarray, float]:
    """The JAX mixer test's two-cell capture: (complex64 samples,
    offsets [2] float32, fs)."""
    offsets = fxm["small_offsets"]
    fs = float(fxm["small_fs"])
    wide = synthesize_wideband(modulate(fxm["small_bits"], sps=2),
                               offsets, fs=fs)
    return wide, offsets, fs


def mixer_record(fxm: dict) -> dict:
    """The JAX package's records (tools/make_torch_fixture.py mixer):

    - "mixer": {carrier: ((bursts, crc_ok, crc_wrong), (mcc, mnc, cc))}
      of its mixer-bank receiver on mixer-64 (Python plane, keystore,
      run_rtltcp's 0.5 s chunks; its native plane gives the same),
      "mixer_logs": {carrier: log digest} on MIXER_LOG_CHANNELS, and
      "detect": (offsets, snr_db, power_db of each raster channel) of
      scan.detect_carriers on it;
    - "small": per carrier ((bursts, slots, crc_ok, crc_wrong), (mcc,
      mnc, cc), [RESOURCE SSIs]) on the two-cell 144 kHz capture;
    - "scan": per candidate (offset, snr_db, confirmed, (mcc, mnc, cc),
      crc_ok) of scan.scan(confirm=True) on the 400 kHz u8 capture, and
      "auto": per carrier ((bursts, crc_ok, crc_wrong), (mcc, mnc, cc))
      of its CLI's --rtltcp --carriers auto on that capture."""
    tup = lambda a: tuple(int(v) for v in a)
    return {
        "mixer": {c: (tup(st), tup(cell)) for c, (st, cell) in enumerate(
            zip(fxm["jax_mixer_stats"], fxm["jax_mixer_cells"]))},
        "mixer_logs": {int(c): str(d) for c, d in zip(
            fxm["jax_mixer_log_channels"], fxm["jax_mixer_log_digests"])},
        "detect": (fxm["jax_mixer_detect_offsets"],
                   fxm["jax_mixer_detect_snr"],
                   fxm["jax_mixer_channel_power"]),
        "small": [(tup(st), tup(cell), tup(ssi)) for st, cell, ssi in zip(
            fxm["jax_small_stats"], fxm["jax_small_cells"],
            fxm["jax_small_ssis"])],
        "scan": [(float(o), float(s), bool(k), tup(cell), int(ok))
                 for o, s, k, cell, ok in zip(
                     fxm["jax_scan_offsets"], fxm["jax_scan_snr"],
                     fxm["jax_scan_confirmed"], fxm["jax_scan_cells"],
                     fxm["jax_scan_crc_ok"])],
        "auto": [(tup(st), tup(cell)) for st, cell in zip(
            fxm["jax_auto_stats"], fxm["jax_auto_cells"])]}
