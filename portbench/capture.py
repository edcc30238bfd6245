"""The benchmark's capture generator: a traffic mix and a configuration
-> one wideband capture, made on the card from the seed.

A PyTorch copy of the port's fixture chain (prod_fixture.mixed_bits,
phy.dqpsk.modulate, phy.channelizer.synthesize_wideband_fft / _bins,
io.stream.quantize_iq4c, prod_fixture.u8_iq), frozen here so that a
change to the program cannot change the yardstick. The protocol rows
are those of `data/prod_mixed.npz` (the 16-frame plain and TEA1 rows
of tools/bench_mc_e2e.mixed_batch). The seed draws each carrier's
circular roll inside the rows' screened noise window (so no carrier
starts mid-burst), which carriers carry the TEA1 row, and the noise of
a u8 capture; every seed gives the same rows, the same number of
encrypted carriers and the same lengths, so the work does not change
with the seed, only its order.
"""
from __future__ import annotations

import functools
import math
import pathlib

import numpy as np
import torch

DATA = pathlib.Path(__file__).resolve().parent / "data"
DEMOD_RATE = 36_000.0        # per-carrier sample rate at sps 2
HEAD_NOISE = 731             # noise bits before the first frame
GUARD = 64
SPACING = 25_000.0
# Lloyd-Max 16-level quantizer of a unit Gaussian (io.stream.LLOYD_MAX_16)
LLOYD_MAX_16 = np.array(
    [-2.733, -2.069, -1.618, -1.256, -0.9424, -0.6568, -0.3881, -0.1284,
     0.1284, 0.3881, 0.6568, 0.9424, 1.256, 1.618, 2.069, 2.733],
    np.float32)
_LM16_BOUNDS = ((LLOYD_MAX_16[:-1] + LLOYD_MAX_16[1:]) / 2).astype(
    np.float32)


def load_rows(name: str) -> dict:
    """The protocol rows of data/<name>.npz: 'plain', 'enc' [L] uint8
    and 'n_tail' (the noise bits after the last frame)."""
    with np.load(DATA / f"{name}.npz") as z:
        L = int(z["length"])
        return {"plain": np.unpackbits(z["plain_packed"])[:L],
                "enc": np.unpackbits(z["enc_packed"])[:L],
                "n_tail": int(z["n_tail"])}


def seed_generator(seed: int, device) -> torch.Generator:
    """A torch.Generator on `device` seeded with `seed` (any integer that
    fits 64 bits)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) & 0xFFFF_FFFF_FFFF_FFFF)
    return g


def draw_layout(n_car: int, L: int, n_tail: int, enc_frac: float,
                gen: torch.Generator, device) -> tuple[torch.Tensor,
                                                      torch.Tensor]:
    """(rolls [n_car] int64, encrypted [n_car] bool): each carrier's
    circular roll puts its stream start inside the screened noise window
    (prod_fixture.safe_rolls' window, positions drawn from the seed), and
    round(enc_frac * n_car) carriers, at least one, drawn from the seed,
    carry the encrypted row."""
    W = n_tail + HEAD_NOISE - 2 * GUARD
    start0 = L - n_tail + GUARD
    off = torch.randint(0, W, (n_car,), generator=gen, device=device)
    pos = start0 + off
    rolls = (L - pos % L) % L
    n_enc = max(1, int(round(n_car * enc_frac)))
    enc = torch.zeros(n_car, dtype=torch.bool, device=device)
    enc[torch.randperm(n_car, generator=gen, device=device)[:n_enc]] = True
    return rolls, enc


def rolled_bits(rows: dict, rolls: torch.Tensor, enc: torch.Tensor,
                device) -> torch.Tensor:
    """[n_car, L] uint8: carrier c's row (the encrypted one where
    enc[c]) circularly rolled by rolls[c] (np.roll semantics)."""
    plain = torch.as_tensor(rows["plain"], device=device)
    encr = torch.as_tensor(rows["enc"], device=device)
    L = plain.shape[0]
    src = torch.where(enc[:, None], encr[None, :], plain[None, :])
    idx = (torch.arange(L, device=device)[None, :] - rolls[:, None]) % L
    return src.gather(1, idx)


@functools.lru_cache(maxsize=4)
def rrc_taps(sps: int, alpha: float = 0.35) -> np.ndarray:
    """Root-raised-cosine taps, 11*sps of them, gain-normalised
    (phy.dqpsk.rrc_taps)."""
    ntaps = 11 * sps
    t = (np.arange(ntaps) - (ntaps - 1) / 2.0) / sps
    taps = np.zeros(ntaps)
    for i, x in enumerate(t):
        if abs(x) < 1e-9:
            taps[i] = 1.0 - alpha + 4 * alpha / np.pi
        elif abs(abs(4 * alpha * x) - 1.0) < 1e-9:
            taps[i] = (alpha / np.sqrt(2)) * (
                (1 + 2 / np.pi) * np.sin(np.pi / (4 * alpha))
                + (1 - 2 / np.pi) * np.cos(np.pi / (4 * alpha)))
        else:
            taps[i] = ((np.sin(np.pi * x * (1 - alpha))
                        + 4 * alpha * x * np.cos(np.pi * x * (1 + alpha)))
                       / (np.pi * x * (1 - (4 * alpha * x) ** 2)))
    return (taps / np.sum(taps)).astype(np.float32)


def modulate(bits: torch.Tensor, sps: int = 2) -> torch.Tensor:
    """ubits [C, 2n] -> pi/4-DQPSK baseband [C, n*sps] complex64 with
    RRC pulse shaping (phy.dqpsk.modulate; the filter in float64)."""
    C, nb = bits.shape
    b = bits.reshape(C, nb // 2, 2).to(torch.int64)
    # dibit -> phase step in pi/4 units: 00 +1, 01 +3, 10 -1, 11 -3
    step = torch.tensor([1, 3, -1, -3], device=bits.device)[
        b[..., 0] * 2 + b[..., 1]]
    phase = torch.cumsum(step, dim=1).to(torch.float64) * (math.pi / 4.0)
    sym = torch.polar(torch.ones_like(phase), phase).to(torch.complex64)
    up = torch.zeros((C, sym.shape[1] * sps), dtype=torch.complex64,
                     device=bits.device)
    up[:, ::sps] = sym
    taps = rrc_taps(sps).astype(np.float64) * sps
    K = len(taps)
    # np.convolve(x, taps, "same"): out[n] = sum_k x[n + c - k] taps[k],
    # c = (K - 1) // 2; conv1d correlates, so the taps go in reversed
    w = torch.as_tensor(taps[::-1].copy(), device=bits.device)[None, None]
    x = torch.view_as_real(up.to(torch.complex128)).permute(0, 2, 1) \
        .reshape(2 * C, 1, -1)
    pad_l = K - 1 - (K - 1) // 2
    y = torch.nn.functional.conv1d(
        torch.nn.functional.pad(x, (pad_l, K - 1 - pad_l)), w)
    y = y.reshape(C, 2, -1).permute(0, 2, 1).contiguous()
    return torch.view_as_complex(y).to(torch.complex64)


def synthesize_bins(base: torch.Tensor, bins, T_out: int) -> torch.Tensor:
    """Per-carrier baseband [C, T_in] at DEMOD_RATE -> the wideband
    capture [T_out] complex64 with carrier c centred on spectrum bin
    bins[c] (bin b = b/dur Hz), keeping +-12.5 kHz of its spectrum;
    circular (channelizer.synthesize_wideband_bins, in complex128)."""
    C, T_in = base.shape
    dev = base.device
    dur = T_in / DEMOD_RATE
    half = int(SPACING / 2 * dur)
    F = torch.fft.fft(base.to(torch.complex128), dim=1)
    centre = torch.as_tensor(np.asarray(bins, np.int64), device=dev) % T_out
    k = torch.arange(half, device=dev)
    pos = (centre[:, None] + k[None, :]) % T_out
    neg = (centre[:, None] - 1 - k[None, :]) % T_out
    idx = torch.cat([pos, neg], dim=1).reshape(-1)
    vals = torch.cat([F[:, :half], F[:, T_in - 1 - k]], dim=1).reshape(-1)
    if int(torch.bincount(idx, minlength=T_out).max()) > 1:
        raise ValueError("carriers overlap in the synthesis")
    big = torch.zeros(T_out, dtype=torch.complex128, device=dev)
    big[idx] = vals
    return (torch.fft.ifft(big) * (T_out / T_in)).to(torch.complex64)


def grid_bins(channels, n_chan: int, T_in: int) -> np.ndarray:
    """Bins of PFB channels on the 25 kHz grid of n_chan
    (channelizer.synthesize_wideband_fft)."""
    dur = T_in / DEMOD_RATE
    return np.asarray([int(round((int(ch) % n_chan) * SPACING * dur))
                       for ch in channels], np.int64)


def offgrid_bins(n_car: int, skew_hz: float, T_in: int) -> np.ndarray:
    """Bins of carriers at the exact spectrum bin nearest 25 kHz x
    (k - n_car/2) + skew_hz (prod_fixture.mixer_bins)."""
    dur = T_in / DEMOD_RATE
    hz = SPACING * (np.arange(n_car) - n_car // 2) + skew_hz
    return np.round(hz * dur).astype(np.int64)


def quantize_iq4c(wide: torch.Tensor) -> torch.Tensor:
    """Complex capture -> companded 4+4-bit IQ, one uint8 per sample:
    each component at the nearest Lloyd-Max level for a Gaussian of
    the measured std, I in the low nibble (io.stream.quantize_iq4c)."""
    re, im = wide.real.to(torch.float64), wide.imag.to(torch.float64)
    sigma = math.sqrt((float(re.var(unbiased=False))
                       + float(im.var(unbiased=False))) / 2.0) or 1.0
    bounds = torch.as_tensor(_LM16_BOUNDS, device=wide.device)
    qi = torch.bucketize((wide.real / sigma).contiguous(), bounds)
    qq = torch.bucketize((wide.imag / sigma).contiguous(), bounds)
    return (qi | (qq << 4)).to(torch.uint8)


def u8_iq(wide: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
    """Complex capture + complex noise [T] -> rtl_tcp's interleaved u8
    I/Q: scaled to 1/1.05 of full scale, rounded about 127.5
    (prod_fixture.u8_iq with its noise given)."""
    w = (wide + noise.to(torch.complex64)).to(torch.complex64)
    w = w / (w.abs().max() * 1.05)
    u8 = torch.empty(2 * w.shape[0], dtype=torch.uint8, device=w.device)
    u8[0::2] = torch.round(w.real * 127.5 + 127.5).to(torch.uint8)
    u8[1::2] = torch.round(w.imag * 127.5 + 127.5).to(torch.uint8)
    return u8


def make_capture(cfg: dict, mix: dict, seed: int, device) -> dict:
    """The cell's capture on `device`: {'samples' (uint8, iq4c: one a
    complex sample; u8: two), 'bits' [C, L] uint8 (the transmitted
    streams), 'rolls', 'encrypted', 'offsets_hz' (mixer configurations),
    'stream_s' (seconds of stream a carrier)}."""
    dev = torch.device(device)
    gen = seed_generator(seed, dev)
    rows = load_rows(mix["rows"])
    n_car = int(cfg["carriers"])
    L = len(rows["plain"])
    rolls, enc = draw_layout(n_car, L, rows["n_tail"], float(mix["enc_frac"]),
                             gen, dev)
    bits = rolled_bits(rows, rolls, enc, dev)
    base = modulate(bits, sps=2)
    T_in = base.shape[1]
    fs = float(cfg["fs"])
    T_out = int(round(T_in / DEMOD_RATE * fs))
    out = {"bits": bits, "rolls": rolls, "encrypted": enc,
           "stream_s": T_out / fs}
    if cfg["front_end"] == "pfb":
        bins = grid_bins(range(n_car), int(cfg["n_chan"]), T_in)
    else:
        bins = offgrid_bins(n_car, float(cfg["skew_hz"]), T_in)
        out["offsets_hz"] = (bins / (T_in / DEMOD_RATE)).astype(np.float32)
    wide = synthesize_bins(base, bins, T_out)
    del base
    if cfg["format"] == "iq4c":
        out["samples"] = quantize_iq4c(wide)
    elif cfg["format"] == "u8":
        nz = torch.complex(
            torch.randn(T_out, generator=gen, device=dev),
            torch.randn(T_out, generator=gen, device=dev)) \
            * float(cfg["u8_noise"])
        out["samples"] = u8_iq(wide, nz)
    else:
        raise ValueError(f"unknown capture format {cfg['format']!r}")
    return out
