"""Wideband mixer-bank channelizer: one capture -> N per-carrier baseband
streams at the demod rate (port of tetra_tpu.phy.channelizer), with the
resampler plans the PFB path shares and the host fixture synthesisers.

Reference behaviour: one GNU Radio process per carrier, each running a
frequency-translating FIR + resampler in front of the DQPSK demod
(reference src/demod/osmosdr-tetra_demod_fft.py:64-96). Here all carriers
come from the same wideband planes in one batched pass on the device:
mix with a bank of oscillators [C, T], 127-tap low-pass FIR
(dqpsk._fir_real), and the 32-phase polyphase resampler to 36 kHz
(block matmul for a rational fs/36k, per-output gather otherwise; the
input edges are replicated, unlike kernel K3, which zero-fills). Plain
PyTorch in full float32 (resolve_device turns TF32 off).

The oscillator deviates from tetra_tpu on purpose: its phase at absolute
sample n = base + i is 2*pi*((f*n) mod fs)/fs in float64, and cos/sin
are taken in float64 before the cast to float32. It depends on n alone,
so chunked output is bit-identical to a whole-capture run, and it keeps
its precision on long streams (tetra_tpu evaluates f32(n)/f32(fs), which
loses integer exactness past 2^24 samples, and casts base to int32).
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from tetra_tpu_torch.device import resolve_device
from tetra_tpu_torch.phy.dqpsk import _fir_real

__all__ = ["DEMOD_RATE", "_N_PHASES", "design_lowpass", "_resample_plan",
           "_rational_ratio", "_resample_block_plan", "_mix_ri",
           "_resample_ri_one", "channelize_ri", "channelize",
           "synthesize_wideband_bins", "synthesize_wideband_fft",
           "synthesize_wideband"]

DEMOD_RATE = 36_000.0
_N_PHASES = 32
CUTOFF = 12_500.0       # half the 25 kHz channel spacing


@functools.lru_cache(maxsize=16)
def design_lowpass(fs: float, cutoff: float, ntaps: int = 127) -> np.ndarray:
    """Hamming-windowed sinc low-pass FIR (unity DC gain)."""
    t = np.arange(ntaps) - (ntaps - 1) / 2.0
    h = np.sinc(2.0 * cutoff / fs * t) * np.hamming(ntaps)
    return (h / h.sum()).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _resample_plan(n_in: int, fs: float, out_rate: float,
                   ntaps_per_phase: int = 8, skew: float = 0.0):
    """(gather_start [n_out], phase_indices [n_out], filterbank [P,
    ntaps]) for arbitrary-ratio polyphase resampling: output n
    interpolates the input at n * fs/out_rate + skew, the kernel centre
    ntaps//2 - 1 taps into each gathered window."""
    ratio = fs / out_rate
    centre = ntaps_per_phase // 2 - 1
    n_out = max(int((n_in - ntaps_per_phase - max(skew, 0.0)) / ratio), 0)
    pos = np.arange(n_out) * ratio + skew
    ipos = np.floor(pos).astype(np.int32)
    frac = pos - ipos
    start = np.maximum(ipos - centre, 0)
    phase = np.minimum((frac * _N_PHASES).astype(np.int32), _N_PHASES - 1)
    k = np.arange(ntaps_per_phase) - centre
    bank = np.zeros((_N_PHASES, ntaps_per_phase), np.float32)
    for p in range(_N_PHASES):
        d = p / _N_PHASES
        h = np.sinc(k - d) * np.hamming(ntaps_per_phase)
        bank[p] = (h / h.sum()).astype(np.float32)
    return start, phase, bank


@functools.lru_cache(maxsize=32)
def _rational_ratio(fs: float, out_rate: float, max_den: int = 64):
    """(L, M) with fs/out_rate == L/M exactly, or None."""
    ratio = fs / out_rate
    for M in range(1, max_den + 1):
        L = round(ratio * M)
        if abs(ratio * M - L) < 1e-9 and L > 0:
            return L, M
    return None


@functools.lru_cache(maxsize=32)
def _resample_block_plan(n_in: int, fs: float, out_rate: float,
                         ntaps_per_phase: int = 8, skew: float = 0.0):
    """Block form of the 32-phase polyphase resampler for a rational
    fs/out_rate = L/M: output block q (M samples) is the input window
    [q·L + bmin, q·L + bmin + width) times W [width, M]. Output n
    interpolates the input at n·fs/out_rate + skew. Returns (W, bmin,
    width, L, M, n_out, pad_l) or None for a non-rational ratio."""
    lm = _rational_ratio(fs, out_rate)
    if lm is None:
        return None
    L, M = lm
    ratio = fs / out_rate
    centre = ntaps_per_phase // 2 - 1
    n_out = max(int((n_in - ntaps_per_phase - max(skew, 0.0)) / ratio), 0)
    pos = np.arange(M) * ratio + skew
    ipos = np.floor(pos).astype(np.int64)
    frac = pos - ipos
    phase = np.minimum((frac * _N_PHASES).astype(np.int32), _N_PHASES - 1)
    b = ipos - centre
    bmin = int(b.min())
    width = int(b.max()) + ntaps_per_phase - bmin
    k = np.arange(ntaps_per_phase) - centre
    W = np.zeros((width, M), np.float32)
    for r in range(M):
        d = phase[r] / _N_PHASES
        h = np.sinc(k - d) * np.hamming(ntaps_per_phase)
        W[b[r] - bmin: b[r] - bmin + ntaps_per_phase, r] = \
            (h / h.sum()).astype(np.float32)
    pad_l = max(-bmin, 0)
    return W, bmin, width, L, M, n_out, pad_l


def _mix_ri(re, im, offsets_hz, fs: float, base: int = 0):
    """Oscillator-bank mix of float32 planes re, im [T] -> [C, T] planes:
    (re + j im) * exp(-j * 2*pi*((f*n) mod fs)/fs) at n = base + i, the
    phase and its cos/sin in float64."""
    dev = re.device
    T = re.shape[-1]
    n = torch.arange(T, dtype=torch.float64, device=dev) + float(int(base))
    f = torch.as_tensor(np.asarray(offsets_hz, np.float32), device=dev) \
        .to(torch.float64)
    ph = (f[:, None] * n[None, :]).remainder_(float(fs)) \
        .mul_(2.0 * math.pi / float(fs))
    c = torch.cos(ph).to(torch.float32)
    s = ph.sin_().to(torch.float32)
    del ph
    return re[None, :] * c + im[None, :] * s, im[None, :] * c - re[None, :] * s


def _resample_ri_one(x, n_in: int, fs: float, out_rate: float,
                     skew: float = 0.0):
    """Polyphase resample of real planes x [C, n_in] -> [C, n_out]: the
    block matmul for a rational ratio (edges replicated), else the
    per-output gather (indices clipped to the input: the same edges)."""
    plan = _resample_block_plan(n_in, fs, out_rate, skew=skew)
    if plan is not None:
        W, bmin, width, L, M, n_out, pad_l = plan
        if n_out == 0:
            return x[..., :0]
        nq = -(-n_out // M)
        need = pad_l + (nq - 1) * L + bmin + width
        pad_r = max(need - pad_l - n_in, 0)
        xp = torch.cat([x[..., :1].expand(*x.shape[:-1], pad_l), x,
                        x[..., -1:].expand(*x.shape[:-1], pad_r)], dim=-1)
        blocks = xp[..., pad_l + bmin:].unfold(-1, width, L)[..., :nq, :]
        out = torch.matmul(blocks, torch.as_tensor(W, device=x.device))
        return out.reshape(*x.shape[:-1], nq * M)[..., :n_out]
    start, phase, bank = _resample_plan(n_in, fs, out_rate, skew=skew)
    ntp = bank.shape[1]
    gather = np.clip(start[:, None] + np.arange(ntp)[None, :], 0, n_in - 1)
    coefs = torch.as_tensor(bank[phase], device=x.device)
    return (x[..., torch.as_tensor(gather, device=x.device)] * coefs).sum(-1)


def channelize_ri(re, im, offsets_hz, fs: float,
                  out_rate: float = DEMOD_RATE, ntaps: int = 127,
                  base: int = 0, device=None):
    """Planar wideband channelizer: float32 planes re, im [T] -> (out_re,
    out_im) [C, n_out] at out_rate, one carrier per offset (Hz from the
    capture centre): mix, low-pass, resample. base: the absolute sample
    index of re[0] in a longer stream. Tensors stay on their device;
    numpy planes go to `device` (the card unless the caller asks for
    the CPU)."""
    if isinstance(re, torch.Tensor):
        dev = re.device
    else:
        dev = resolve_device(device)
    re = torch.as_tensor(re, dtype=torch.float32, device=dev)
    im = torch.as_tensor(im, dtype=torch.float32, device=dev)
    T = re.shape[-1]
    mr, mi = _mix_ri(re, im, offsets_hz, fs, base)
    taps = design_lowpass(float(fs), CUTOFF, ntaps)
    fr, fi = _fir_real(mr, taps), _fir_real(mi, taps)
    del mr, mi
    return (_resample_ri_one(fr, T, float(fs), out_rate),
            _resample_ri_one(fi, T, float(fs), out_rate))


def channelize(iq, offsets_hz, fs: float, out_rate: float = DEMOD_RATE,
               ntaps: int = 127, device=None) -> torch.Tensor:
    """Wideband complex [T] (numpy, or a complex tensor) -> per-carrier
    baseband [C, T_out] complex64 at out_rate."""
    if isinstance(iq, torch.Tensor):
        dev = iq.device
    else:
        dev = resolve_device(device)
        iq = torch.as_tensor(np.asarray(iq, np.complex64))
    iq = iq.to(dev)
    out_r, out_i = channelize_ri(iq.real.to(torch.float32).contiguous(),
                                 iq.imag.to(torch.float32).contiguous(),
                                 offsets_hz, fs, out_rate, ntaps)
    return torch.complex(out_r, out_i)


def synthesize_wideband_bins(basebands, bins, fs: float,
                             in_rate: float = DEMOD_RATE,
                             spacing: float = 25_000.0) -> np.ndarray:
    """Host fixture generator, FFT form: per-carrier baseband [C, T_in]
    at in_rate -> wideband capture [T_out] at fs, carrier c centred on
    bin bins[c] of the capture's spectrum (bin b = b/dur Hz, dur =
    T_in/in_rate: an exact offset), keeping +-spacing/2 of its spectrum.
    O(T_out log T_out); circular, as a looped capture."""
    basebands = np.asarray(basebands, np.complex64)
    C, T_in = basebands.shape
    dur = T_in / in_rate
    T_out = int(round(dur * fs))
    half = int(spacing / 2 * dur)          # bins kept per side
    F = np.fft.fft(basebands, axis=1)      # bin b = freq b/dur
    big = np.zeros(T_out, np.complex64)
    for c in range(C):
        centre = int(bins[c]) % T_out
        pos = (centre + np.arange(half)) % T_out
        neg = (centre - np.arange(1, half + 1)) % T_out
        big[pos] += F[c, :half]
        big[neg] += F[c, T_in - np.arange(1, half + 1)]
    out = np.fft.ifft(big) * (T_out / T_in)
    return out.astype(np.complex64)


def synthesize_wideband_fft(basebands, channels, n_chan: int,
                            in_rate: float = DEMOD_RATE,
                            spacing: float = 25_000.0) -> np.ndarray:
    """Host fixture generator, FFT form: per-carrier baseband [C, T_in]
    at in_rate -> wideband capture [T_out] at n_chan*spacing, carrier c
    centred on PFB channel channels[c]."""
    dur = np.shape(basebands)[1] / in_rate
    bins = [int(round((int(ch) % n_chan) * spacing * dur)) for ch in channels]
    return synthesize_wideband_bins(basebands, bins, n_chan * spacing,
                                    in_rate, spacing)


def synthesize_wideband(basebands, offsets_hz, fs: float,
                        in_rate: float = DEMOD_RATE) -> np.ndarray:
    """Host fixture generator: per-carrier baseband [C, T_in] at in_rate
    -> summed wideband capture [T_out] at fs (inverse of channelize)."""
    basebands = np.asarray(basebands)
    C, T_in = basebands.shape
    ratio = fs / in_rate
    T_out = int(T_in * ratio)
    t_out = np.arange(T_out) / fs
    # upsample each carrier by windowed-sinc interpolation at the output
    # instants (32 taps, Kaiser window — a truncated bare sinc has ~-13 dB
    # interpolation error at fractional positions, enough to close the
    # DQPSK eye)
    pos = t_out * in_rate
    base = np.floor(pos).astype(np.int64)
    frac = pos - base
    half = 16
    k = np.arange(-half + 1, half + 1)
    win = np.kaiser(2 * half, 8.0)
    out = np.zeros(T_out, np.complex64)
    for c in range(C):
        sig = np.zeros(T_out, np.complex64)
        for wi, kk in enumerate(k):
            idx = np.clip(base + kk, 0, T_in - 1)
            w = np.sinc(kk - frac) * win[wi]
            sig += basebands[c, idx] * w
        out += sig * np.exp(2j * np.pi * offsets_hz[c] * t_out)
    return out.astype(np.complex64)
