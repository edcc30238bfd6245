"""Rational resampler plan and the FFT fixture synthesiser (port of the
parts of tetra_tpu.phy.channelizer that the PFB path uses)."""
from __future__ import annotations

import functools

import numpy as np

__all__ = ["DEMOD_RATE", "_N_PHASES", "_rational_ratio",
           "_resample_block_plan", "synthesize_wideband_fft"]

DEMOD_RATE = 36_000.0
_N_PHASES = 32


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


def synthesize_wideband_fft(basebands, channels, n_chan: int,
                            in_rate: float = DEMOD_RATE,
                            spacing: float = 25_000.0) -> np.ndarray:
    """Host fixture generator, FFT form: per-carrier baseband [C, T_in]
    at in_rate -> wideband capture [T_out] at n_chan*spacing, carrier c
    centred on PFB channel channels[c]."""
    basebands = np.asarray(basebands, np.complex64)
    C, T_in = basebands.shape
    fs = n_chan * spacing
    dur = T_in / in_rate
    T_out = int(round(dur * fs))
    half = int(spacing / 2 * dur)          # bins kept per side
    F = np.fft.fft(basebands, axis=1)      # bin b = freq b/dur
    big = np.zeros(T_out, np.complex64)
    for c in range(C):
        k = int(channels[c]) % n_chan
        centre = int(round(k * spacing * dur)) % T_out
        pos = (centre + np.arange(half)) % T_out
        neg = (centre - np.arange(1, half + 1)) % T_out
        big[pos] += F[c, :half]
        big[neg] += F[c, T_in - np.arange(1, half + 1)]
    out = np.fft.ifft(big) * (T_out / T_in)
    return out.astype(np.complex64)
