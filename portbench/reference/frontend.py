"""The receiver's front end, worked out again: the stream geometry of
its overlap-save chunking, the polyphase filterbank and the mixer bank
to the 36 kHz demod rate, and the hard DQPSK demod, in float64.

Same functions as the port's plain versions (phy.pfb
pfb_channelize_rows_plain / resample_rows_plain, phy.channelizer
channelize_ri, phy.dqpsk demodulate_hard_ri, rx_multi's streaming), with
the filters designed here from their formulas. `precision="tf32"` runs
the same reference in TF32, the lower-precision control of the
comparison: float32 with every operand of a multiply (the inputs, the
filters, the oscillator, the FFT's input, the resampler's blocks, the
demod's matched filter and its outputs) rounded to TF32's 10-bit
mantissa first, as a tensor core would take it, whatever kernel the
library picks for these shapes.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

DEMOD_RATE = 36_000.0
N_PHASES = 32
CUTOFF = 12_500.0
LLOYD_MAX_16 = np.array(
    [-2.733, -2.069, -1.618, -1.256, -0.9424, -0.6568, -0.3881, -0.1284,
     0.1284, 0.3881, 0.6568, 0.9424, 1.256, 1.618, 2.069, 2.733],
    np.float32)


# ---------------------------------------------------------------- geometry

def pfb_bits_len(n_samples: int, n_chan: int, fs: float, sps: int,
                 J: int = 16) -> int:
    """Demod bits a PFB feed of n_samples yields per carrier."""
    hop = n_chan // 2
    M = max((n_samples - n_chan * J) // hop + 1, 1)
    skew = -(n_chan * J - 1) / (2.0 * hop)
    ratio = (2.0 * fs / n_chan) / DEMOD_RATE
    n_out = max(int((M - 8 - max(skew, 0.0)) / ratio), 0)
    return 2 * (n_out // sps)


def rational_ratio(fs: float, out_rate: float, max_den: int = 64):
    """(L, M) with fs/out_rate == L/M exactly, or None."""
    ratio = fs / out_rate
    for M in range(1, max_den + 1):
        L = round(ratio * M)
        if abs(ratio * M - L) < 1e-9 and L > 0:
            return L, M
    return None


def mixer_bits_len(n_samples: int, fs: float, sps: int) -> int:
    """Demod bits a mixer-bank feed of n_samples yields per carrier."""
    n_out = max(int((n_samples - 8) / (fs / DEMOD_RATE)), 0)
    return 2 * (n_out // sps)


def feeds(n_total: int, cuts, block: int, bits_len, slope: int,
          final_call_empty: bool = False) -> list[dict]:
    """The receiver's overlap-save feeds over a capture cut at `cuts`
    (one call per cut, the last final; final_call_empty: one more final
    call with no samples): per feed {'start', 'end' (capture sample
    indices), 'keep' (trailing demod bits that are new), 'base' (the
    absolute index of its first sample)}. block: the streaming quantum;
    each continuation re-feeds 2*block samples; bits_len(n): demod bits
    of an n-sample feed; slope: bits per block."""
    W = 2 * block
    calls = [(cuts[k], cuts[k + 1], k == len(cuts) - 2 and
              not final_call_empty) for k in range(len(cuts) - 1)]
    if final_call_empty:
        calls.append((cuts[-1], cuts[-1], True))
    rem, hist, g = 0, None, None
    out = []
    for _, b, final in calls:
        total = b - rem
        usable = total if final else (total // block) * block
        if usable == 0 or (hist is None and usable < W and not final):
            if final:
                rem, hist, g = b, None, None
            continue
        c0, c1 = rem, rem + usable
        first = hist is None
        f0 = c0 if first else hist
        n = bits_len(c1 - f0)
        keep = n if first else max(n - g, 0)
        if first and usable % block == 0:
            g = n - slope * (usable // block - 2)
        src0 = c0 if c1 - c0 >= W else f0
        hist = max(src0, c1 - W)
        rem = c1
        out.append({"start": f0, "end": c1, "keep": keep,
                    "base": c0 if first else c0 - W})
        if final:
            hist, g = None, None
    return out


def pfb_feeds(n_total: int, cuts, n_chan: int, fs: float,
              sps: int = 2) -> list[dict]:
    """Feeds of rx_multi's PFB streaming (BLOCK = 25 n_chan samples, 36
    demod bits a block)."""
    return feeds(n_total, cuts, 25 * n_chan,
                 lambda n: pfb_bits_len(n, n_chan, fs, sps), 36)


def mixer_feeds(n_total: int, cuts, fs: float, sps: int = 2) -> list[dict]:
    """Feeds of rx_multi's mixer-bank streaming (whole fs/36k resampler
    periods, at least 2048 samples, an even number of bits a block),
    with the live CLI's final empty call."""
    L_, M_ = rational_ratio(fs, DEMOD_RATE)
    block = L_ * max(1, -(-2048 // L_))
    if ((block // L_) * M_) % 2:
        block *= 2
    return feeds(n_total, cuts, block, lambda n: mixer_bits_len(n, fs, sps),
                 (block // L_) * M_, final_call_empty=True)


# ------------------------------------------------------------- precision

def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (10 mantissa bits, ties to
    even), still as float32."""
    b = x.contiguous().view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _op(x: torch.Tensor, precision: str) -> torch.Tensor:
    """A multiply's operand at the reference's precision."""
    return tf32_round(x) if precision == "tf32" else x


def _dtype(precision: str):
    if precision not in ("f64", "tf32"):
        raise ValueError(precision)
    return torch.float64 if precision == "f64" else torch.float32


# ----------------------------------------------------------------- inputs

def dequant_iq4c(raw: torch.Tensor, dtype) -> tuple:
    """Companded 4+4-bit IQ [T] uint8 -> (re, im) planes."""
    lut = torch.as_tensor(LLOYD_MAX_16, device=raw.device).to(dtype)
    p = raw.to(torch.int64)
    return lut[p & 0xF], lut[(p >> 4) & 0xF]


def u8_planes(raw_u8: torch.Tensor, dtype) -> tuple:
    """rtl_tcp interleaved u8 [2T] -> (re, im): (u - 127.5) / 127.5, as
    the live source converts it, rounded to float32 first."""
    f = ((raw_u8.to(torch.float32) - 127.5) * (1.0 / 127.5)).to(dtype)
    return f[0::2], f[1::2]


# -------------------------------------------------------- filterbank (PFB)

@functools.lru_cache(maxsize=4)
def prototype(n_chan: int, J: int = 16, cutoff_frac: float = 0.64):
    """Kaiser-windowed sinc low-pass of n_chan*J taps, unity DC gain."""
    n = n_chan * J
    t = np.arange(n) - (n - 1) / 2.0
    h = np.sinc(2.0 * cutoff_frac * t / n_chan) * np.kaiser(n, 10.0)
    return h / h.sum()


@functools.lru_cache(maxsize=8)
def block_plan(fs: float, out_rate: float, skew: float, ntp: int = 8):
    """The 32-phase polyphase resampler for a rational fs/out_rate = L/M
    in block form: output block q is the input window [q L + bmin,
    q L + bmin + width) times W [width, M]; output n interpolates the
    input at n fs/out_rate + skew. Returns (W float64, bmin, L, M)."""
    L, M = rational_ratio(fs, out_rate)
    ratio = fs / out_rate
    centre = ntp // 2 - 1
    pos = np.arange(M) * ratio + skew
    ipos = np.floor(pos).astype(np.int64)
    phase = np.minimum(((pos - ipos) * N_PHASES).astype(np.int32),
                       N_PHASES - 1)
    b = ipos - centre
    bmin = int(b.min())
    width = int(b.max()) + ntp - bmin
    k = np.arange(ntp) - centre
    W = np.zeros((width, M))
    for r in range(M):
        h = np.sinc(k - phase[r] / N_PHASES) * np.hamming(ntp)
        W[b[r] - bmin: b[r] - bmin + ntp, r] = h / h.sum()
    return W, bmin, L, M


def _resample_blocks(x: torch.Tensor, W, bmin: int, L: int, M: int,
                     n_out: int, edge: str) -> torch.Tensor:
    """x [..., n_in] -> [..., n_out] by the block plan, zero (edge
    "zero") or edge-replicated ("edge") outside the input."""
    n_in = x.shape[-1]
    width = W.shape[0]
    pad_l = max(-bmin, 0)
    nq = -(-n_out // M)
    need = pad_l + (nq - 1) * L + bmin + width
    pad_r = max(need - pad_l - n_in, 0)
    if edge == "zero":
        xp = F.pad(x, (pad_l, pad_r))
    else:
        xp = torch.cat([x[..., :1].expand(*x.shape[:-1], pad_l), x,
                        x[..., -1:].expand(*x.shape[:-1], pad_r)], dim=-1)
    blocks = xp[..., pad_l + bmin:].unfold(-1, width, L)[..., :nq, :]
    Wt = torch.as_tensor(W, dtype=x.dtype, device=x.device)
    if x.dtype == torch.float32:
        Wt = tf32_round(Wt)
    out = torch.matmul(blocks, Wt)
    return out.reshape(*x.shape[:-1], nq * M)[..., :n_out]


def pfb_frontend(re: torch.Tensor, im: torch.Tensor, n_chan: int,
                 fs: float, precision: str = "f64", J: int = 16):
    """Wideband planes [T] -> every channel at the demod rate, (re, im)
    [n_chan, n_out]: the 2x-oversampled WOLA filterbank (window and fold
    of J branches, n_chan-point FFT, the hop's (-1)^(m c) rotation),
    then the resampler from 2 fs / n_chan to 36 kHz."""
    dt = _dtype(precision)
    dev = re.device
    hop = n_chan // 2
    T = re.shape[0]
    if T < n_chan * J:
        re, im = F.pad(re, (0, n_chan * J - T)), F.pad(im, (0, n_chan * J - T))
        T = n_chan * J
    M = max((T - n_chan * J) // hop + 1, 1)
    nblk = T // hop
    h2 = _op(torch.as_tensor(prototype(n_chan, J), dtype=dt,
                             device=dev), precision).reshape(J, 2, hop)
    x = torch.complex(_op(re.to(dt), precision), _op(im.to(dt), precision)
                      )[:nblk * hop].reshape(nblk, hop)
    lo = torch.zeros((M, hop), dtype=x.dtype, device=dev)
    hi = torch.zeros((M, hop), dtype=x.dtype, device=dev)
    for j in range(J):
        lo += x[2 * j:2 * j + M] * h2[j, 0]
        hi += x[2 * j + 1:2 * j + 1 + M] * h2[j, 1]
    fr = torch.cat([lo, hi], dim=1)
    if precision == "tf32":
        fr = torch.complex(tf32_round(fr.real), tf32_round(fr.imag))
    y = torch.fft.fft(fr, dim=1)
    del lo, hi, x, fr
    m = torch.arange(M, device=dev)[:, None]
    c = torch.arange(n_chan, device=dev)[None, :]
    y = y * (1 - 2 * ((m & c) & 1)).to(dt)
    chan_rate = 2.0 * fs / n_chan
    skew = -(n_chan * J - 1) / (2.0 * hop)
    W, bmin, L, Mph = block_plan(chan_rate, DEMOD_RATE, skew)
    n_out = max(int((M - 8 - max(skew, 0.0)) / (chan_rate / DEMOD_RATE)), 0)
    yt = _op(torch.view_as_real(y.T.contiguous()), precision)   # [C, M, 2]
    del y
    return (_resample_blocks(yt[..., 0], W, bmin, L, Mph, n_out, "zero"),
            _resample_blocks(yt[..., 1], W, bmin, L, Mph, n_out, "zero"))


# ------------------------------------------------------------ mixer bank

@functools.lru_cache(maxsize=8)
def lowpass(fs: float, cutoff: float = CUTOFF, ntaps: int = 127):
    """Hamming-windowed sinc low-pass, unity DC gain."""
    t = np.arange(ntaps) - (ntaps - 1) / 2.0
    h = np.sinc(2.0 * cutoff / fs * t) * np.hamming(ntaps)
    return h / h.sum()


def _fir_same(x: torch.Tensor, taps: np.ndarray, precision: str):
    """y[o] = sum_j x[o - K//2 + j] taps[K-1-j] over x [N, T], zero
    outside (a same-length linear convolution): by FFT in float64, as
    one conv1d on TF32 operands in the control."""
    K = len(taps)
    N, T = x.shape
    if precision == "f64":
        n = 1 << (T + K - 1 - 1).bit_length()
        h = torch.as_tensor(taps, dtype=torch.float64, device=x.device)
        y = torch.fft.irfft(torch.fft.rfft(x, n) * torch.fft.rfft(h, n), n)
        return y[:, K // 2: K // 2 + T]
    w = tf32_round(torch.as_tensor(np.ascontiguousarray(taps[::-1]),
                                   dtype=x.dtype, device=x.device))[None, None]
    return F.conv1d(F.pad(x[:, None], (K // 2, K - 1 - K // 2)), w)[:, 0]


def mixer_frontend(re: torch.Tensor, im: torch.Tensor, offsets_hz,
                   fs: float, base: int, precision: str = "f64",
                   rows=None):
    """Wideband planes [T] (re[0] at absolute sample `base`) -> carriers
    `offsets_hz` at the demod rate, (re, im) [C, n_out]: the oscillator
    e^{-j 2 pi (f n mod fs)/fs} at absolute indices, the 127-tap low-pass,
    the 32-phase resampler (edges replicated). rows: carrier indices to
    compute (all when None)."""
    dt = _dtype(precision)
    dev = re.device
    T = re.shape[0]
    f = torch.as_tensor(np.asarray(offsets_hz, np.float32),
                        device=dev).to(torch.float64)
    if rows is not None:
        f = f[rows]
    n = torch.arange(T, dtype=torch.float64, device=dev) + float(base)
    ph = (f[:, None] * n[None, :]).remainder(float(fs)) \
        * (2.0 * math.pi / float(fs))
    c, s = _op(torch.cos(ph).to(dt), precision), \
        _op(torch.sin(ph).to(dt), precision)
    del ph
    r, i = _op(re.to(dt), precision)[None], _op(im.to(dt), precision)[None]
    mr, mi = r * c + i * s, i * c - r * s
    del c, s
    taps = lowpass(float(fs))
    fr, fi = (_fir_same(_op(x, precision), taps, precision)
              for x in (mr, mi))
    del mr, mi
    fr, fi = _op(fr, precision), _op(fi, precision)
    W, bmin, L, M = block_plan(float(fs), DEMOD_RATE, 0.0)
    n_out = max(int((T - 8) / (fs / DEMOD_RATE)), 0)
    return (_resample_blocks(fr, W, bmin, L, M, n_out, "edge"),
            _resample_blocks(fi, W, bmin, L, M, n_out, "edge"))


# ------------------------------------------------------------------ demod

@functools.lru_cache(maxsize=8)
def rrc(sps: int, frac_shift: float, alpha: float = 0.35) -> np.ndarray:
    """Root-raised-cosine taps (11 sps, gain-normalised), evaluated
    frac_shift samples off the grid."""
    ntaps = 11 * sps
    t = (np.arange(ntaps) - (ntaps - 1) / 2.0 + frac_shift) / sps
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
    return taps / np.sum(taps)


def demod_phasors(re: torch.Tensor, im: torch.Tensor, sps: int = 2,
                  os: int = 4, precision: str = "f64") -> tuple:
    """Baseband [C, T] -> the demod's output before the slicer, (sr, si)
    [C, T // sps]: the matched filter at os fractional phases, the
    differential phasor d over one symbol, and per carrier d at the
    sample phase with the largest mean |sin 2 theta| over the whole
    feed."""
    C, T = re.shape
    dt = re.dtype
    bank = np.stack([rrc(sps, k / os) for k in range(os)])
    K = bank.shape[1]
    w = _op(torch.as_tensor(np.ascontiguousarray(bank[:, ::-1]), dtype=dt,
                            device=re.device), precision)[:, None, :]
    re, im = _op(re, precision), _op(im, precision)

    def mf(x):
        y = F.conv1d(F.pad(x[:, None, :], (K // 2, K - 1 - K // 2)), w)
        return _op(y.permute(0, 2, 1).reshape(C, T * os), precision)

    fr, fi = mf(re), mf(im)
    s2 = os * sps
    lr, li = F.pad(fr, (s2, 0))[:, :-s2], F.pad(fi, (s2, 0))[:, :-s2]
    dr, di = fr * lr + fi * li, fi * lr - fr * li
    n = (dr.shape[-1] // s2) * s2
    drp, dip = dr[:, :n].reshape(C, n // s2, s2), di[:, :n].reshape(C, n // s2, s2)
    score = (2.0 * torch.abs(drp * dip) / (drp * drp + dip * dip + 1e-12)
             ).mean(dim=1)
    best = torch.argmax(score, dim=-1)
    idx = best[:, None, None].expand(C, n // s2, 1)
    return drp.gather(2, idx)[..., 0], dip.gather(2, idx)[..., 0]


def hard_bits(sr: torch.Tensor, si: torch.Tensor) -> torch.Tensor:
    """The slicer: b0 = (Im d <= 0), b1 = (Re d < 0), interleaved ->
    ubits [C, 2 n_sym] int8."""
    return torch.stack([(si <= 0), (sr < 0)], dim=-1).reshape(sr.shape[0], -1) \
        .to(torch.int8)


def hard_demod(re: torch.Tensor, im: torch.Tensor, sps: int = 2,
               os: int = 4, precision: str = "f64") -> torch.Tensor:
    """Baseband [C, T] -> ubits [C, 2 (T // sps)] int8: the slicer over
    demod_phasors."""
    return hard_bits(*demod_phasors(re, im, sps, os, precision))
