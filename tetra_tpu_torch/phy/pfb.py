"""Polyphase filterbank front end (port of tetra_tpu.phy.pfb with the
kernels of tetra_tpu.phy.pfb_pallas).

A 2x-oversampled WOLA filterbank splits the wideband stream into all
C channels at once (kernel K2, `pfb_channelize_rows`), and a rational
polyphase resampler brings every channel from 2·fs/C to the 36 kHz
demod rate (kernel K3, `resample_rows`). K2 writes time-major
[frames, C] rows; K3 reads them (or a subset of their columns) in place
and writes the decimated product channel-major, [channel, time], the
layout the demods read. Channels come out in natural order.

`pfb_channelize_ri` is the JAX package's XLA path (channel-major, the
DFT as two real [C, C] matmuls), plain PyTorch with no kernel; it is
what the mesh-sharded channelizer and the tools of the JAX package call.

Rows outside the resampler's input read as zero at both stream edges,
as in the TPU kernel (the XLA path of tetra_tpu replicates the edge
samples instead; the two differ only within the filter reach of the
ends, inside the demod's start-up margin).
"""
from __future__ import annotations

import functools
import weakref

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tetra_tpu_torch import kernels
from tetra_tpu_torch.phy.channelizer import DEMOD_RATE, _resample_block_plan

__all__ = ["pfb_prototype", "_dft_matrices", "_twiddles", "_fft_plan",
           "pfb_channelize_ri", "PfbFrontEnd",
           "pfb_channelize_rows", "pfb_channelize_rows_plain",
           "resample_rows", "resample_rows_plain", "resample_channels_plain",
           "pfb_to_demod_rate_ri"]


@functools.lru_cache(maxsize=8)
def pfb_prototype(n_chan: int, taps_per_branch: int = 16,
                  cutoff_frac: float = 0.64) -> np.ndarray:
    """Prototype low-pass for the filterbank, length n_chan*taps_per_branch
    (Kaiser-windowed sinc, cutoff 0.64 of the channel spacing)."""
    n = n_chan * taps_per_branch
    t = np.arange(n) - (n - 1) / 2.0
    h = np.sinc(2.0 * cutoff_frac * t / n_chan) * np.kaiser(n, 10.0)
    return (h / h.sum()).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_matrices(n_chan: int):
    """(cos [C, C], sin [C, C]) of 2π c k / C."""
    k = np.arange(n_chan)
    ang = 2.0 * np.pi * np.outer(k, k) / n_chan
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _twiddles(n_chan: int):
    """(cos, sin) of 2π e / C, e = 0..C-1, float32 [C]."""
    e = 2.0 * np.pi * np.arange(n_chan) / n_chan
    return np.cos(e).astype(np.float32), np.sin(e).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _fft_plan(n_chan: int):
    """Kernel K2's FFT for a power-of-two C (csrc/pfb_wola.cu make_plan):
    the radices of its Stockham passes (32 while 32 divides what is left,
    then the rest) and the twiddle table of passes p > 0, one after
    another, entry [r·Ns + i] of pass p = (cos, sin)(2π i r / (Ns R)),
    Ns the product of the earlier radices, taken from the C-point table
    _twiddles at e = i·r·C/(Ns R): (radices, float32 [L, 2]). C not a
    power of two: no passes (the kernel's direct DFT reads _twiddles)."""
    if n_chan & (n_chan - 1):
        return (), np.zeros((0, 2), np.float32)
    radices, n = [], n_chan
    while n > 1:
        radices.append(32 if n % 32 == 0 else n)
        n //= radices[-1]
    twc, tws = _twiddles(n_chan)
    parts, Ns = [np.zeros((0, 2), np.float32)], radices[0]
    for R in radices[1:]:
        e = np.arange(R)[:, None] * np.arange(Ns)[None] * (n_chan // (Ns * R))
        parts.append(np.stack([twc[e], tws[e]], -1).reshape(-1, 2))
        Ns *= R
    return tuple(radices), np.concatenate(parts)


def pfb_channelize_ri(re, im, n_chan: int, taps_per_branch: int = 16):
    """Planar wideband [..., T] float32 (T >= n_chan·taps_per_branch) ->
    all channels (chan_re, chan_im) [..., C, M], M = (T - J·C)/(C/2) + 1.

    2x-oversampled weighted overlap-add, hop H = C/2: frame m is
    b[m, k] = Σ_j x[mH + jC + k] · h[jC + k], summed as 2J shifted
    multiply-adds over the hop-strided view, then the analysis DFT
    across k as two real matmuls with the cos/sin matrices and the
    (-1)^{cm} rotation that recentres channel c. The math of
    tetra_tpu.phy.pfb.pfb_channelize_ri; kernel K2 computes the same
    frames time-major."""
    if n_chan % 2:
        raise ValueError("n_chan must be even")
    hop = n_chan // 2
    J = taps_per_branch
    nfilt = n_chan * J
    hj = torch.as_tensor(pfb_prototype(n_chan, J).reshape(J, n_chan),
                         device=re.device)

    def frames(x):
        x = x.to(torch.float32)
        T = x.shape[-1]
        if T < nfilt:
            raise ValueError(f"pfb_channelize_ri: {T} samples, fewer than "
                             f"one filter length ({nfilt})")
        M = (T - nfilt) // hop + 1
        nblk = T // hop
        u = x[..., :nblk * hop].reshape(*x.shape[:-1], nblk, hop)
        acc = [torch.zeros(x.shape[:-1] + (M, hop), dtype=torch.float32,
                           device=x.device) for _ in range(2)]
        for l in range(2 * J):
            j, half = divmod(l, 2)
            acc[half] = acc[half] + u[..., l:l + M, :] * \
                hj[j, half * hop:(half + 1) * hop]
        return torch.cat(acc, dim=-1)                     # [..., M, C]

    br_r, br_i = frames(re), frames(im)
    M = br_r.shape[-2]
    cosm, sinm = (torch.as_tensor(a, device=re.device)
                  for a in _dft_matrices(n_chan))
    yr = br_r @ cosm.T + br_i @ sinm.T
    yi = br_i @ cosm.T - br_r @ sinm.T
    cm = (torch.arange(M, device=re.device)[:, None]
          * torch.arange(n_chan, device=re.device)[None, :]) % 2
    sign = 1.0 - 2.0 * cm.to(torch.float32)
    return ((yr * sign).transpose(-1, -2).contiguous(),
            (yi * sign).transpose(-1, -2).contiguous())


@functools.lru_cache(maxsize=8)
def _fft_table(n_chan: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(_fft_plan(n_chan)[1], device=device)


def _n_frames(T: int, n_chan: int, J: int) -> int:
    return max((T - n_chan * J) // (n_chan // 2) + 1, 1)


def pfb_channelize_rows_plain(re, im, h, n_chan: int, J: int):
    """Plain PyTorch K2: window + torch.fft + hop rotation. re, im [T]
    float32 (T >= J*C) -> (yr, yi) [M, C] time-major."""
    hop = n_chan // 2
    T = re.shape[0]
    M = _n_frames(T, n_chan, J)
    nblk = T // hop
    h2 = h.reshape(J, 2, hop)

    def frames(x):
        u = x[:nblk * hop].reshape(nblk, hop)
        lo = torch.zeros((M, hop), dtype=torch.float32, device=x.device)
        hi = torch.zeros((M, hop), dtype=torch.float32, device=x.device)
        for j in range(J):
            lo = lo + u[2 * j:2 * j + M] * h2[j, 0]
            hi = hi + u[2 * j + 1:2 * j + 1 + M] * h2[j, 1]
        return torch.cat([lo, hi], dim=1)

    y = torch.fft.fft(torch.complex(frames(re), frames(im)), dim=1)
    m = torch.arange(M, device=re.device)[:, None]
    c = torch.arange(n_chan, device=re.device)[None, :]
    sign = 1.0 - 2.0 * ((m & c) & 1).to(torch.float32)
    return (y.real * sign).contiguous(), (y.imag * sign).contiguous()


def pfb_channelize_rows(re, im, h, twc, tws, n_chan: int, J: int):
    """K2: planar wideband [T] float32 -> channel frames ([M, C], [M, C])
    time-major, M = (T - J·C)/(C/2) + 1. A stream shorter than one
    filter length is zero-padded to it (one frame). The kernel takes
    J = 16 (the prototype's width) and even C up to 4096."""
    T = re.shape[0]
    if T < n_chan * J:
        re = F.pad(re, (0, n_chan * J - T))
        im = F.pad(im, (0, n_chan * J - T))
    if re.device.type == "cpu":
        return pfb_channelize_rows_plain(re, im, h, n_chan, J)
    for t, name in ((re, "re"), (im, "im")):
        kernels.require_cuda(t, name, torch.float32, 1)
    for t, name, n in ((h, "h", n_chan * J), (twc, "twc", n_chan),
                       (tws, "tws", n_chan)):
        kernels.require_cuda(t, name, torch.float32, 1)
        if t.shape[0] != n:
            raise ValueError(f"{name} must have {n} entries")
    if im.shape != re.shape:
        raise ValueError("re and im differ in shape")
    if J != 16 or n_chan % 2 or not 2 <= n_chan <= 4096:
        raise ValueError(f"pfb_channelize_rows: the kernel takes J 16 and "
                         f"even C up to 4096, got J {J}, C {n_chan}")
    M = _n_frames(re.shape[0], n_chan, J)
    yr = torch.empty((M, n_chan), dtype=torch.float32, device=re.device)
    yi = torch.empty_like(yr)
    tw = _fft_table(n_chan, re.device)
    rc = kernels.lib().tt_pfb_wola(
        re.data_ptr(), im.data_ptr(), h.data_ptr(), tw.data_ptr(),
        twc.data_ptr(), tws.data_ptr(), yr.data_ptr(), yi.data_ptr(), M,
        n_chan, J, kernels.stream_ptr(re.device))
    kernels.check(rc, "tt_pfb_wola")
    pfb_channelize_rows.launches += 1
    return yr, yi


pfb_channelize_rows.launches = 0


def resample_rows_plain(xr, xi, W, bmin: int, L: int, Mph: int,
                        n_out: int):
    """Plain PyTorch K3: zero-padded banded block gather + einsum with
    the block plan's W [width, Mph]. [n_in, C] -> [n_out, C] x2."""
    n_in = xr.shape[0]
    width = W.shape[0]
    pad_l = max(-bmin, 0)
    nq = -(-n_out // Mph)
    need = pad_l + (nq - 1) * L + bmin + width
    pad_r = max(need - pad_l - n_in, 0)
    idx = ((torch.arange(nq, device=xr.device) * L)[:, None]
           + (pad_l + bmin) + torch.arange(width, device=xr.device)[None])

    def one(x):
        xp = F.pad(x, (0, 0, pad_l, pad_r))
        out = torch.einsum("qwc,wr->qrc", xp[idx], W)
        return out.reshape(nq * Mph, x.shape[1])[:n_out]

    return one(xr), one(xi)


def resample_channels_plain(xr, xi, W, bmin: int, L: int, Mph: int,
                            n_out: int, channel_idx=None):
    """Plain PyTorch K3 in the channel-major layout: gather the columns
    `channel_idx` (None = all), resample_rows_plain, transpose.
    [n_in, C] -> [Csel, n_out] x2."""
    if channel_idx is not None:
        xr, xi = xr[:, channel_idx], xi[:, channel_idx]
    out_r, out_i = resample_rows_plain(xr, xi, W, bmin, L, Mph, n_out)
    return out_r.T.contiguous(), out_i.T.contiguous()


# index tensors already found inside [0, C): id -> (weakref, version, C),
# so that a caller passing the same tensor every chunk is checked once
# (the check reads the values back, a device synchronisation)
_checked_idx: dict = {}


def _check_channel_idx(idx, dev, C: int) -> None:
    if idx.device != dev:
        raise ValueError(f"channel_idx must be on {dev}, got {idx.device}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"channel_idx must be int32 or int64, got "
                        f"{idx.dtype}")
    if idx.dim() != 1 or not idx.is_contiguous():
        raise ValueError("channel_idx must be 1-D and contiguous")
    key = id(idx)
    hit = _checked_idx.get(key)
    if hit is not None and hit[0]() is idx and hit[1:] == (idx._version, C):
        return
    if idx.numel():
        lo, hi = (int(v) for v in torch.aminmax(idx))
        if lo < 0 or hi >= C:
            raise ValueError(f"channel_idx outside [0, {C}): {lo}..{hi}")
    _checked_idx[key] = (weakref.ref(idx, lambda _, k=key:
                                     _checked_idx.pop(k, None)),
                         idx._version, C)


def resample_rows(xr, xi, taps, off, W, bmin: int, L: int, Mph: int,
                  n_out: int, channel_major: bool = False,
                  channel_idx=None):
    """K3: time-major channel rows [n_in, C] x2 -> [n_out, C] x2 at the
    demod rate, or with channel_major the channels `channel_idx` (None =
    all; int32 or int64) as [Csel, n_out] x2, the layout the demods
    read. taps [Mph, NT] / off [Mph] are the live taps of W's columns
    and their first input row (see PfbFrontEnd); rows outside [0, n_in)
    read as zero."""
    if channel_idx is not None and not channel_major:
        raise ValueError("resample_rows: channel_idx needs channel_major")
    if xr.device.type == "cpu":
        if channel_major:
            return resample_channels_plain(xr, xi, W, bmin, L, Mph, n_out,
                                           channel_idx)
        return resample_rows_plain(xr, xi, W, bmin, L, Mph, n_out)
    kernels.require_cuda(xr, "xr", torch.float32, 2)
    kernels.require_cuda(xi, "xi", torch.float32, 2)
    kernels.require_cuda(taps, "taps", torch.float32, 2)
    kernels.require_cuda(off, "off", torch.int32, 1)
    if xi.shape != xr.shape or taps.shape[0] != Mph or off.shape[0] != Mph:
        raise ValueError("resample_rows: inconsistent shapes")
    n_in, C = xr.shape
    c_sel = C
    if channel_idx is not None:
        _check_channel_idx(channel_idx, xr.device, C)
        c_sel = channel_idx.shape[0]
    shape = (c_sel, n_out) if channel_major else (n_out, c_sel)
    yr = torch.empty(shape, dtype=torch.float32, device=xr.device)
    yi = torch.empty_like(yr)
    if n_out == 0 or c_sel == 0:
        return yr, yi
    rc = kernels.lib().tt_resample_rows(
        xr.data_ptr(), xi.data_ptr(), n_in, C,
        None if channel_idx is None else channel_idx.data_ptr(),
        int(channel_idx is not None and channel_idx.dtype == torch.int64),
        c_sel, taps.data_ptr(), off.data_ptr(), taps.shape[1], L, Mph, bmin,
        W.shape[0], int(channel_major), yr.data_ptr(), yi.data_ptr(), n_out,
        kernels.stream_ptr(xr.device))
    kernels.check(rc, "tt_resample_rows")
    resample_rows.launches += 1
    return yr, yi


resample_rows.launches = 0


def _live_taps(W: np.ndarray, bmin: int):
    """W [width, Mph] -> (taps [Mph, NT], off [Mph]): the nonzero span of
    each column (NT the widest) and the offset of its first row relative
    to q·L; a narrower column's span starts early enough that all NT
    rows stay inside W's rows [bmin, bmin + width)."""
    spans = []
    for r in range(W.shape[1]):
        nz = np.flatnonzero(W[:, r])
        spans.append((int(nz[0]), int(nz[-1]) + 1) if len(nz) else (0, 1))
    NT = max(w1 - w0 for w0, w1 in spans)
    taps = np.zeros((W.shape[1], NT), np.float32)
    off = np.zeros(W.shape[1], np.int32)
    for r, (w0, _) in enumerate(spans):
        w0 = min(w0, W.shape[0] - NT)
        taps[r] = W[w0:w0 + NT, r]
        off[r] = bmin + w0
    return taps, off


class PfbFrontEnd(nn.Module):
    """Filterbank + resampler tables for one (n_chan, fs): the prototype
    h [J·C], the DFT twiddles cos/sin(2πe/C) [C], and the resampler
    block plan W [width, M] with its live taps."""

    def __init__(self, n_chan: int, fs: float, taps_per_branch: int = 16):
        super().__init__()
        if n_chan % 2:
            raise ValueError("n_chan must be even")
        self.n_chan = n_chan
        self.J = taps_per_branch
        self.chan_rate = 2.0 * fs / n_chan
        hop = n_chan // 2
        # group delay of the prototype: channel frame m holds input time
        # (mH + (JC-1)/2)/fs
        self.skew = -(n_chan * taps_per_branch - 1) / (2.0 * hop)
        plan = _resample_block_plan(1 << 20, self.chan_rate, DEMOD_RATE,
                                    skew=self.skew)
        if plan is None:
            raise ValueError("PFB path needs a rational channel/demod rate")
        W, self.bmin, _, self.L, self.M, _, _ = plan
        taps, off = _live_taps(W, self.bmin)
        twc, tws = _twiddles(n_chan)
        self.register_buffer("h", torch.tensor(
            pfb_prototype(n_chan, taps_per_branch)))
        self.register_buffer("twc", torch.tensor(twc))
        self.register_buffer("tws", torch.tensor(tws))
        self.register_buffer("W", torch.tensor(W))
        self.register_buffer("rs_taps", torch.tensor(taps))
        self.register_buffer("rs_off", torch.tensor(off))

    def n_out(self, n_in: int) -> int:
        """Resampler output length for n_in channel frames."""
        ratio = self.chan_rate / DEMOD_RATE
        return max(int((n_in - 8 - max(self.skew, 0.0)) / ratio), 0)

    def forward(self, re, im, channel_idx=None):
        """Wideband planar [T] -> selected channels at the demod rate,
        (out_re, out_im) [Csel, n_out]."""
        yr, yi = pfb_channelize_rows(re, im, self.h, self.twc, self.tws,
                                     self.n_chan, self.J)
        return resample_rows(yr, yi, self.rs_taps, self.rs_off, self.W,
                             self.bmin, self.L, self.M,
                             self.n_out(yr.shape[0]), channel_major=True,
                             channel_idx=channel_idx)


@functools.lru_cache(maxsize=8)
def _front_end(n_chan: int, fs: float, device: torch.device) -> PfbFrontEnd:
    return PfbFrontEnd(n_chan, fs).to(device)


def pfb_to_demod_rate_ri(re, im, channel_idx, n_chan: int, fs: float):
    """Wideband planar [T] at `fs` -> channels `channel_idx` (None = all,
    natural order) at the 36 kHz demod rate, [Csel, T_out] x2."""
    return _front_end(n_chan, float(fs), re.device)(re, im, channel_idx)
