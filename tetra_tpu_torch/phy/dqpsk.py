"""pi/4-DQPSK demod (port of tetra_tpu.phy.dqpsk) plus the host
modulator used to build fixtures.

Reference behaviour: src/demod/cqpsk.py (RRC matched filter, differential
phasor) and src/float_to_bits.c (sign thresholds). Feed-forward design:
an os-x bank of fractionally shifted RRC matched filters, the
differential phasor over one symbol, one timing phase per carrier
picked by the |sin 2θ| metric over the whole chunk, and sign decisions
(or, soft, the phasor components scaled to int8 reliabilities). The
slotwise demods re-pick the timing phase and correct the residual
carrier phase per slot, for degraded signals on the steady chain. The
angle path of the single-carrier CLI (`demodulate`: one timing phase
per stream picked by |sin 2θ|, coarse CFO removed, float phase symbols
in pi/4 units) feeds `float_to_bits`; `phase_to_bits` is the reference
slicer with its optional pseudo-AFC, on the host.

Plain PyTorch. demodulate_hard_ri at os=1 is the demod that kernel K5
(phy.demod_fused) fuses on the card; its plain version there is built
from _stream_score, _timing_metric, _select and _hard_bits.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from tetra_tpu_torch.device import resolve_device

__all__ = ["rrc_taps", "_band_matrix", "modulate", "bits_to_phase",
           "demodulate_ri", "demodulate", "float_to_bits", "phase_to_bits",
           "_fir_real", "_stream_score", "_timing_metric", "_select",
           "_stream_phasors", "_hard_bits",
           "demodulate_hard_ri", "demodulate_soft_ri",
           "demodulate_hard_slotwise_ri", "demodulate_soft_slotwise_ri"]

# dibit -> phase step in units of pi/4 (reference float_to_bits.c:50-72)
_BITS2STEP = {(0, 0): 1, (0, 1): 3, (1, 0): -1, (1, 1): -3}


@functools.lru_cache(maxsize=8)
def rrc_taps(sps: int, ntaps: int = None, alpha: float = 0.35,
             frac_shift: float = 0.0) -> np.ndarray:
    """Root-raised-cosine taps (gain-normalised), 11*sps taps by
    default; frac_shift (samples) evaluates them off-grid."""
    if ntaps is None:
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
    return (taps / np.sum(taps)).astype(np.float32)


@functools.lru_cache(maxsize=16)
def _band_matrix(ntaps: int, block: int, taps_key) -> np.ndarray:
    """Banded [block+ntaps-1, block] FIR-as-matmul matrix:
    y[o] = sum_m x_ext[m] * band[m, o] with band[m, o] = kernel[m-o]."""
    kernel = np.asarray(taps_key, dtype=np.float32)[::-1]
    K = ntaps
    band = np.zeros((block + K - 1, block), np.float32)
    for o in range(block):
        band[o:o + K, o] = kernel
    return band


def bits_to_phase(bits) -> np.ndarray:
    """ubits [..., 2n] -> cumulative phase steps (pi/4 units) [..., n]."""
    bits = np.asarray(bits).reshape(*np.asarray(bits).shape[:-1], -1, 2)
    steps = np.zeros(bits.shape[:-1], dtype=np.int32)
    for (b0, b1), v in _BITS2STEP.items():
        steps = np.where((bits[..., 0] == b0) & (bits[..., 1] == b1), v, steps)
    return steps


def modulate(bits, sps: int = 2, ntaps: int | None = None) -> np.ndarray:
    """Host fixture generator: ubits [..., 2n] -> complex baseband
    [..., n*sps] (pi/4-DQPSK with RRC pulse shaping)."""
    steps = bits_to_phase(bits)
    phase = np.cumsum(steps, axis=-1) * (np.pi / 4.0)
    symbols = np.exp(1j * phase).astype(np.complex64)
    up = np.zeros(symbols.shape[:-1] + (symbols.shape[-1] * sps,), np.complex64)
    up[..., ::sps] = symbols
    taps = rrc_taps(sps, ntaps)
    out = np.apply_along_axis(lambda r: np.convolve(r, taps * sps, mode="same"),
                              -1, up)
    return out.astype(np.complex64)


def _fir_real(x: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Batched real FIR with same-length output: x [N, T], taps
    [n_filt, ntaps] (or [ntaps]) -> [N, n_filt, T] (or [N, T]).

    y[o] = sum_j x[o - ntaps//2 + j] * taps[ntaps-1-j], zero outside
    the signal (tetra_tpu's banded-matmul FIR, as one convolution)."""
    bank = np.atleast_2d(np.asarray(taps, np.float32))
    ntaps = bank.shape[1]
    pad = ntaps // 2
    w = torch.as_tensor(np.ascontiguousarray(bank[:, ::-1]),
                        device=x.device)[:, None, :]
    xp = F.pad(x.to(torch.float32)[:, None, :], (pad, ntaps - 1 - pad))
    y = F.conv1d(xp, w)
    return y if np.ndim(taps) == 2 else y[:, 0]


def demodulate_ri(re, im, sps: int = 2, est_cfo: bool = True):
    """Planar baseband re, im [..., T] float32 -> float phase symbols
    [..., T//sps] in pi/4 units (±1/±3 on a clean signal): RRC matched
    filter, differential phasor over one symbol, its angle, one timing
    phase per stream picked by the mean |sin 2θ|, and (est_cfo) the
    coarse CFO, the mean deviation from the nearest odd multiple of
    pi/4, subtracted."""
    re = torch.as_tensor(re)
    im = torch.as_tensor(im)
    batch = re.shape[:-1]
    T = re.shape[-1]
    taps = rrc_taps(sps)
    fr = _fir_real(re.reshape(-1, T), taps)
    fi = _fir_real(im.reshape(-1, T), taps)

    # differential phasor z[n] * conj(z[n - sps]) on float planes
    # (zero-padded at the front so output keeps T//sps symbols)
    def lag(x):
        return F.pad(x, (sps, 0))[..., :-sps]

    lr, li = lag(fr), lag(fi)
    dr = fr * lr + fi * li
    di = fi * lr - fr * li
    theta = torch.atan2(di, dr)

    # timing: per stream, the sample phase maximising |sin(2θ)|
    n = (theta.shape[-1] // sps) * sps
    th = theta[..., :n].reshape(theta.shape[0], n // sps, sps)
    score = torch.mean(torch.abs(torch.sin(2.0 * th)), dim=-2)   # [N, sps]
    best = torch.argmax(score, dim=-1)
    sym_theta = th.gather(2, best[:, None, None].expand(
        th.shape[0], th.shape[1], 1))[..., 0]

    q4 = math.pi / 4.0
    if est_cfo:
        # coarse CFO: mean deviation from the nearest odd multiple of pi/4
        quant = torch.round((sym_theta / q4 - 1.0) / 2.0) * 2.0 + 1.0
        err = sym_theta - quant * q4
        sym_theta = sym_theta - torch.mean(err, dim=-1, keepdim=True)

    return (sym_theta / q4).reshape(*batch, n // sps)


def demodulate(iq, sps: int = 2, est_cfo: bool = True, device=None):
    """Complex baseband [..., T] (numpy, or a complex tensor) -> float
    phase symbols [..., T//sps] (a float32 tensor on `device`, the card
    unless the caller asks for the CPU), the reference chain's float
    stream (phase steps in pi/4 units), which feeds float_to_bits."""
    dev = resolve_device(device)
    if not isinstance(iq, torch.Tensor):
        iq = torch.as_tensor(np.asarray(iq, np.complex64))
    iq = iq.to(dev)
    return demodulate_ri(iq.real.to(torch.float32).contiguous(),
                         iq.imag.to(torch.float32).contiguous(),
                         sps=sps, est_cfo=est_cfo)


def float_to_bits(symbols) -> torch.Tensor:
    """Float phase symbols [..., n] -> hard ubits [..., 2n] int8.

    Thresholds and dibit map of reference src/float_to_bits.c:33-72:
    >2 -> +3 -> (0,1); >0 -> +1 -> (0,0); <-2 -> -3 -> (1,1); else -1
    -> (1,0)."""
    s = torch.as_tensor(symbols)
    b0 = (s <= 0).to(torch.int8)
    b1 = ((s > 2) | (s < -2)).to(torch.int8)
    return torch.stack([b0, b1], dim=-1).reshape(*s.shape[:-1],
                                                 s.shape[-1] * 2)


def phase_to_bits(symbols, afc: bool = False, filter_val: float = 1e-4,
                  filter_goal: float = 0.0) -> np.ndarray:
    """Host slicer with the optional one-pole pseudo-AFC
    (reference float_to_bits.c:142-149). Sequential by nature; used for
    file-based parity runs.

    Arithmetic reproduces the C program's mixed float/double evaluation
    exactly (filter stored as float32; `filter * (1.0 - filter_val)`
    promotes to double, `(fl - goal) * filter_val` stays float32), as
    the JAX package's copy does.
    """
    out = np.zeros(len(symbols) * 2, dtype=np.uint8)
    fv = np.float32(filter_val)
    fg = np.float32(filter_goal)
    one_minus = np.float64(1.0) - np.float64(fv)
    filt = np.float32(0.0)
    for i, fl in enumerate(np.asarray(symbols, dtype=np.float32)):
        if afc:
            if -5.0 < fl < 5.0:
                t2 = np.float32(np.float32(fl - fg) * fv)
                filt = np.float32(np.float64(filt) * one_minus
                                  + np.float64(t2))
            fl = np.float32(fl - filt)
        if fl > 2:
            d = (0, 1)
        elif fl > 0:
            d = (0, 0)
        elif fl < -2:
            d = (1, 1)
        else:
            d = (1, 0)
        out[2 * i], out[2 * i + 1] = d
    return out


def _stream_score(re, im, sps: int, os: int):
    """Matched filter (os-x fractional bank), differential phasor and
    the per-carrier timing metric over the whole stream. re, im [C, T]
    -> (drp, dip) [C, T//sps, os*sps] phasors by symbol and sample
    phase, score [C, os*sps] the mean |sin 2θ| of each phase."""
    bank = np.stack([rrc_taps(sps, frac_shift=k / os) for k in range(os)])
    C, T = re.shape

    def mf(x):
        # [C, os, T] -> [C, T*os] with the os phases interleaved
        return _fir_real(x, bank).permute(0, 2, 1).reshape(C, T * os)

    fr, fi = mf(re), mf(im)
    sps2 = os * sps
    lr = F.pad(fr, (sps2, 0))[:, :-sps2]
    li = F.pad(fi, (sps2, 0))[:, :-sps2]
    dr = fr * lr + fi * li
    di = fi * lr - fr * li
    n = (dr.shape[-1] // sps2) * sps2
    drp = dr[:, :n].reshape(C, n // sps2, sps2)
    dip = di[:, :n].reshape(C, n // sps2, sps2)
    score = torch.mean(_timing_metric(drp, dip), dim=-2)
    return drp, dip, score


def _timing_metric(dr, di):
    """|sin 2θ| of the differential phasor, per sample: 2|dr·di| / |d|²."""
    mag2 = dr * dr + di * di
    return 2.0 * torch.abs(dr * di) / (mag2 + 1e-12)


def _select(drp, dip, best):
    """Phasors [C, n_sym, phases] at each carrier's phase best [C] ->
    (sel_r, sel_i) [C, n_sym]."""
    C, n_sym = drp.shape[:2]
    idx = best[:, None, None].expand(C, n_sym, 1)
    return drp.gather(2, idx)[..., 0], dip.gather(2, idx)[..., 0]


def _stream_phasors(re, im, sps: int, os: int):
    """Per-carrier timing-phase pick over the whole stream: re, im
    [C, T] -> selected differential phasors (sel_r, sel_i) [C, T//sps]."""
    drp, dip, score = _stream_score(re, im, sps, os)
    return _select(drp, dip, torch.argmax(score, dim=-1))


def _hard_bits(sel_r, sel_i) -> torch.Tensor:
    """Sign decisions b0 = (Im d <= 0), b1 = (Re d < 0), interleaved:
    [C, n_sym] -> ubits [C, 2·n_sym] int8."""
    b0 = (sel_i <= 0).to(torch.int8)
    b1 = (sel_r < 0).to(torch.int8)
    return torch.stack([b0, b1], dim=-1).reshape(sel_r.shape[0], -1)


def demodulate_hard_ri(re, im, sps: int = 2, os: int = 1) -> torch.Tensor:
    """Trig-free hard decisions on the differential phasor d:
    b0 = (Im d <= 0), b1 = (Re d < 0). re, im [C, T] float32 -> ubits
    [C, 2*(T//sps)] int8. os > 1 adds fractional timing (os=4 on the
    wideband path, where resampling leaves the symbol clock at an
    arbitrary offset)."""
    return _hard_bits(*_stream_phasors(re, im, sps, os))


def demodulate_soft_ri(re, im, sps: int = 2, os: int = 1) -> torch.Tensor:
    """Soft decisions on the same selected phasors as demodulate_hard_ri:
    re, im [C, T] float32 -> int8 reliabilities [C, 2*(T//sps)]
    (positive = bit 0; hard decision = soft < 0). Each component is
    divided by the carrier's mean phasor magnitude over this call,
    clipped at ±4 and quantised as round(x * 31) (±124 full scale).

    The normalisation is per call (per feed window), as in tetra_tpu,
    so a carrier's scale moves with each chunk's content."""
    sel_r, sel_i = _stream_phasors(re, im, sps, os)
    nrm = torch.sqrt(sel_r * sel_r + sel_i * sel_i).mean(
        dim=-1, keepdim=True) + 1e-9
    s0 = torch.clamp(sel_i / nrm, -4.0, 4.0)
    s1 = torch.clamp(sel_r / nrm, -4.0, 4.0)
    q = torch.round(torch.stack([s0, s1], dim=-1) * 31.0).to(torch.int8)
    return q.reshape(re.shape[0], -1)


def _slotwise_phasors(re, im, n_slots: int, phase_bit: int, sps: int):
    """Degraded-signal demod core: per-SLOT timing pick and blind
    residual-CFO correction (the feed-forward substitute for the
    reference's Costas + Mueller&Müller loops, cqpsk.py:254-263).

    A 4x bank of fractionally shifted RRC filters bounds the sampling
    error at T/16. Per slot (255 symbols) and sample phase, the residual
    carrier phase eps = (angle(sum d^4 / |d^4|) - pi) / 4 needs no
    decisions (every pi/4-DQPSK phasor has angle(d^4) = pi + 4 eps); d
    is de-rotated by eps, then the |sin 2θ| metric picks the phase.
    re, im [C, T] -> selected phasors (rr, ri) [C, n_slots, 255] for
    slots whose first bit is at `phase_bit`."""
    OS = 4
    bank = np.stack([rrc_taps(sps, frac_shift=k / OS) for k in range(OS)])
    Cn, T = re.shape

    def mf(x):
        return _fir_real(x, bank).permute(0, 2, 1).reshape(Cn, T * OS)

    fr, fi = mf(re), mf(im)
    sps2 = OS * sps
    lr = F.pad(fr, (sps2, 0))[:, :-sps2]
    li = F.pad(fi, (sps2, 0))[:, :-sps2]
    dr = fr * lr + fi * li
    di = fi * lr - fr * li

    sym0 = phase_bit // 2
    n_sym = sym0 + n_slots * 255

    def slotted(x):
        x = x[:, :n_sym * sps2].reshape(Cn, n_sym, sps2)[:, sym0:]
        return x.reshape(Cn, n_slots, 255, sps2)

    dr, di = slotted(dr), slotted(di)
    r2 = dr * dr - di * di
    i2 = 2.0 * dr * di
    zr = r2 * r2 - i2 * i2
    zi = 2.0 * r2 * i2
    m4 = torch.sqrt(zr * zr + zi * zi) + 1e-12
    ang = torch.atan2(torch.sum(zi / m4, dim=-2), torch.sum(zr / m4, dim=-2))
    e4 = ang - math.pi                                  # wrap to (-pi, pi]
    e4 = torch.where(e4 <= -math.pi, e4 + 2.0 * math.pi, e4)
    eps = e4 / 4.0                                      # [C, S, sps2]
    ce = torch.cos(-eps)[..., None, :]
    se = torch.sin(-eps)[..., None, :]
    cr = dr * ce - di * se
    ci = dr * se + di * ce
    score = torch.mean(_timing_metric(cr, ci), dim=-2)
    best = torch.argmax(score, dim=-1)                  # [C, S]
    idx = best[..., None, None].expand(Cn, n_slots, 255, 1)
    return cr.gather(3, idx)[..., 0], ci.gather(3, idx)[..., 0]


def demodulate_hard_slotwise_ri(re, im, n_slots: int, phase_bit: int = 0,
                                sps: int = 2) -> torch.Tensor:
    """Hard bits [C, n_slots, 510] int8 from the per-slot timing and
    CFO-corrected phasors (b0 = Im <= 0, b1 = Re < 0)."""
    rr, ri = _slotwise_phasors(re, im, n_slots, phase_bit, sps)
    bits = torch.stack([(ri <= 0).to(torch.int8), (rr < 0).to(torch.int8)],
                       dim=-1)
    return bits.reshape(re.shape[0], n_slots, 510)


def demodulate_soft_slotwise_ri(re, im, n_slots: int, phase_bit: int = 0,
                                sps: int = 2) -> torch.Tensor:
    """Soft values [C, n_slots, 510] float32 (positive = bit 0) from
    the slotwise phasors: each component divided by the slot's mean
    phasor magnitude and clipped at ±4 (the fast="soft" steady path)."""
    rr, ri = _slotwise_phasors(re, im, n_slots, phase_bit, sps)
    nrm = torch.sqrt(rr * rr + ri * ri).mean(dim=-1, keepdim=True) + 1e-9
    s0 = torch.clamp(ri / nrm, -4.0, 4.0)
    s1 = torch.clamp(rr / nrm, -4.0, 4.0)
    return torch.stack([s0, s1], dim=-1).reshape(re.shape[0], n_slots, 510)
