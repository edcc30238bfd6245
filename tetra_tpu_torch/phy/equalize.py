"""Per-slot pilot-aided fractionally-spaced equaliser, the multipath mode
of the steady chain (port of tetra_tpu.phy.equalize).

Reference analogue: the CMA equaliser of src/demod/simdemod3.py:65-70, a
blind sequential LMS loop, redesigned feed-forward and pilot-aided:
every TETRA burst carries a known training sequence (normal: 11 symbols
at symbol 122; sync: 19 at symbol 107), so a linear T/2-spaced
equaliser is fitted per slot by ridge least squares on those pilots.

Per (carrier, slot), all batched, in the JAX package's order:
1. `_slot_planes`: matched filter at sps 2, slots cut into two
   polyphase symbol streams z [C, S, 255, 2] (a fractionally-spaced
   equaliser subsumes fractional timing);
2. `_cfo`: the blind residual CFO from the quadrupling nonlinearity on
   the phase that concentrates the quartic sum more, per-slot amplitude
   normalisation, and a coarse CFO from the pilot differentials;
3. `_pilot_fits`: four de-rotation candidates (quartic estimate, its
   ±π/2 aliases, the pilot estimate), each fitted to both pilot
   hypotheses (normal, sync); the slot keeps the candidate and
   hypothesis with the smallest residual (first on ties);
4. `_equalise`: the L_PILOT-tap x 2-phase FIR, two decision-directed
   refits on all 255 symbols (L_TAPS taps), each kept only where it
   does not worsen the pilot alignment beyond the gate;
5. differential detection and hard slicing (`_slice`).

Complex values travel as float planes; the 2Ng x 2Ng normal equations
use the real embedding [[Mr, -Mi], [Mi, Mr]] and torch.linalg.solve.
Plain PyTorch: the JAX package computes this in XLA, outside Pallas.
Only the running best candidate's planes are kept, so at 4096 carriers
x 64 slots the live set stays a few [C, S, 255, 2] planes.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from tetra_tpu_torch import constants as C
from tetra_tpu_torch.phy import dqpsk

__all__ = ["demodulate_hard_eq_slotwise_ri", "equalised_symbols",
           "L_PILOT", "L_TAPS", "RIDGE", "DD_PASSES"]

L_PILOT = 2           # taps a polyphase for the pilot pass: the normal
                      # training is only 11 symbols, so the pilot fit
                      # stays over-determined (8 real unknowns, 11 eqs)
L_TAPS = 3            # taps a polyphase for the decision-directed passes
RIDGE = 3e-2
DD_PASSES = 2
_Q4 = math.pi / 4.0


@functools.lru_cache(maxsize=4)
def _pilots():
    """Host constants: (t0, ur, ui) per hypothesis (normal, sync), u_k =
    exp(j·π/4·Σ_{m=1..k} steps_m), the pilot symbols relative to the
    first (whose absolute phase the equaliser absorbs)."""
    out = []
    for bits, bit_off in ((C.TRAIN_N, C.NORM_TRAIN_OFFSET),
                          (C.TRAIN_Y, C.SYNC_TRAIN_OFFSET)):
        steps = np.asarray(dqpsk.bits_to_phase(bits[None]))[0]
        ph = np.concatenate([[0.0], np.cumsum(steps[1:]) * (np.pi / 4)])
        u = np.exp(1j * ph)
        out.append((bit_off // 2, u.real.astype(np.float32),
                    u.imag.astype(np.float32)))
    return tuple(out)


def _shift(x: torch.Tensor, l: int, dim: int = -1) -> torch.Tensor:
    """x[..., n, ...] -> x[..., n-l, ...] with zero history along `dim`
    (slot-local: each slot starts from zeros)."""
    if l == 0:
        return x
    dim = dim % x.dim()
    shape = list(x.shape)
    shape[dim] = l
    return torch.cat([x.new_zeros(shape), x.narrow(dim, 0, x.shape[dim] - l)],
                     dim=dim)


def _tap_matrix(zr, zi, t0: int, Nt: int, L: int):
    """Feature rows A[..., e, p*L+l] = z_p[t0 + e - l] (planar)."""
    cols_r, cols_i = [], []
    for p in range(2):
        for l in range(L):
            cols_r.append(zr[..., t0 - l:t0 - l + Nt, p])
            cols_i.append(zi[..., t0 - l:t0 - l + Nt, p])
    return torch.stack(cols_r, dim=-1), torch.stack(cols_i, dim=-1)


def _ls_solve(Ar, Ai, ur, ui, lam: float, residual: bool = True):
    """Batched complex ridge least squares through the real embedding.
    Ar, Ai [..., Ne, Ng]; ur, ui [Ne] or [..., Ne]. Returns (gr, gi
    [..., Ng], the mean residual [...] or None)."""
    Ng = Ar.shape[-1]
    ur = ur.expand(Ar.shape[:-1])
    ui = ui.expand(Ar.shape[:-1])
    ein = torch.einsum
    Mr = ein("...ei,...ej->...ij", Ar, Ar) + ein("...ei,...ej->...ij", Ai, Ai)
    Mi = ein("...ei,...ej->...ij", Ar, Ai) - ein("...ei,...ej->...ij", Ai, Ar)
    br = ein("...ei,...e->...i", Ar, ur) + ein("...ei,...e->...i", Ai, ui)
    bi = ein("...ei,...e->...i", Ar, ui) - ein("...ei,...e->...i", Ai, ur)
    B = torch.cat([torch.cat([Mr, -Mi], dim=-1),
                   torch.cat([Mi, Mr], dim=-1)], dim=-2)
    B = B + lam * torch.eye(2 * Ng, dtype=B.dtype, device=B.device)
    rhs = torch.cat([br, bi], dim=-1)[..., None]
    g = torch.linalg.solve(B, rhs)[..., 0]
    gr, gi = g[..., :Ng], g[..., Ng:]
    if not residual:
        return gr, gi, None
    yr = ein("...ei,...i->...e", Ar, gr) - ein("...ei,...i->...e", Ai, gi)
    yi = ein("...ei,...i->...e", Ar, gi) + ein("...ei,...i->...e", Ai, gr)
    res = torch.mean((yr - ur) ** 2 + (yi - ui) ** 2, dim=-1)
    return gr, gi, res


def _fit_hypothesis(zr, zi, t0: int, ur, ui, lam: float):
    """Ridge fit of the 2·L_PILOT-tap equaliser to one pilot span."""
    Ar, Ai = _tap_matrix(zr, zi, t0, ur.shape[0], L_PILOT)
    return _ls_solve(Ar, Ai, ur, ui, lam)


def _slot_planes(re, im, n_slots: int, phase_bit: int):
    """Matched filter at sps 2 and the slot cut: re, im [C, T] ->
    polyphase symbol planes zr, zi [C, S, 255, 2]."""
    taps = dqpsk.rrc_taps(2)
    sym0 = phase_bit // 2
    need = (sym0 + n_slots * 255) * 2

    def slot_phases(x):
        f = dqpsk._fir_real(x, taps)
        f = f[:, :need].reshape(f.shape[0], sym0 + n_slots * 255, 2)
        return f[:, sym0:].reshape(f.shape[0], n_slots, 255, 2)

    return slot_phases(re), slot_phases(im)


def _cfo(zr, zi):
    """Blind residual CFO per slot from the quartic sum of the sample
    phase that concentrates it more (which phase lands on the symbol
    instants is not known yet), per-slot amplitude normalisation, and
    the pilots' coarse estimate (the pilot differentials times the
    conjugate steps all point at e^{jε}; of both hypotheses and phases,
    the most concentrated). Returns (zr, zi normalised, eps [C, S],
    eps_pilot [C, S])."""
    lr, li = _shift(zr, 1, dim=-2), _shift(zi, 1, dim=-2)
    dr = zr * lr + zi * li
    di = zi * lr - zr * li
    del lr, li
    r2 = dr * dr - di * di
    i2 = 2.0 * dr * di
    del dr, di
    qr = r2 * r2 - i2 * i2
    qi = 2.0 * r2 * i2
    del r2, i2
    m4 = torch.sqrt(qr * qr + qi * qi) + 1e-12
    sr = torch.sum(qr / m4, dim=-2)                        # [C, S, 2]
    si = torch.sum(qi / m4, dim=-2)
    del qr, qi, m4
    conc = sr * sr + si * si
    pick = torch.argmax(conc, dim=-1, keepdim=True)        # [C, S, 1]
    sr = torch.gather(sr, -1, pick)[..., 0]
    si = torch.gather(si, -1, pick)[..., 0]
    ang = torch.atan2(si, sr)
    e4 = ang - math.pi
    e4 = torch.where(e4 <= -math.pi, e4 + 2.0 * math.pi, e4)
    eps = e4 / 4.0

    nrm = torch.sqrt(torch.mean(zr * zr + zi * zi, dim=(-2, -1),
                                keepdim=True)) + 1e-9
    zr = zr / nrm
    zi = zi / nrm

    vr_best = torch.full(eps.shape, -1.0, device=eps.device)
    vbr = torch.zeros(eps.shape, device=eps.device)
    vbi = torch.zeros(eps.shape, device=eps.device)
    for t0, ur, ui in _pilots():
        Nt = ur.shape[0]
        st_r = torch.as_tensor(ur[1:] * ur[:-1] + ui[1:] * ui[:-1],
                               device=zr.device)
        st_i = torch.as_tensor(ui[1:] * ur[:-1] - ur[1:] * ui[:-1],
                               device=zr.device)
        for p in range(2):
            sr_p = zr[..., t0:t0 + Nt, p]
            si_p = zi[..., t0:t0 + Nt, p]
            ddr = sr_p[..., 1:] * sr_p[..., :-1] + si_p[..., 1:] * si_p[..., :-1]
            ddi = si_p[..., 1:] * sr_p[..., :-1] - sr_p[..., 1:] * si_p[..., :-1]
            vr = torch.sum(ddr * st_r + ddi * st_i, dim=-1)
            vi = torch.sum(ddi * st_r - ddr * st_i, dim=-1)
            conc_p = vr * vr + vi * vi
            better = conc_p > vr_best
            vr_best = torch.where(better, conc_p, vr_best)
            vbr = torch.where(better, vr, vbr)
            vbi = torch.where(better, vi, vbi)
    return zr, zi, eps, torch.atan2(vbi, vbr)


def _pilot_fits(zr, zi, eps, eps_pilot):
    """De-rotate with each candidate (eps, eps ± π/2: the quartic
    estimate is ambiguous modulo π/2; eps_pilot), fit both pilot
    hypotheses, keep per slot the candidate with the smallest residual
    (the first on ties, as argmin) and its hypothesis' taps. Returns the
    chosen de-rotated planes zr, zi [C, S, 255, 2] and taps gr, gi
    [C, S, 2·L_PILOT]."""
    (t0n, urn, uin), (t0s, urs, uis) = _pilots()
    dev = zr.device
    urn, uin, urs, uis = (torch.as_tensor(a, device=dev)
                          for a in (urn, uin, urs, uis))
    n_idx = torch.arange(255, dtype=torch.float32, device=dev)
    best = None
    for k in (0.0, np.pi / 2, -np.pi / 2, None):
        e = eps_pilot if k is None else eps + k
        ph = -e[..., None] * n_idx
        ce, se = torch.cos(ph)[..., None], torch.sin(ph)[..., None]
        zrk, zik = zr * ce - zi * se, zr * se + zi * ce
        del ph, ce, se
        grn, gin, resn = _fit_hypothesis(zrk, zik, t0n, urn, uin, RIDGE)
        grs, gis, ress = _fit_hypothesis(zrk, zik, t0s, urs, uis, RIDGE)
        use_n = (resn <= ress)[..., None]
        cand = (zrk, zik, torch.where(use_n, grn, grs),
                torch.where(use_n, gin, gis), torch.minimum(resn, ress))
        if best is None:
            best = cand
        else:
            better = cand[4] < best[4]
            bz = better[..., None, None]
            bg = better[..., None]
            best = (torch.where(bz, cand[0], best[0]),
                    torch.where(bz, cand[1], best[1]),
                    torch.where(bg, cand[2], best[2]),
                    torch.where(bg, cand[3], best[3]),
                    torch.where(better, cand[4], best[4]))
        del cand, zrk, zik
    return best[:4]


def _apply_fir(zr, zi, gr, gi, L: int):
    """Run each slot's symbols through its L-tap x 2-phase FIR g:
    y[n] = Σ_{p, l} g[p·L + l] · z_p[n - l] (zero history a slot)."""
    yr = torch.zeros(zr.shape[:-1], dtype=zr.dtype, device=zr.device)
    yi = torch.zeros(zr.shape[:-1], dtype=zr.dtype, device=zr.device)
    for p in range(2):
        for l in range(L):
            k = p * L + l
            zsr = _shift(zr[..., p], l)
            zsi = _shift(zi[..., p], l)
            yr = yr + gr[..., k, None] * zsr - gi[..., k, None] * zsi
            yi = yi + gr[..., k, None] * zsi + gi[..., k, None] * zsr
    return yr, yi


def _pilot_err(yr, yi):
    """Rotation-invariant pilot mismatch, the smaller of both hypotheses:
    min_φ Σ|y·e^{-jφ} - u|²/Nt = (Σ|y|² + Nt - 2|Σ y·conj(u)|)/Nt."""
    errs = []
    for t0, ur, ui in _pilots():
        Nt = ur.shape[0]
        sr = yr[..., t0:t0 + Nt]
        si = yi[..., t0:t0 + Nt]
        ur = torch.as_tensor(ur, device=yr.device)
        ui = torch.as_tensor(ui, device=yr.device)
        cr = torch.sum(sr * ur + si * ui, dim=-1)
        ci = torch.sum(si * ur - sr * ui, dim=-1)
        pw = torch.sum(sr * sr + si * si, dim=-1)
        errs.append((pw + Nt - 2.0 * torch.sqrt(cr * cr + ci * ci)) / Nt)
    return torch.minimum(*errs)


def _equalise(zr, zi, gr, gi):
    """The pilot taps' output, then DD_PASSES decision-directed refits:
    the previous pass's symbols projected onto the 8-PSK grid (round
    half to even) refit on all symbols with L_TAPS taps, each pass kept
    where its pilot error stays within max(2·err, err + 0.25) (a wrong
    attractor scores ~2). Returns equalised symbols yr, yi [C, S, 255]."""
    yr, yi = _apply_fir(zr, zi, gr, gi, L_PILOT)
    Ar, Ai = _tap_matrix(zr, zi, L_TAPS - 1, 255 - (L_TAPS - 1), L_TAPS)
    err = _pilot_err(yr, yi)
    for _ in range(DD_PASSES):
        q = torch.round(torch.atan2(yi, yr) / _Q4) * _Q4
        gr2, gi2, _ = _ls_solve(Ar, Ai, torch.cos(q)[..., L_TAPS - 1:],
                                torch.sin(q)[..., L_TAPS - 1:], RIDGE,
                                residual=False)
        del q
        yr2, yi2 = _apply_fir(zr, zi, gr2, gi2, L_TAPS)
        err2 = _pilot_err(yr2, yi2)
        keep = err2 <= torch.maximum(2.0 * err, err + 0.25)
        yr = torch.where(keep[..., None], yr2, yr)
        yi = torch.where(keep[..., None], yi2, yi)
        err = torch.where(keep, err2, err)
        del yr2, yi2
    return yr, yi


def _slice(yr, yi) -> torch.Tensor:
    """Differential detection (slot-local lag) and hard slicing:
    [C, S, 255] -> bits [C, S, 510] int8 (b0 = Im <= 0, b1 = Re < 0)."""
    pyr, pyi = _shift(yr, 1), _shift(yi, 1)
    ddr = yr * pyr + yi * pyi
    ddi = yi * pyr - yr * pyi
    bits = torch.stack([(ddi <= 0).to(torch.int8), (ddr < 0).to(torch.int8)],
                       dim=-1)
    return bits.reshape(*bits.shape[:-2], 510)


def equalised_symbols(re, im, n_slots: int, phase_bit: int = 0,
                      sps: int = 2):
    """Planar [C, T] float32 at sps 2 -> equalised symbols (yr, yi)
    [C, n_slots, 255] of slots starting at bit `phase_bit`."""
    if sps != 2:
        raise ValueError("the T/2-spaced equaliser expects 2 samples a "
                         f"symbol, got sps {sps}")
    zr, zi = _slot_planes(re, im, n_slots, phase_bit)
    zr, zi, eps, eps_pilot = _cfo(zr, zi)
    zr, zi, gr, gi = _pilot_fits(zr, zi, eps, eps_pilot)
    return _equalise(zr, zi, gr, gi)


def demodulate_hard_eq_slotwise_ri(re, im, n_slots: int, phase_bit: int = 0,
                                   sps: int = 2) -> torch.Tensor:
    """Equalised hard demod: planar [C, T] -> hard bits [C, n_slots, 510]
    int8, the call shape of dqpsk.demodulate_hard_slotwise_ri with the
    per-slot pilot-aided T/2 equaliser between the matched filter and
    the differential detector."""
    return _slice(*equalised_symbols(re, im, n_slots, phase_bit, sps))
