"""Fused hard-decision pi/4-DQPSK demodulator (kernel K5).

Port of tetra_tpu.phy.demod_pallas: the same RRC matched filter,
differential phasor, trig-free sign decisions and |sin 2θ| timing
metric as dqpsk.demodulate_hard_ri(os=1), in one pass over the planes.
The CUDA kernel (csrc/demod_fused.cu) writes the packed per-sample
decisions b0 | b1 << 1 and per-block partial metric sums; the phase
argmax, the gather of the chosen phase, the bit unpack and the slot cut
run in PyTorch, as the TPU version leaves them to XLA.

The wrappers run the plain version (dqpsk.demodulate_hard_ri at os=1,
its bits packed per symbol) for CPU tensors and launch the kernel for
CUDA tensors, raising if it cannot; the unpack and the slot cut are
shared.

Metric range: the kernel sums the metric over samples t < (T // sps) *
sps, the range of the XLA demod and the plain version. The TPU kernel
also counts the filter-tail lanes past T in its last time block when T
is not a multiple of its block (ROADMAP: faults against the reference).
"""
from __future__ import annotations

import functools

import torch

from tetra_tpu_torch import constants as C
from tetra_tpu_torch import kernels
from tetra_tpu_torch.phy import dqpsk

__all__ = ["demod_fused", "demodulate_hard_ri_pallas",
           "demodulate_hard_slots_ri_pallas"]

_SPS = 2                       # the kernel's one rate (every path's)
_TB_STEP = 256                 # time blocks are whole multiples of this
_MAX_TB = 1024
_N_SYM_SLOT = C.BITS_PER_TS // 2


@functools.lru_cache(maxsize=8)
def _taps(sps: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(dqpsk.rrc_taps(sps), device=device)


def _block(T: int, tile_t: int) -> int:
    """Time block of the kernel: tile_t rounded to a multiple of 256
    (at most 1024), no longer than the stream needs."""
    tb = min(tile_t, -(-T // _TB_STEP) * _TB_STEP)
    return max(_TB_STEP, min(_MAX_TB, -(-tb // _TB_STEP) * _TB_STEP))


def demod_fused(re: torch.Tensor, im: torch.Tensor, sps: int = 2,
                tile_t: int = 512):
    """Launch kernel K5 on CUDA planes re, im f32 [C, T] -> (pk int8
    [C, T] packed decisions per sample, part f32 [C, n_blk, sps]
    metric sums per time block and sample phase). The kernel is built
    for sps 2 only; any other rate raises."""
    kernels.require_cuda(re, "re", torch.float32, 2)
    kernels.require_cuda(im, "im", torch.float32, 2)
    if re.shape != im.shape or re.device != im.device:
        raise ValueError("demod_fused: re and im differ in shape or device")
    if sps != _SPS:
        raise ValueError(f"demod_fused: the kernel runs sps {_SPS} only, "
                         f"got {sps}")
    Cn, T = re.shape
    tb = _block(T, tile_t)
    n_blk = -(-T // tb)
    taps = _taps(sps, re.device)
    pk = torch.empty((Cn, T), dtype=torch.int8, device=re.device)
    part = torch.empty((Cn, n_blk, sps), dtype=torch.float32,
                       device=re.device)
    rc = kernels.lib().tt_demod_fused(
        re.data_ptr(), im.data_ptr(), taps.data_ptr(), taps.shape[0], Cn, T,
        sps, tb, pk.data_ptr(), part.data_ptr(),
        kernels.stream_ptr(re.device))
    kernels.check(rc, "tt_demod_fused")
    demod_fused.launches += 1
    return pk, part


demod_fused.launches = 0


def _demod_parts(re, im, sps: int = 2, tile_t: int = 512):
    """Kernel + phase selection on CUDA planes -> (sel int8 [C, T//sps]
    packed per-symbol decisions b0 | b1 << 1, best [C] the chosen
    sample phase, part the kernel's partial metric sums)."""
    pk, part = demod_fused(re, im, sps, tile_t)
    Cn, T = re.shape
    n_sym = T // sps
    best = torch.argmax(part.sum(dim=1), dim=-1)                # [C]
    pk = pk[:, :n_sym * sps].reshape(Cn, n_sym, sps)
    sel = pk.gather(2, best[:, None, None].expand(Cn, n_sym, 1))[..., 0]
    return sel, best, part


def _demod_sel(re, im, sps: int = 2, tile_t: int = 512) -> torch.Tensor:
    """Packed per-symbol decisions [C, T//sps] int8 (b0 | b1 << 1),
    shared by the bit-stream and slot-framed entry points: kernel K5 on
    CUDA planes, the plain version's bits packed on CPU planes."""
    if re.device.type == "cpu":
        bits = dqpsk.demodulate_hard_ri(re, im, sps=sps)
        b = bits.reshape(bits.shape[0], -1, 2)
        return b[..., 0] | (b[..., 1] << 1)
    return _demod_parts(re, im, sps, tile_t)[0]


def _unpack_bits(sel: torch.Tensor) -> torch.Tensor:
    bits = torch.stack([sel & 1, (sel >> 1) & 1], dim=-1)
    return bits.reshape(sel.shape[0], 2 * sel.shape[1])


def demodulate_hard_ri_pallas(re, im, sps: int = 2,
                              tile_t: int = 512) -> torch.Tensor:
    """Planar baseband [C, T] f32 -> hard ubits [C, 2·(T//sps)] int8.

    The name is tetra_tpu's; on a card this is kernel K5 (CUDA), on the
    CPU the plain version dqpsk.demodulate_hard_ri(os=1). tile_t is the
    kernel's time block (rounded to a multiple of 256, at most 1024)."""
    return _unpack_bits(_demod_sel(re, im, sps, tile_t))


def demodulate_hard_slots_ri_pallas(re, im, n_slots: int,
                                    phase_bit: int = 0, sps: int = 2,
                                    tile_t: int = 512):
    """Planar baseband [C, T] f32 -> (slots [C, n_slots, 510], bits
    [C, 2·(T//sps)]) locked at bit `phase_bit`, which must be even (a
    whole-symbol offset). The slot framing is cut on the packed
    per-symbol decisions before the unpack."""
    if phase_bit % 2:
        raise ValueError("slot framing needs a whole-symbol offset "
                         "(even phase_bit)")
    Cn = re.shape[0]
    sel = _demod_sel(re, im, sps, tile_t)
    off = phase_bit // 2
    sel_s = sel[:, off: off + n_slots * _N_SYM_SLOT].reshape(
        Cn, n_slots, _N_SYM_SLOT)
    slots = torch.stack([sel_s & 1, (sel_s >> 1) & 1], dim=-1).reshape(
        Cn, n_slots, C.BITS_PER_TS)
    return slots, _unpack_bits(sel)
