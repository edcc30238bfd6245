"""Fused hard-decision pi/4-DQPSK demodulator (kernel K5).

Port of tetra_tpu.phy.demod_pallas: the same RRC matched filter,
differential phasor, trig-free sign decisions and |sin 2θ| timing
metric as dqpsk.demodulate_hard_ri(os=1), in one pass over the planes.
The CUDA kernel (csrc/demod_fused.cu) also sums the metric over the
whole stream, picks each carrier's timing phase and writes the chosen
phase's bits; on the TPU the pick and the gather run in XLA after the
kernel. Slots are a view of the bits.

`demod_fused` runs the plain version (`demod_fused_plain`) for CPU
tensors and launches the kernel for CUDA tensors, raising if it cannot.
Both take every rate sps = 1..11 (the TPU kernel's: an 11·sps-tap
filter within its 128-lane halo) and raise ValueError for any other.

Metric range: the sums run over samples t < (T // sps) * sps, the
range of the XLA demod and the plain version. The TPU kernel also
counts the filter-tail lanes past T in its last time block when T is
not a multiple of its block (ROADMAP: faults against the reference).
"""
from __future__ import annotations

import torch

from tetra_tpu_torch import constants as C
from tetra_tpu_torch import kernels
from tetra_tpu_torch.phy import dqpsk

__all__ = ["SPS_RATES", "demod_fused", "demod_fused_plain",
           "demodulate_hard_ri_pallas", "demodulate_hard_slots_ri_pallas"]

SPS_RATES = range(1, 12)       # the rates the kernel is built for


def demod_fused_plain(re, im, sps: int = 2):
    """Plain PyTorch K5: planes re, im f32 [C, T] -> (bits int8
    [C, 2·(T//sps)] of the chosen phase, best int64 [C] the chosen
    sample phase, met f32 [C, sps] the metric summed over the stream).
    bits and best are dqpsk.demodulate_hard_ri's (best is the argmax of
    the metric's mean, which orders the phases as the sum does)."""
    drp, dip, score = dqpsk._stream_score(re, im, sps, 1)
    best = torch.argmax(score, dim=-1)
    met = dqpsk._timing_metric(drp, dip).sum(dim=-2)
    return dqpsk._hard_bits(*dqpsk._select(drp, dip, best)), best, met


def demod_fused(re: torch.Tensor, im: torch.Tensor, sps: int = 2):
    """K5: planes re, im f32 [C, T] -> (bits int8 [C, 2·(T//sps)],
    best int64 [C], met f32 [C, sps]), as demod_fused_plain. CPU planes
    take the plain version; CUDA planes launch the kernel. sps must be
    in SPS_RATES."""
    if sps not in SPS_RATES:
        raise ValueError(f"demod_fused: sps must be 1..11, got {sps}")
    if re.device.type == "cpu":
        return demod_fused_plain(re, im, sps)
    kernels.require_cuda(re, "re", torch.float32, 2)
    kernels.require_cuda(im, "im", torch.float32, 2)
    if re.shape != im.shape or re.device != im.device:
        raise ValueError("demod_fused: re and im differ in shape or device")
    Cn, T = re.shape
    n_sym = T // sps
    row = kernels.lib().tt_demod_fused_scratch(sps, T)
    taps = dqpsk.rrc_taps(sps)
    dev = re.device
    bits = torch.empty((Cn, 2 * n_sym), dtype=torch.int8, device=dev)
    best = torch.empty(Cn, dtype=torch.int64, device=dev)
    met = torch.empty((Cn, sps), dtype=torch.float32, device=dev)
    scratch = torch.empty((Cn, row), dtype=torch.uint8, device=dev)
    rc = kernels.lib().tt_demod_fused(
        re.data_ptr(), im.data_ptr(), taps.ctypes.data, len(taps), Cn, T,
        sps, bits.data_ptr(), best.data_ptr(), met.data_ptr(),
        scratch.data_ptr(), row, kernels.stream_ptr(dev))
    kernels.check(rc, "tt_demod_fused")
    demod_fused.launches += 1
    return bits, best, met


demod_fused.launches = 0


def demodulate_hard_ri_pallas(re, im, sps: int = 2) -> torch.Tensor:
    """Planar baseband [C, T] f32 -> hard ubits [C, 2·(T//sps)] int8.

    The name is tetra_tpu's; on a card this is kernel K5 (CUDA), on the
    CPU its plain version, dqpsk.demodulate_hard_ri(os=1)."""
    return demod_fused(re, im, sps)[0]


def demodulate_hard_slots_ri_pallas(re, im, n_slots: int,
                                    phase_bit: int = 0, sps: int = 2):
    """Planar baseband [C, T] f32 -> (slots [C, n_slots, 510], bits
    [C, 2·(T//sps)]) locked at bit `phase_bit`, which must be even (a
    whole-symbol offset). slots is a view of bits (no copy)."""
    if phase_bit % 2:
        raise ValueError("slot framing needs a whole-symbol offset "
                         "(even phase_bit)")
    bits = demod_fused(re, im, sps)[0]
    slots = bits[:, phase_bit: phase_bit + n_slots * C.BITS_PER_TS].view(
        bits.shape[0], n_slots, C.BITS_PER_TS)
    return slots, bits
