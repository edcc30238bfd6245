"""Unsegmented 16-state Viterbi over float soft values (kernel K6).

Port of tetra_tpu.ops.viterbi_pallas.decode_pallas, the device branch of
tetra_tpu.ops.viterbi.decode_auto: soft [..., >= n_sym*N] -> decoded
bits [..., n_sym], starting from the all-zero state and tracing back from
the lowest-index best end state. Its path is the TCH/S voice decode
(ops.acelp.tch_s_decode -> viterbi.decode_tch: rate 1/3, n_sym 112 and
72). The TPU sends even n_sym to decode_segmented_pallas with no
boundaries and keeps its own body for odd n_sym; here every n_sym takes
K4's lane-group body with no restarts (csrc/viterbi_segmented.cu,
launcher tt_viterbi_decode: 16 lanes per row, 8 rows per block), which
reads the rows in place, row-major, with the row stride as an argument.

`decode_k6` is viterbi.decode_auto's one dispatch point: it runs the
plain version (ops.viterbi.decode, float32 metrics) for CPU tensors and
launches the kernel for CUDA tensors, raising if it cannot. A float32
input whose rows have unit column stride (a contiguous tensor, or a
column slice of one) is one launch and nothing else; any other dtype or
layout gets one cast or copy first, as decode_pallas casts.
"""
from __future__ import annotations

import torch

from tetra_tpu_torch import kernels
from tetra_tpu_torch.constants import CONV_GENERATORS_CCH
from tetra_tpu_torch.ops.viterbi import decode
from tetra_tpu_torch.ops.viterbi_segmented import MAX_SYM, patterns_on

__all__ = ["decode_k6"]


def decode_k6(soft: torch.Tensor, n_sym: int,
              generators=CONV_GENERATORS_CCH) -> torch.Tensor:
    """soft [..., >= n_sym*N] soft bits (positive = bit 0; any real
    dtype, cast to float32 as the TPU kernel casts it) -> bits [...,
    n_sym] int8.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (0 < n_sym <= MAX_SYM = 292, 0 < N <= 4 generators); anything else
    raises."""
    gens = tuple(map(tuple, generators))
    if soft.device.type == "cpu":
        return decode(soft, n_sym, gens)
    if soft.device.type != "cuda":
        raise ValueError(f"soft must be a CUDA tensor, got {soft.device}")
    n = len(gens)
    w = n_sym * n
    x = soft.reshape(-1, soft.shape[-1])
    if not (0 < n_sym <= MAX_SYM and 0 < n <= 4) or x.shape[1] < w:
        raise ValueError(f"decode_k6: unsupported n_sym {n_sym}, {n} "
                         f"generators or width {x.shape[1]}")
    if x.dtype != torch.float32 or x.stride(1) != 1 or x.stride(0) < w:
        x = x[:, :w].to(torch.float32).contiguous()
    B = x.shape[0]
    bits = torch.empty((B, n_sym), dtype=torch.int8, device=soft.device)
    if B:
        rc = kernels.lib().tt_viterbi_decode(
            x.data_ptr(), x.stride(0),
            patterns_on(gens, soft.device).data_ptr(), n, bits.data_ptr(), B,
            n_sym, kernels.stream_ptr(soft.device))
        kernels.check(rc, "tt_viterbi_decode")
        decode_k6.launches += 1
    return bits.reshape(*soft.shape[:-1], n_sym)


decode_k6.launches = 0
