"""Unsegmented 16-state Viterbi over float soft values (kernel K6).

Port of tetra_tpu.ops.viterbi_pallas.decode_pallas, the device branch of
tetra_tpu.ops.viterbi.decode_auto: soft [..., >= n_sym*N] -> decoded
bits [..., n_sym], starting from the all-zero state and tracing back from
the lowest-index best end state. Its path is the TCH/S voice decode
(ops.acelp.tch_s_decode -> viterbi.decode_tch: rate 1/3, n_sym 112 and
72). The TPU sends even n_sym to K4's radix-4 body for its matrix unit;
here K4 and K6 are one radix-2 CUDA body (csrc/viterbi_segmented.cu,
launcher tt_viterbi_decode with no restart boundaries), so K6 takes
every n_sym, odd or even.

`decode_k6` is viterbi.decode_auto's one dispatch point: it runs the
plain version (ops.viterbi.decode, float32 metrics) for CPU tensors and
launches the kernel for CUDA tensors, raising if it cannot.
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
    n = len(gens)
    batch = soft.shape[:-1]
    flat = soft.reshape(-1, soft.shape[-1])
    if not (0 < n_sym <= MAX_SYM and 0 < n <= 4) \
            or flat.shape[1] < n_sym * n:
        raise ValueError(f"decode_k6: unsupported n_sym {n_sym}, {n} "
                         f"generators or width {flat.shape[1]}")
    # time-major [n_sym*N, B]: one thread per row then reads a warp's
    # 32 rows from 32 consecutive floats
    soft_tm = flat[:, :n_sym * n].to(torch.float32).t().contiguous()
    kernels.require_cuda(soft_tm, "soft", torch.float32, 2)
    B = flat.shape[0]
    bits = torch.empty((B, n_sym), dtype=torch.int8, device=soft.device)
    rc = kernels.lib().tt_viterbi_decode(
        soft_tm.data_ptr(), patterns_on(gens, soft.device).data_ptr(), n,
        bits.data_ptr(), B, n_sym, kernels.stream_ptr(soft.device))
    kernels.check(rc, "tt_viterbi_decode")
    decode_k6.launches += 1
    return bits.reshape(*batch, n_sym)


decode_k6.launches = 0
