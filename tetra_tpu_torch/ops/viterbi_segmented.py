"""Segmented 16-state Viterbi over float soft values (kernel K4).

Port of tetra_tpu.ops.viterbi_pallas.decode_segmented_pallas, the
kernel the soft-decision path runs after its kind-compacted assembly
(tetra_tpu.lmac.fused, soft_input=True): soft f32 [B, n_sym*N] and a
restart mask per row -> decoded bits. The TPU kernel fuses four trellis
steps per iteration (radix 16) and ranks tied candidates so that it
reproduces the radix-2 chain's decisions; the CUDA kernel
(csrc/viterbi_segmented.cu) runs that radix-2 chain directly, a group of
16 lanes (one per state) per row, reading soft row-major as it comes.

`decode_segmented_k4` runs the plain version (ops.viterbi.
decode_segmented, float32 metrics) for CPU tensors and launches the
kernel for CUDA tensors, raising if it cannot.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from tetra_tpu_torch.constants import CONV_GENERATORS_CCH
from tetra_tpu_torch import kernels
from tetra_tpu_torch.ops.viterbi import decode_segmented, trellis_signs

__all__ = ["decode_segmented_k4", "sign_patterns", "patterns_on", "MAX_SYM",
           "boundaries_ok"]

MAX_SYM = 292          # trellis steps K1, K4 and K6 take: TCH/4.8's 292


def boundaries_ok(boundaries, n_sym: int, lowest: int = 1) -> bool:
    """At most three restart boundaries, strictly ascending, inside
    [lowest, n_sym): what the kernels' segment loops take."""
    b = list(boundaries)
    return len(b) <= 3 and b == sorted(set(b)) \
        and all(lowest <= v < n_sym for v in b)


@functools.lru_cache(maxsize=4)
def sign_patterns(generators) -> np.ndarray:
    """int32 [32]: entry 2*p + b has bit n set where generator n's
    output bit is 1 (soft sign -1) on the edge from state p with input
    bit b (trellis_signs, packed for the kernel)."""
    signs = trellis_signs(generators)                  # [16, 2, N]
    bits = (signs < 0).astype(np.int32)
    weights = 1 << np.arange(signs.shape[-1], dtype=np.int32)
    return (bits * weights).sum(-1).reshape(32).astype(np.int32)


@functools.lru_cache(maxsize=8)
def patterns_on(generators, device: torch.device) -> torch.Tensor:
    """sign_patterns(generators) as int32 on `device`, copied once."""
    return torch.as_tensor(sign_patterns(generators), device=device)


def decode_segmented_k4(soft, rmask, n_sym: int, boundaries: tuple = (),
                        generators=CONV_GENERATORS_CCH) -> torch.Tensor:
    """soft [B, >= n_sym*N] float32 soft bits (positive = bit 0);
    rmask [B, len(boundaries)] (nonzero = trellis restart there) ->
    bits [B, n_sym] int8.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (n_sym <= MAX_SYM, at most 3 boundaries, N <= 4 generators)."""
    gens = tuple(map(tuple, generators))
    if soft.device.type == "cpu":
        return decode_segmented(soft.to(torch.float32), rmask, n_sym,
                                boundaries, gens)
    B = soft.shape[0]
    n = len(gens)
    nb = len(boundaries)
    kernels.require_cuda(soft, "soft", torch.float32, 2)
    kernels.require_cuda(rmask, "rmask", torch.int8, 2)
    if not (0 < n_sym <= MAX_SYM and 0 < n <= 4) \
            or soft.shape[1] < n_sym * n or rmask.shape != (B, nb) \
            or not boundaries_ok(boundaries, n_sym):
        raise ValueError("decode_segmented_k4: unsupported shape or "
                         "boundaries")
    pat = patterns_on(gens, soft.device)
    bnd = list(boundaries) + [-1] * (3 - nb)
    bits = torch.empty((B, n_sym), dtype=torch.int8, device=soft.device)
    rc = kernels.lib().tt_viterbi_segmented(
        soft.data_ptr(), soft.shape[1], pat.data_ptr(), n, rmask.data_ptr(),
        nb, bnd[0], bnd[1], bnd[2], bits.data_ptr(), B, n_sym,
        kernels.stream_ptr(soft.device))
    kernels.check(rc, "tt_viterbi_segmented")
    decode_segmented_k4.launches += 1
    return bits


decode_segmented_k4.launches = 0
