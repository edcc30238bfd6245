"""16-state Viterbi decoding, radix-2 scan (port of tetra_tpu.ops.viterbi
and the segmented scan of tetra_tpu.lmac.fused.decode_segmented).

Reference behaviour: src/lower_mac/viterbi.c + viterbi_cch.c (tables)
with the ACS of libosmocore's osmo_conv_decode. Soft convention: positive
= bit 0, negative = bit 1, 0 = erasure.

This is the plain reference the CUDA kernels of ops.viterbi_assembled
(K1), ops.viterbi_segmented (K4) and ops.viterbi_decode (K6) are held
against: a Python loop over time, vectorised over the batch. Integer soft input (K1's int8 signs)
runs with int32 path metrics; float input (K4's soft amplitudes) runs
with float32 metrics and -1e6 initial metrics, like the JAX scan
(tetra_tpu.lmac.fused.decode_segmented). Tie rules are those of the JAX
scan: a decision takes the upper predecessor only when it is strictly
better (`c1 > c0`), and every argmax takes the lowest-index state.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from tetra_tpu_torch.constants import (CONV_GENERATORS_CCH,
                                       CONV_GENERATORS_TCH)

__all__ = ["trellis_signs", "decode_segmented", "argmax_low", "decode",
           "decode_auto", "decode_cch", "decode_tch", "hard_to_soft"]

_NEG = -(1 << 27)    # excludes invalid paths; metrics stay << 2^31
_NEG_F32 = -1e6      # float metrics: tetra_tpu.lmac.fused._NEG

# predecessor structure of the de Bruijn state graph:
# state s = (d0..d3) with s' = ((s & 7) << 1) | b  (viterbi_cch.c:43-47)
_P0 = np.arange(16, dtype=np.int32) >> 1
_P1 = _P0 | 8
_BIT = np.arange(16, dtype=np.int32) & 1


@functools.lru_cache(maxsize=4)
def trellis_signs(generators) -> np.ndarray:
    """[16, 2, N] correlation signs: +1 where expected output bit is 0.

    Output bit for generator taps from state s with input b:
    g = b xor XOR_d s>>(d-1) (reference tetra_conv_enc.c:43-74).
    """
    n = len(generators)
    signs = np.zeros((16, 2, n), dtype=np.float32)
    for s in range(16):
        for b in (0, 1):
            for gi, taps in enumerate(generators):
                bit = b
                for d in taps:
                    bit ^= (s >> (d - 1)) & 1
                signs[s, b, gi] = 1.0 - 2.0 * bit
    return signs


def argmax_low(metric: torch.Tensor) -> torch.Tensor:
    """Lowest index of the maximum along the last axis."""
    n = metric.shape[-1]
    best = metric.max(dim=-1, keepdim=True).values
    idx = torch.arange(n, device=metric.device, dtype=torch.int64)
    return torch.where(metric == best, idx, n).min(dim=-1).values


def decode_segmented(soft: torch.Tensor, rmask: torch.Tensor, n_sym: int,
                     boundaries: tuple = (),
                     generators=CONV_GENERATORS_CCH) -> torch.Tensor:
    """Segmented decode: soft [B, >= n_sym*N] soft bits (integer dtype:
    int32 metrics; float dtype: float32 metrics), rmask [B,
    len(boundaries)] (nonzero = trellis restart at that boundary) ->
    bits [B, n_sym] int8.

    At a restart step the traceback enters the lowest-index state that
    held the maximum metric just before the restart, and the metrics
    restart from the all-zero state (tetra_tpu.lmac.fused semantics).
    With no boundaries this is tetra_tpu.ops.viterbi.decode.
    """
    gens = tuple(map(tuple, generators))
    n = len(gens)
    dev = soft.device
    B = soft.shape[0]
    mdt = torch.float32 if soft.is_floating_point() else torch.int32
    signs = torch.as_tensor(trellis_signs(gens), dtype=mdt, device=dev)
    p0 = torch.as_tensor(_P0, dtype=torch.int64, device=dev)
    p1 = torch.as_tensor(_P1, dtype=torch.int64, device=dev)
    bvec = torch.as_tensor(_BIT, dtype=torch.int64, device=dev)
    s0 = signs[p0, bvec]                       # [16 new states, N]
    s1 = signs[p1, bvec]
    x = soft[:, :n_sym * n].reshape(B, n_sym, n).to(mdt)
    neg = _NEG_F32 if mdt == torch.float32 else _NEG
    init = torch.full((B, 16), neg, dtype=mdt, device=dev)
    init[:, 0] = 0
    restart = {b: (rmask[:, i] != 0) for i, b in enumerate(boundaries)}
    bstate = {}
    metric = init
    decs = []
    for t in range(n_sym):
        if t in restart:
            bstate[t] = argmax_low(metric)
            metric = torch.where(restart[t][:, None], init, metric)
        xt = x[:, t, None, :]                  # [B, 1, N]
        c0 = metric[:, p0] + (xt * s0).sum(-1, dtype=mdt)
        c1 = metric[:, p1] + (xt * s1).sum(-1, dtype=mdt)
        dec = c1 > c0
        metric = torch.where(dec, c1, c0)
        decs.append(dec)
    state = argmax_low(metric)
    bits = torch.empty((B, n_sym), dtype=torch.int8, device=dev)
    for t in range(n_sym - 1, -1, -1):
        bits[:, t] = (state & 1).to(torch.int8)
        took = decs[t].gather(1, state[:, None])[:, 0].to(torch.int64)
        state = (state >> 1) | (took << 3)
        if t in restart:
            state = torch.where(restart[t], bstate[t], state)
    return bits


def hard_to_soft(bits: torch.Tensor, erasure_marker: int = 255) -> torch.Tensor:
    """Hard/erasure-marked bits -> float32 soft values (viterbi.c:6-25)."""
    b = bits.to(torch.int32)
    return torch.where(b == erasure_marker, 0,
                       torch.where(b == 0, 127, -127)).to(torch.float32)


def decode(soft: torch.Tensor, n_sym: int,
           generators=CONV_GENERATORS_CCH) -> torch.Tensor:
    """Unsegmented decode (tetra_tpu.ops.viterbi.decode): soft mother
    bits [..., >= n_sym*N], cast to float32 -> bits [..., n_sym] int8.
    Starts from the all-zero state and ends in the best state."""
    batch = soft.shape[:-1]
    flat = soft.reshape(-1, soft.shape[-1]).to(torch.float32)
    rmask = torch.zeros((flat.shape[0], 0), dtype=torch.int8,
                        device=soft.device)
    out = decode_segmented(flat, rmask, n_sym, (), generators)
    return out.reshape(*batch, n_sym)


def decode_auto(soft: torch.Tensor, n_sym: int,
                generators=CONV_GENERATORS_CCH) -> torch.Tensor:
    """Device-dispatching decode: K6's wrapper
    (ops.viterbi_decode.decode_k6), the plain scan for CPU tensors and
    the kernel for CUDA tensors."""
    from tetra_tpu_torch.ops.viterbi_decode import decode_k6
    return decode_k6(soft, n_sym, generators)


def decode_cch(soft: torch.Tensor, n_sym: int) -> torch.Tensor:
    """Control-channel code (viterbi_cch.c)."""
    return decode_auto(soft, n_sym, CONV_GENERATORS_CCH)


def decode_tch(soft: torch.Tensor, n_sym: int) -> torch.Tensor:
    """Traffic/speech code (viterbi_tch.c)."""
    return decode_auto(soft, n_sym, CONV_GENERATORS_TCH)
