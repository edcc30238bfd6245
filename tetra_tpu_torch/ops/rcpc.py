"""RCPC coding (port of tetra_tpu.ops.rcpc): the mother encoder, the
puncturing index maps, puncture and the soft and hard depuncture.

Reference behaviour: src/lower_mac/tetra_conv_enc.c — a rate-1/4
(data) or rate-1/3 (speech) K=5 mother code plus 7 puncturing schemes
(:196-248). The encoder is feed-forward from the all-zero state, so a
whole batch of blocks encodes as a few XORs of delayed copies.
"""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from tetra_tpu_torch.constants import PUNCT_SCHEMES, CONV_GENERATORS_CCH

__all__ = ["conv_encode", "puncture_indices", "puncture", "depuncture_soft",
           "depuncture_hard"]


def conv_encode(bits: torch.Tensor,
                generators=CONV_GENERATORS_CCH) -> torch.Tensor:
    """Mother-code encode ubits [..., L] -> int8 [..., L*N], output order
    G1..GN per step (tetra_conv_enc.c:43-74): generator output = the
    input XOR its copies delayed by each tap, zero before the block (the
    encoder's all-zero start state)."""
    bits = bits.to(torch.int8)
    outs = []
    for taps in generators:
        g = bits
        for d in taps:
            g = g ^ F.pad(bits, (d, 0))[..., :bits.shape[-1]]
        outs.append(g)
    return torch.stack(outs, dim=-1).reshape(
        *bits.shape[:-1], bits.shape[-1] * len(generators))


@functools.lru_cache(maxsize=32)
def puncture_indices(scheme: str, type3_len: int) -> np.ndarray:
    """k-indices (0-based into the mother sequence) for j = 1..type3_len.

    Implements k = period*((i-1)/t) + P[i - t*((i-1)/t)] with i = i_func(j)
    (reference src/lower_mac/tetra_conv_enc.c:196-248).
    """
    P, t, period, ifunc = PUNCT_SCHEMES[scheme]
    P = np.asarray(P, dtype=np.int64)
    j = np.arange(1, type3_len + 1, dtype=np.int64)
    if ifunc == "eq":
        i = j
    elif ifunc == "292":
        i = j + (j - 1) // 65
    elif ifunc == "148":
        i = j + (j - 1) // 35
    else:
        raise ValueError(ifunc)
    q = (i - 1) // t
    k = period * q + P[i - t * q]
    return (k - 1).astype(np.int32)


@functools.lru_cache(maxsize=32)
def _indices_on(scheme: str, type3_len: int,
                device: torch.device) -> torch.Tensor:
    """puncture_indices as an int64 tensor on `device`, copied once."""
    return torch.as_tensor(puncture_indices(scheme, type3_len),
                           dtype=torch.int64, device=device)


def puncture(scheme: str, mother: torch.Tensor,
             type3_len: int) -> torch.Tensor:
    """Select the type-3 bits of the mother sequence [..., L*N] ->
    [..., type3_len]."""
    return mother[..., _indices_on(scheme, type3_len, mother.device)]


def depuncture_soft(scheme: str, soft_type3: torch.Tensor,
                    mother_len: int) -> torch.Tensor:
    """Scatter soft type-3 values [..., type3_len] into a zero (erasure)
    mother sequence [..., mother_len] of the same dtype (reference
    0xff-erasure + soft-0 semantics, tetra_conv_enc.c:226-248). A short
    input fills the first type3_len puncture positions; the rest stay
    erasures."""
    idx = _indices_on(scheme, soft_type3.shape[-1], soft_type3.device)
    out = torch.zeros(soft_type3.shape[:-1] + (mother_len,),
                      dtype=soft_type3.dtype, device=soft_type3.device)
    out[..., idx] = soft_type3
    return out


def depuncture_hard(scheme: str, type3: torch.Tensor, mother_len: int,
                    erasure: int = 255) -> torch.Tensor:
    """Hard-bit depuncture: type-3 bits [..., type3_len] into an int32
    mother sequence [..., mother_len] holding `erasure` at the punctured
    positions (the reference's 0xff markers)."""
    idx = _indices_on(scheme, type3.shape[-1], type3.device)
    out = torch.full(type3.shape[:-1] + (mother_len,), erasure,
                     dtype=torch.int32, device=type3.device)
    out[..., idx] = type3.to(torch.int32)
    return out
