"""RCPC puncturing index maps and the soft depuncture (port of
tetra_tpu.ops.rcpc).

Reference behaviour: src/lower_mac/tetra_conv_enc.c:196-248. The encode
side (conv_encode, puncture) is TX work and is not ported yet.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from tetra_tpu_torch.constants import PUNCT_SCHEMES

__all__ = ["puncture_indices", "depuncture_soft"]


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
