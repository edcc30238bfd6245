"""ACELP speech-frame bit reordering and the TCH/S FEC chain (port of
tetra_tpu.ops.acelp), EN 300 395-2.

Reference behaviour: src/lower_mac/tch_reordering.c (class-0/1/2 bit
position tables, Table 4). The reference's class-0 table declares 51
entries but initialises only 50; the phantom 51st pair is dropped, as in
the JAX package.

`tch_s_decode` depunctures the two protected classes of a 432-bit
type-3 frame into soft mother sequences (+-127, erasures 0) and decodes
each with the rate-1/3 speech code through viterbi.decode_tch: the plain
scan for CPU tensors, kernel K6 for CUDA tensors. `tch_s_encode` and
`codec_to_type2` are the transmit side.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from tetra_tpu_torch import constants as C
from tetra_tpu_torch.ops import rcpc, viterbi

__all__ = ["type2_to_codec", "codec_to_type2", "tch_s_decode",
           "tch_s_encode"]

_NUM_C0 = 51   # reference NUM_ACELP_CLASS0_BITS (incl. the phantom entry)
_NUM_C1 = 56
_NUM_C2 = 30
_FRAME_BITS = _NUM_C0 + _NUM_C1 + _NUM_C2  # 137

# TCH/S full-rate FEC blocks (tetra_conv_enc.c:253-263): class 1, 112
# type-2 bits -> 168 punctured; class 2, 72 -> 162
_C1_T2, _C1_T3 = 112, 168
_C2_T2, _C2_T3 = 72, 162


@functools.lru_cache(maxsize=1)
def _maps() -> np.ndarray:
    """Gather table codec index -> line index [2*137] (-1: unmapped)."""
    positions = np.concatenate([
        C.ACELP_CLASS0, np.array([-1], dtype=np.int32),  # phantom pair
        C.ACELP_CLASS1, C.ACELP_CLASS2,
    ])
    # input pair k with table position p -> for frame f:
    # codec[f*137 + p - 1] = in[2*k + f]
    fwd = np.full(2 * _FRAME_BITS, -1, dtype=np.int32)
    for k, p in enumerate(positions):
        if p < 1:
            continue
        for f in (0, 1):
            fwd[f * _FRAME_BITS + (p - 1)] = 2 * k + f
    return fwd


@functools.lru_cache(maxsize=4)
def _maps_on(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(gather index, mask) of _maps on `device`, copied once."""
    fwd = _maps()
    src = torch.as_tensor(np.where(fwd < 0, 0, fwd), dtype=torch.int64,
                          device=device)
    mask = torch.as_tensor((fwd >= 0).astype(np.int8), device=device)
    return src, mask


def type2_to_codec(bits: torch.Tensor) -> torch.Tensor:
    """[..., 274] decoded speech bits -> [..., 274] codec-ordered bits
    (two 137-bit ACELP frames). Unmapped positions (the phantom class-0
    slot) are zero."""
    src, mask = _maps_on(bits.device)
    return bits[..., src] * mask.to(bits.dtype)


@functools.lru_cache(maxsize=4)
def _inverse_on(device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    """(gather index, mask) of the inverse of _maps on `device`."""
    fwd = _maps()
    inv = np.full(2 * _FRAME_BITS, -1, dtype=np.int32)
    for codec_idx, in_idx in enumerate(fwd):
        if in_idx >= 0:
            inv[in_idx] = codec_idx
    src = torch.as_tensor(np.where(inv < 0, 0, inv), dtype=torch.int64,
                          device=device)
    mask = torch.as_tensor((inv >= 0).astype(np.int8), device=device)
    return src, mask


def codec_to_type2(bits: torch.Tensor) -> torch.Tensor:
    """Inverse reordering: [..., 274] codec bits -> [..., 274] line bits
    (the phantom pair's positions zero)."""
    src, mask = _inverse_on(bits.device)
    return bits[..., src] * mask.to(bits.dtype)


def tch_s_encode(class0: torch.Tensor, class1: torch.Tensor,
                 class2: torch.Tensor) -> torch.Tensor:
    """Speech classes -> 432-bit type-3 frames int8 (batched):
    [class0 (102) | punct(class1 + 4 tail, 112/168) | punct(class2 + 8
    zero bits, 72/162)] with the rate-1/3 speech code
    (tetra_conv_enc.c:253-263)."""
    def t2(x, n):
        return torch.cat([x.to(torch.int8), torch.zeros(
            x.shape[:-1] + (n,), dtype=torch.int8, device=x.device)], dim=-1)

    m1 = rcpc.conv_encode(t2(class1, 4), C.CONV_GENERATORS_TCH)
    m2 = rcpc.conv_encode(t2(class2, 8), C.CONV_GENERATORS_TCH)
    return torch.cat([class0.to(torch.int8),
                      rcpc.puncture("112_168", m1, _C1_T3),
                      rcpc.puncture("72_162", m2, _C2_T3)], dim=-1)


def tch_s_decode(type3: torch.Tensor):
    """Decode TCH/S type-3 frames [n, 432] of 0/1 into speech classes.

    Returns (class0 [n, 102], class1 [n, 108] int8, class2 [n, 64] int8,
    ok1, ok2), ok* True where the zero tails decoded as zeros. A shorter
    row (an NDB-stolen slot's 216-bit second half) keeps its length
    semantics: class 1 gets the punctured values present, the rest of
    its mother sequence and all of class 2 stay erasures."""
    c0 = type3[..., :102]
    p1 = type3[..., 102:102 + _C1_T3]
    p2 = type3[..., 102 + _C1_T3:102 + _C1_T3 + _C2_T3]
    s1 = rcpc.depuncture_soft("112_168",
                              (1.0 - 2.0 * p1.to(torch.float32)) * 127.0,
                              _C1_T2 * 3)
    s2 = rcpc.depuncture_soft("72_162",
                              (1.0 - 2.0 * p2.to(torch.float32)) * 127.0,
                              _C2_T2 * 3)
    d1 = viterbi.decode_tch(s1, _C1_T2)
    d2 = viterbi.decode_tch(s2, _C2_T2)
    ok1 = (d1[..., -4:] == 0).all(dim=-1)
    ok2 = (d2[..., -8:] == 0).all(dim=-1)
    return c0, d1[..., :108], d2[..., :64], ok1, ok2
