"""The traffic egress worked out again: the dump block of a traffic
slot's type-4 bits and the TCH/S voice frame decoded from them
(osmo-tetra src/lower_mac/tetra_lower_mac.c:198-241 for the dump,
tetra_conv_enc.c:253-263 for the speech code, tch_reordering.c for the
codec order; EN 300 395-2 Table 4).

Plain NumPy and PyTorch, integers throughout. Each step follows the
port's definition (`rx.dump_blocks`, `rx.voice_frames`,
`ops/acelp.tch_s_decode`, `type2_to_codec`), written anew:

- `dump_blocks`: 690 int16 words, the six sync markers 0x6B21 + i every
  115 words, the type-4 bits as -127 (bit 1) / +127 (bit 0) in four
  spans. A 216-bit row (an NDB slot's second half) fills the positions
  it has and leaves 0 elsewhere, as the port does (osmo-tetra has no
  such row: it dumps a whole slot only).
- `tch_s_type2`: class 0 is the first 102 type-4 bits as they are;
  class 1 (168 bits from 112 type-2) and class 2 (162 from 72) are
  depunctured into a zero (erasure) mother sequence of the rate-1/3
  speech code as +-127 and decoded by a 16-state Viterbi. A 216-bit row
  fills the first 114 puncture positions of class 1 and none of class
  2, as `rcpc.depuncture_soft` does with a short input. Departure: the
  path metrics are int32 from -(1 << 27) where the port's are float32
  from -1e6; every value is an integer below 2^24 in both, so the
  comparisons, and with them the decisions and ties, are the same.
- `codec_order`: the 274 line bits (102 class 0, 108 class 1, 64
  class 2) gathered into two 137-bit ACELP frames by the class tables;
  the reference's class-0 table declares 51 entries and initialises 50,
  so the 51st pair is dropped and its two codec positions read 0.
- `cod_frames`: the codec bits XOR the 274-bit voice keystream (zeros
  for a clear slot), packed MSB first into 35 bytes.
- `TXT_LINE`: the line appended to a slot's `.txt` file. The port's
  native control plane writes "0" (it does not carry the SSI out of its
  walk); osmo-tetra and the port's Python plane write the SSI of the
  last MAC-RESOURCE. The reference follows the native plane, which is
  the one the benchmark drives.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from portbench.reference import constants as C

OUT_WORDS = 690
OUT_BYTES = 2 * OUT_WORDS
COD_BYTES = 35
TXT_LINE = b"0\n"
# (block word, type-4 bit, count) of the four spans
DUMP_SPANS = ((1, 0, 114), (116, 114, 114), (231, 228, 114), (346, 342, 90))

# TCH/S: class 0 unprotected, class 1 112 type-2 bits -> 168, class 2
# 72 -> 162 (tetra_conv_enc.c:253-263)
C0_BITS, C1_T2, C1_T3, C2_T2, C2_T3 = 102, 112, 168, 72, 162
FRAME_BITS = 137

# ACELP bit classes, EN 300 395-2 Table 4 (tch_reordering.c:30-92):
# codec positions (1-based) of each line pair
ACELP_CLASS0 = (
    35, 36, 37, 38, 39, 40, 41, 42, 33, 47, 48, 56, 61, 62, 63, 65, 66, 67,
    68, 69, 70, 74, 75, 83, 88, 89, 90, 91, 92, 93, 94, 95, 96, 97, 101, 102,
    110, 115, 116, 117, 118, 119, 120, 121, 122, 123, 124, 128, 129, 137)
ACELP_CLASS1 = (
    58, 85, 112, 54, 81, 108, 135, 50, 77, 104, 131, 45, 72, 99, 126, 55, 82,
    109, 136, 5, 13, 34, 8, 16, 17, 22, 23, 24, 25, 26, 6, 14, 7, 15, 60, 87,
    114, 46, 73, 100, 127, 44, 71, 98, 125, 33, 49, 76, 103, 130, 59, 86,
    113, 57, 84, 111)
ACELP_CLASS2 = (
    18, 19, 20, 21, 31, 32, 53, 80, 107, 134, 1, 2, 3, 4, 9, 10, 11, 12, 27,
    28, 29, 30, 52, 79, 106, 133, 51, 78, 105, 132)


def dump_blocks(type4: np.ndarray) -> np.ndarray:
    """Type-4 bits [n, L] (L 432, or 216 for an NDB half) -> the dump
    blocks [n, 690] int16."""
    n, width = type4.shape
    out = np.zeros((n, OUT_WORDS), np.int16)
    for i in range(6):
        out[:, 115 * i] = 0x6B21 + i
    for dst, src, count in DUMP_SPANS:
        count = max(0, min(count, width - src))
        bits = type4[:, src:src + count]
        out[:, dst:dst + count] = np.where(bits != 0, -127, 127)
    return out


@functools.lru_cache(maxsize=4)
def _puncture(scheme: str, n3: int) -> np.ndarray:
    """Mother-sequence positions (0-based) of the first n3 type-3 bits."""
    P, t, period, _ = C.PUNCT_SCHEMES[scheme]
    out = []
    for j in range(1, n3 + 1):
        q = (j - 1) // t
        out.append(period * q + P[j - t * q] - 1)
    return np.asarray(out, np.int64)


def depuncture(scheme: str, bits: torch.Tensor, mother_len: int
               ) -> torch.Tensor:
    """Type-3 bits [n, m] (m up to the scheme's length) -> int32 mother
    values [n, mother_len]: +127 for bit 0, -127 for bit 1, 0 erased."""
    out = torch.zeros((bits.shape[0], mother_len), dtype=torch.int32,
                      device=bits.device)
    idx = torch.as_tensor(_puncture(scheme, bits.shape[1]),
                          device=bits.device)
    out[:, idx] = 127 * (1 - 2 * bits.to(torch.int32))
    return out


@functools.lru_cache(maxsize=1)
def _trellis():
    """(prev0, prev1, signs0 [16, 3], signs1 [16, 3]) of the speech
    code: new state s = ((prev & 7) << 1) | b, each generator's output
    b XOR the prev bits its taps name, +1 for an output 0."""
    p0 = [s >> 1 for s in range(16)]
    p1 = [(s >> 1) | 8 for s in range(16)]

    def signs(prev):
        out = np.zeros((16, 3), np.int32)
        for s in range(16):
            for g, taps in enumerate(C.CONV_GENERATORS_TCH):
                bit = s & 1
                for d in taps:
                    bit ^= (prev[s] >> (d - 1)) & 1
                out[s, g] = 1 - 2 * bit
        return out
    return (np.asarray(p0), np.asarray(p1), signs(p0), signs(p1))


def viterbi_tch(mother: torch.Tensor, n_sym: int) -> torch.Tensor:
    """Mother values [n, 3 n_sym] int32 -> bits [n, n_sym] int8: start
    in state 0; a decision takes the upper predecessor only when it is
    strictly better; the traceback starts at the lowest-index best
    state."""
    dev = mother.device
    n = mother.shape[0]
    p0, p1, s0, s1 = (torch.as_tensor(a, device=dev) for a in _trellis())
    x = mother.reshape(n, n_sym, 3)
    metric = torch.full((n, 16), -(1 << 27), dtype=torch.int32, device=dev)
    metric[:, 0] = 0
    decs = []
    for t in range(n_sym):
        xt = x[:, t, None, :]
        c0 = metric[:, p0] + (xt * s0).sum(-1, dtype=torch.int32)
        c1 = metric[:, p1] + (xt * s1).sum(-1, dtype=torch.int32)
        d = c1 > c0
        metric = torch.where(d, c1, c0)
        decs.append(d)
    best = metric.max(dim=1, keepdim=True).values
    state = torch.where(metric == best, torch.arange(16, device=dev),
                        16).min(dim=1).values
    bits = torch.empty((n, n_sym), dtype=torch.int8, device=dev)
    for t in range(n_sym - 1, -1, -1):
        bits[:, t] = (state & 1).to(torch.int8)
        took = decs[t].gather(1, state[:, None])[:, 0].to(torch.int64)
        state = (state >> 1) | (took << 3)
    return bits


def tch_s_type2(type4: torch.Tensor) -> torch.Tensor:
    """Type-4 bits [n, L] (L 432 or 216) of TCH/S slots -> the 274 line
    bits [n, 274] int8: class 0 (102) | class 1 (108) | class 2 (64)."""
    p1 = type4[:, C0_BITS:C0_BITS + C1_T3]
    p2 = type4[:, C0_BITS + C1_T3:C0_BITS + C1_T3 + C2_T3]
    d1 = viterbi_tch(depuncture("112_168", p1, 3 * C1_T2), C1_T2)
    d2 = viterbi_tch(depuncture("72_162", p2, 3 * C2_T2), C2_T2)
    return torch.cat([type4[:, :C0_BITS].to(torch.int8), d1[:, :C1_T2 - 4],
                      d2[:, :C2_T2 - 8]], dim=1)


@functools.lru_cache(maxsize=1)
def _codec_source() -> np.ndarray:
    """Line index of each of the 274 codec positions, -1 where none: line
    pair k, at table position p, gives codec[f 137 + p - 1] = line[2 k
    + f] for frames f 0 and 1; pair 50 is the undeclared 51st of class
    0."""
    positions = list(ACELP_CLASS0) + [0] + list(ACELP_CLASS1) \
        + list(ACELP_CLASS2)
    src = np.full(2 * FRAME_BITS, -1, np.int64)
    for k, p in enumerate(positions):
        if p >= 1:
            for f in (0, 1):
                src[f * FRAME_BITS + p - 1] = 2 * k + f
    return src


def codec_order(line: np.ndarray) -> np.ndarray:
    """Line bits [n, 274] -> codec bits [n, 274] (two ACELP frames)."""
    src = _codec_source()
    out = np.zeros(line.shape, np.uint8)
    have = src >= 0
    out[:, have] = line[:, src[have]]
    return out


def cod_frames(type4: torch.Tensor, keystream: np.ndarray) -> np.ndarray:
    """Type-4 rows [n, L] of one width and their voice keystreams [n,
    274] (zeros for a clear slot) -> the .cod bytes [n, 35]."""
    line = tch_s_type2(type4).cpu().numpy().astype(np.uint8)
    return np.packbits(codec_order(line) ^ keystream.astype(np.uint8),
                       axis=1)
