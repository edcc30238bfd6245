"""Assembly gather + segmented Viterbi + CRC16 in one pass (kernel K1).

Port of tetra_tpu.ops.viterbi_pallas.decode_assembled_pallas. The TPU
kernel spreads descrambled {0, ±1} slot signs into mother-code order
with a one-hot matmul (pmat @ x); every pmat row holds at most one 1,
so the same spread is an index gather: pidx[m] = the source column of
x for mother position m, or -1 for an erasure (`pmat_to_index`).

Several assembly maps can share one call (the three burst kinds of the
fused decode): pidx is [n_tab, n_sym*4] and tab [B] picks each row's
map. `decode_assembled` launches csrc/viterbi_assembled.cu for CUDA
tensors and runs `decode_assembled_plain` for CPU tensors. The kernel
decodes each row with a group of 16 lanes, one per trellis state, after
staging the block's rows of x and the pidx table in shared memory.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tetra_tpu_torch import kernels
from tetra_tpu_torch.ops.crc import crc16_check, crc16_tables
from tetra_tpu_torch.ops.viterbi import decode_segmented
from tetra_tpu_torch.ops.viterbi_segmented import MAX_SYM, boundaries_ok

__all__ = ["AssembledCode", "decode_assembled", "decode_assembled_plain",
           "pmat_to_index"]


def pmat_to_index(pmat: np.ndarray) -> np.ndarray:
    """One-hot spread matrix pmat [n_mother, K] -> int16 index vector
    [n_mother] (source column, -1 where the row is all zero). Raises if
    a row holds more than one nonzero: the gather would then differ
    from the matmul."""
    nz = np.asarray(pmat) != 0
    if (nz.sum(axis=1) > 1).any():
        raise ValueError("pmat row with more than one nonzero entry")
    idx = np.where(nz.any(axis=1), nz.argmax(axis=1), -1)
    return idx.astype(np.int16)


def decode_assembled_plain(x, pidx, tab, rmask, n_sym: int,
                           boundaries: tuple, crc_segs: tuple):
    """Plain PyTorch version of the K1 kernel: gather, radix-2
    segmented scan, CRC16 per segment. Returns (bits [B, n_sym] int8,
    ok [B, n_seg] int8)."""
    B, K = x.shape
    xs = torch.cat([x.to(torch.int8),
                    torch.zeros((B, 1), dtype=torch.int8, device=x.device)],
                   dim=1)
    idx = pidx.to(torch.int64)[tab.to(torch.int64)]
    soft = xs.gather(1, torch.where(idx < 0, K, idx))
    bits = decode_segmented(soft, rmask, n_sym, boundaries)
    ok = torch.stack([crc16_check(bits[:, off:off + ln])
                      for off, ln in crc_segs], dim=1)
    return bits, ok.to(torch.int8)


def decode_assembled(x, pidx, tab, rmask, crcw, crct, n_sym: int,
                     boundaries: tuple, crc_segs: tuple):
    """x [B, K] int8 signs {0, ±1}; pidx [n_tab, n_sym*4] int16; tab [B]
    int32 map row per slot; rmask [B, len(boundaries)] int8 restarts;
    crcw/crct the crc16_tables of (n_sym, crc_segs) -> (bits [B, n_sym]
    int8, ok [B, n_seg] int8).

    CPU tensors run the plain version; CUDA tensors launch the kernel
    (and raise if it cannot launch)."""
    if x.device.type == "cpu":
        return decode_assembled_plain(x, pidx, tab, rmask, n_sym,
                                      boundaries, crc_segs)
    B, K = x.shape
    nb = len(boundaries)
    n_seg = len(crc_segs)
    kernels.require_cuda(x, "x", torch.int8, 2)
    kernels.require_cuda(pidx, "pidx", torch.int16, 2)
    kernels.require_cuda(tab, "tab", torch.int32, 1)
    kernels.require_cuda(rmask, "rmask", torch.int8, 2)
    kernels.require_cuda(crcw, "crcw", torch.int32, 2)
    kernels.require_cuda(crct, "crct", torch.int32, 1)
    if pidx.shape[1] != 4 * n_sym or tab.shape[0] != B \
            or rmask.shape != (B, nb) or crcw.shape != (n_seg, n_sym) \
            or crct.shape[0] != n_seg or not 0 < n_sym <= MAX_SYM \
            or not boundaries_ok(boundaries, n_sym, lowest=0):
        raise ValueError("decode_assembled: inconsistent shapes")
    bnd = list(boundaries) + [-1] * (3 - nb)
    bits = torch.empty((B, n_sym), dtype=torch.int8, device=x.device)
    ok = torch.empty((B, n_seg), dtype=torch.int8, device=x.device)
    rc = kernels.lib().tt_viterbi_assembled(
        x.data_ptr(), K, pidx.data_ptr(), pidx.shape[0], tab.data_ptr(),
        rmask.data_ptr(), nb, bnd[0], bnd[1], bnd[2], crcw.data_ptr(),
        crct.data_ptr(), n_seg, bits.data_ptr(), ok.data_ptr(), B, n_sym,
        kernels.stream_ptr(x.device))
    kernels.check(rc, "tt_viterbi_assembled")
    decode_assembled.launches += 1
    return bits, ok


decode_assembled.launches = 0


class AssembledCode(nn.Module):
    """Constant tables of one assembled decode shape: the assembly maps
    (one per table row), the restart boundaries and the CRC segments."""

    def __init__(self, pmats, n_sym: int, boundaries: tuple,
                 crc_segs: tuple):
        super().__init__()
        self.n_sym = n_sym
        self.boundaries = tuple(boundaries)
        self.crc_segs = tuple(crc_segs)
        pidx = np.stack([pmat_to_index(p) for p in pmats])
        words, target = crc16_tables(n_sym, self.crc_segs)
        self.register_buffer("pidx", torch.tensor(pidx))
        self.register_buffer("crcw", torch.tensor(words))
        self.register_buffer("crct", torch.tensor(target))

    def forward(self, x, tab, rmask):
        return decode_assembled(x, self.pidx, tab, rmask, self.crcw,
                                self.crct, self.n_sym, self.boundaries,
                                self.crc_segs)
