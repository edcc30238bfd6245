"""Collectives of the port's meshes, staged through host memory.

The ranks of a mesh are processes that may all drive the same card: the
machine the port runs on has one H100, so every rank computes on cuda:0
in its own CUDA context. NCCL refuses two ranks on one GPU ("Duplicate
GPU detected"), and gloo sends, gathers and reduces CPU tensors only.
So every mesh runs gloo, and this module is the one place where a
payload crosses between ranks: it copies the device tensor to the host,
runs the gloo collective on the copy and copies the result back to the
tensor's device. The payloads are small (halos of ~58 samples per
carrier, the [C, sps] timing scores, scalar CRC counts, one bundle
segment per chunk), and no computation moves: the kernels and the
arithmetic stay on the card.

`group` is a process group, as DeviceMesh.get_group(dim) returns it.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

__all__ = ["all_reduce_sum", "all_gather", "all_gather_host", "ring_shift"]


def _host(x: torch.Tensor) -> torch.Tensor:
    return x.detach().to("cpu", copy=True).contiguous()


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of x over the group's ranks (jax.lax.psum), on x's
    device. For an integer count, where the order of the sum does not
    matter."""
    h = _host(x)
    dist.all_reduce(h, op=dist.ReduceOp.SUM, group=group)
    return h.to(x.device)


def all_gather(x: torch.Tensor, group) -> list[torch.Tensor]:
    """Every rank's x (same shape and type on every rank), in the
    group's rank order, on x's device."""
    h = _host(x)
    out = [torch.empty_like(h) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, h, group=group)
    return [o.to(x.device) for o in out]


def all_gather_host(a: np.ndarray, group) -> list[np.ndarray]:
    """all_gather of a host array: every rank's `a`, in rank order."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    return [o.numpy() for o in out]


def ring_shift(x: torch.Tensor, group, shift: int) -> torch.Tensor:
    """jax.lax.ppermute around the group's ring: rank i sends x to rank
    (i + shift) % n and returns what rank (i - shift) % n sent (x's
    shape and type on every rank), on x's device."""
    n = dist.get_world_size(group)
    if n == 1:
        return x.clone()
    i = dist.get_rank(group)
    h = _host(x)
    got = torch.empty_like(h)
    ops = [dist.P2POp(dist.isend, h,
                      dist.get_global_rank(group, (i + shift) % n), group),
           dist.P2POp(dist.irecv, got,
                      dist.get_global_rank(group, (i - shift) % n), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return got.to(x.device)
