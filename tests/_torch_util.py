"""Shared helpers of the PyTorch-port tests (tests/test_torch_*.py).

The suite runs under pytest-xdist with several workers, and torch
defaults to one thread per core in each: cap it at two.
"""
import numpy as np
import torch

torch.set_num_threads(2)

CPU = torch.device("cpu")


def t(a, dtype=None) -> torch.Tensor:
    """numpy (or jax) array -> CPU tensor."""
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    out = torch.as_tensor(np.ascontiguousarray(a))
    return out if dtype is None else out.to(dtype)


def n(x) -> np.ndarray:
    """tensor or jax array -> numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
