"""Device selection for the port.

One explicit `torch.device` is resolved here and passed down to every
function. Resolving also pins float32 matmuls and convolutions to full
float32: the demod's matched filter is a convolution whose outputs feed
sign decisions, and TF32 (cuDNN's default for convolutions) keeps only
about three decimal digits.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """`device` (None, a string or a torch.device) -> torch.device.

    None means CUDA: the port's entry points run on the card unless the
    caller asks for the CPU. A request for CUDA never falls back to the
    CPU: it raises when no card is available."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA device requested but torch.cuda is "
                           "not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev
