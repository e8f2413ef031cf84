"""The port's arithmetic precision on the card: float32 throughout.

PyTorch's default lets cuDNN run float32 convolutions in TF32 (10-bit
mantissa); its default for float32 matmuls is full float32 already. The
port's modules that convolve therefore pin cuDNN to float32 themselves,
scoped, with ``float32_convs`` (a context manager and a decorator), instead
of relying on the caller's global flags. Whether TF32 or bfloat16 is good
enough for a module is a later, measured choice.
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def float32_convs():
    """cuDNN convolutions (forward, and backward when it runs inside) in
    float32 for the duration; the caller's setting is restored on exit."""
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = old
