"""Argument checks shared by the CUDA kernels' wrappers."""
from __future__ import annotations

import torch

#: head dims the kernels are instantiated for
HEAD_DIMS = (16, 32, 64, 128)


def check_rows(name: str, t: torch.Tensor) -> None:
    """The kernels read 16-byte pieces of each row of the head dim: it must
    be contiguous, the other strides multiples of 8 elements, and the start
    16-byte aligned."""
    if t.stride(-1) != 1 or any(s % 8 for s in t.stride()[:-1]) \
            or t.data_ptr() % 16:
        raise ValueError(
            f"{name}: needs a contiguous head dim, other strides that are "
            f"multiples of 8 and a 16-byte aligned start; got strides "
            f"{tuple(t.stride())}")


def check_cuda_bf16(device: torch.device, **tensors: torch.Tensor) -> None:
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got "
                            f"{t.dtype}")
