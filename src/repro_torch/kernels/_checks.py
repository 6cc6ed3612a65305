"""Argument checks shared by the CUDA kernels' wrappers."""
from __future__ import annotations

import torch

#: head dims the kernels are instantiated for
HEAD_DIMS = (16, 32, 64, 96, 128)
#: the fewest query rows a flash-attention block takes (D = 128)
MIN_Q_TILE = 64


def check_attention_sizes(b: int, sq: int, skv: int, h: int,
                          q_offset: int) -> None:
    """Sizes flash-attention's grid takes: b*h blocks along x (CUDA's
    limit 2^31 - 1) and ceil(sq / q tile) along y (limit 65535), at least
    one query and one key, and a causal offset that is not negative."""
    if sq < 1 or skv < 1 or q_offset < 0 or b * h >= 2 ** 31 \
            or -(-sq // MIN_Q_TILE) > 65535:
        raise ValueError(f"unsupported sizes: sq={sq} skv={skv} "
                         f"q_offset={q_offset} b*h={b * h}")


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


def check_no_grad(kernel: str, **tensors: torch.Tensor) -> None:
    """A kernel's output has no ``grad_fn``: called with grad enabled on an
    input that requires grad, it would cut the graph and drop the inputs'
    gradients without a word, so it raises instead. The training path
    calls flash-attention from ``FlashAttentionFn``, whose forward runs
    with grad disabled and whose backward is written out."""
    if not torch.is_grad_enabled():
        return
    needing = [name for name, t in tensors.items()
               if t is not None and t.requires_grad]
    if needing:
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward, but "
            f"{', '.join(needing)} require grad; call it under "
            f"torch.no_grad(), or train through "
            f"repro_torch.models.attention.FlashAttentionFn")
