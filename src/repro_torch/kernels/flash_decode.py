"""Flash-decode: the hand-written CUDA kernel, its wrapper, and its plain
PyTorch version.

Replaces the Pallas TPU kernel ``repro.kernels.flash_decode``. The kernel
(``csrc/flash_decode.cu``) takes one query row per head, q (b, 1, h, d),
against the caches (b, S, kvh, d) read through their strides (a layer's
slice of the stacked cache, not copied), stops at ``kv_len[b]`` read from
device memory, and writes o (b, 1, h, d). One block per (b, kv head) serves
all h/kvh query heads of that kv head.

``flash_decode`` launches the kernel for CUDA tensors (bf16, head dims
16/32/64/128, h/kvh in 1/2/4/8) and raises on anything it does not take;
for CPU tensors it computes ``flash_decode_plain``. ``launches`` counts
kernel launches. Precondition: ``kv_len >= 1``.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import (HEAD_DIMS, check_cuda_bf16,
                                         check_rows)

NEG_INF = -1e30
#: query heads per kv head the kernel is instantiated for
GROUPS = (1, 2, 4, 8)
#: kernel launches made by flash_decode() (the CUDA route only)
launches = 0

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode")
    fn = lib.repro_flash_decode_bf16
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                   _L, _L, _L, _L, _L, _L, _L, _L,
                   ctypes.c_float, _I, _P]
    fn.restype = _I
    return lib


def flash_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor,
                       kv_len: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch. Raises unless every
    ``kv_len >= 1`` (the Pallas kernel and the jnp oracle disagree at 0)."""
    b, _, h, d = q.shape
    S, g = k_cache.shape[1], k_cache.shape[2]
    kv_len = kv_len.reshape(-1)
    if not bool((kv_len >= 1).all()):
        raise ValueError("flash_decode needs kv_len >= 1 for every row")
    qg = q.float().reshape(b, g, h // g, d)
    s = torch.einsum("bgmd,bkgd->bgmk", qg, k_cache.float()) / math.sqrt(d)
    mask = torch.arange(S, device=q.device)[None, :] < kv_len[:, None]
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype).float()
    o = torch.einsum("bgmk,bkgd->bgmd", p, v_cache.float())
    return o.reshape(b, 1, h, d).to(q.dtype)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, kv_len: torch.Tensor) -> torch.Tensor:
    """q (b, 1, h, d); caches (b, S, kvh, d); kv_len (b,) int32 ->
    (b, 1, h, d)."""
    global launches
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, kv_len)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on CUDA or the CPU, not "
                         f"{q.device}")
    check_cuda_bf16(q.device, q=q, k_cache=k_cache, v_cache=v_cache)
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4 \
            or k_cache.shape != v_cache.shape:
        raise ValueError(f"expected q (b, 1, h, d) and caches (b, S, kvh, "
                         f"d); got {tuple(q.shape)}, {tuple(k_cache.shape)},"
                         f" {tuple(v_cache.shape)}")
    b, _, h, d = q.shape
    _, S, g, _ = k_cache.shape
    if k_cache.shape[0] != b or k_cache.shape[3] != d or h % g:
        raise ValueError(f"q {tuple(q.shape)} does not match the caches "
                         f"{tuple(k_cache.shape)}")
    if d not in HEAD_DIMS or h // g not in GROUPS:
        raise ValueError(f"head dim {d} / group {h // g} not in "
                         f"{HEAD_DIMS} / {GROUPS}")
    if kv_len.device != q.device or kv_len.dtype != torch.int32 \
            or kv_len.shape != (b,) or not kv_len.is_contiguous():
        raise ValueError(f"kv_len must be a contiguous ({b},) int32 tensor "
                         f"on {q.device}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        check_rows(name, t)
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device)
    rc = _lib().repro_flash_decode_bf16(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(), b, S, h, g, d,
        q.stride(0), q.stride(2),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        1.0 / math.sqrt(d), q.device.index, stream.cuda_stream)
    if rc:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return out
