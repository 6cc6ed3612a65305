"""Flash-attention forward: the hand-written CUDA kernel, its wrapper, and
its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro.kernels.flash_attention``. The
kernel (``csrc/flash_attention.cu``) reads the model layout q (b, sq, h, d),
k/v (b, skv, kvh, d) through strides and writes o (b, sq, h, d); query head
``i`` reads kv head ``i // (h / kvh)``; the causal mask is
``q_offset + row >= col`` as in ``chunked_attention``.

``flash_attention`` launches the kernel for CUDA tensors (bf16, head dims
16/32/64/96/128) and raises on anything it does not take, or on an input
that requires grad while grad is enabled (the kernel has no backward); for
CPU tensors it computes ``flash_attention_plain``. With ``return_lse`` both
also return each query row's log-sum-exp L = max(s) + ln(sum e^(s - max))
of the scaled scores s = q.k / sqrt(d), fp32 (b, h, sq): what the training
backward (``models.attention.FlashAttentionFn``) reads. ``launches`` counts
kernel launches. On the meta device under abstract evaluation (the dry
run's ``kernels.cost.recording``) it launches nothing: it returns empty
outputs of the kernel's shapes and dtypes and charges the kernel's work.
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import Tuple

import torch

from repro_torch.kernels import _build, cost
from repro_torch.kernels._checks import (HEAD_DIMS, check_attention_sizes,
                                         check_cuda_bf16, check_no_grad,
                                         check_rows)

NEG_INF = -1e30
#: kernel launches made by flash_attention() (the CUDA route only)
launches = 0
_launches_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.repro_flash_attention_bf16
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   _L, _L, _L, _L, _L, _L, _L, _L, _L,
                   _I, _I, ctypes.c_float, _I, _P]
    fn.restype = _I
    occ = lib.repro_flash_attention_occupancy
    occ.argtypes = [_I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    occ.restype = _I
    return lib


def occupancy(d: int, device: torch.device) -> Tuple[int, int]:
    """(resident blocks per SM, dynamic shared memory bytes per block) of
    the kernel for head dim ``d`` on a CUDA ``device``."""
    blocks, smem = _I(), _I()
    rc = _lib().repro_flash_attention_occupancy(
        d, device.index or 0, ctypes.byref(blocks), ctypes.byref(smem))
    if rc:
        raise RuntimeError(f"flash_attention occupancy query failed: CUDA "
                           f"error {rc}")
    return blocks.value, smem.value


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, q_offset: int = 0,
                          return_lse: bool = False):
    """The same function in plain PyTorch: fp32 scores, softmax, P cast to
    v's dtype, fp32 P V, output in q's dtype; with ``return_lse`` also the
    fp32 (b, h, sq) row log-sum-exp of the scaled scores."""
    b, sq, h, d = q.shape
    skv, g = k.shape[1], k.shape[2]
    qg = q.float().reshape(b, sq, g, h // g, d)
    s = torch.einsum("bqgmd,bkgd->bgmqk", qg, k.float()) / math.sqrt(d)
    if causal:
        rows = q_offset + torch.arange(sq, device=q.device)
        cols = torch.arange(skv, device=q.device)
        s = s.masked_fill(rows[:, None] < cols[None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    o = torch.einsum("bgmqk,bkgd->bqgmd", p, v.float())
    o = o.reshape(b, sq, h, d).to(q.dtype)
    if not return_lse:
        return o
    return o, torch.logsumexp(s, dim=-1).reshape(b, h, sq)


def _abstract(q, k, v, causal: bool, q_offset: int, return_lse: bool):
    """The kernel's outputs on the meta device, its work charged."""
    b, sq, h, d = q.shape
    _, skv, g, _ = k.shape
    cost.charge("flash_attention",
                cost.attention_flops(b, sq, skv, h, d, causal, q_offset),
                cost.attention_bytes(b, sq, skv, h, g, d, return_lse))
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if not return_lse:
        return out
    return out, torch.empty((b, h, sq), dtype=torch.float32,
                            device=q.device)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, q_offset: int = 0,
                    return_lse: bool = False):
    """q (b, sq, h, d); k, v (b, skv, kvh, d) -> o (b, sq, h, d), and with
    ``return_lse`` (o, L (b, h, sq) fp32)."""
    global launches
    if q.device.type == "meta" and cost.evaluating():
        check_no_grad("flash_attention", q=q, k=k, v=v)
        return _abstract(q, k, v, causal, q_offset, return_lse)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal,
                                     q_offset=q_offset, return_lse=return_lse)
    check_no_grad("flash_attention", q=q, k=k, v=v)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or the CPU, not "
                         f"{q.device}")
    check_cuda_bf16(q.device, q=q, k=k, v=v)
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (b, sq, h, d) and k, v (b, skv, kvh, "
                         f"d); got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, sq, h, d = q.shape
    _, skv, g, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or h % g:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    check_attention_sizes(b, sq, skv, h, q_offset)
    for name, t in (("q", q), ("k", k), ("v", v)):
        check_rows(name, t)
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device) \
        if return_lse else None
    stream = torch.cuda.current_stream(q.device)
    rc = _lib().repro_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(),
        b, sq, skv, h, g, d,
        q.stride(0), q.stride(1), q.stride(2),
        k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2),
        q_offset, int(causal), 1.0 / math.sqrt(d),
        q.device.index, stream.cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {rc}")
    with _launches_lock:        # exact under concurrent callers
        launches += 1
    return out if lse is None else (out, lse)
