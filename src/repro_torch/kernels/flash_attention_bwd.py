"""Flash-attention backward: the hand-written CUDA kernels, their wrapper,
and their plain PyTorch version.

Replaces no TPU kernel: the JAX package's training backward
(``repro.models.attention._flash_bwd_rule``) is plain JAX, and the port ran
it as plain PyTorch in fp32 (``models.attention._flash_bwd``), which the
CPU still does. The kernels (``csrc/flash_attention_bwd.cu``) read what the
forward saved in the model layout through strides: q, do, o (b, sq, h, d),
k, v (b, skv, kvh, d), the row log-sum-exp L fp32 (b, h, sq); they write
dq (b, sq, h, d) and dk, dv (b, skv, kvh, d) in the inputs' dtype. Query
head ``i`` reads kv head ``i // (h / kvh)``, whose dk and dv sum over its
group; the causal mask is ``row >= col``.

``flash_attention_bwd`` launches them for CUDA tensors (bf16, the head dims
of ``_checks.HEAD_DIMS``; 16 and 32 padded to 64) and raises on anything
they do not take; for CPU tensors it computes ``flash_attention_bwd_plain``,
which repeats their arithmetic. ``launches`` counts kernel launches: two a
call (the dq kernel, then the dk/dv kernel).
"""
from __future__ import annotations

import ctypes
import math
import threading
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, launch_count
from repro_torch.kernels._checks import (HEAD_DIMS, check_attention_sizes,
                                         check_rows)

#: rows of every tile the kernels walk
TILE = 64
#: kernel launches made by flash_attention_bwd() (the CUDA route only),
#: counted through ``launch_count``, which keeps them exact under CUDA
#: graphs; two a call
launches = 0
_launches_lock = threading.Lock()

_P, _I = ctypes.c_void_p, ctypes.c_int
_S = ctypes.c_longlong * 3


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    fn = lib.repro_flash_attention_bwd_bf16
    fn.argtypes = [_P] * 10 + [_I] * 6 + [_S] * 5 + [_I, ctypes.c_float,
                                                     _I, _P]
    fn.restype = _I
    occ = lib.repro_flash_attention_bwd_occupancy
    occ.argtypes = [_I, _I] + [ctypes.POINTER(_I)] * 5
    occ.restype = _I
    return lib


class Occupancy(NamedTuple):
    """The shape the kernels take at one head dim on one card."""
    dq_blocks: int      # resident blocks per SM of the dq kernel
    dkdv_blocks: int    # ... of the dk/dv kernel
    dq_smem: int        # dynamic shared memory per block, bytes
    dkdv_smem: int
    stages: int         # walked tiles in each kernel's ring


def occupancy(d: int, device: torch.device) -> Occupancy:
    """The shape and resident blocks per SM of the kernels at head dim
    ``d`` (64, 96 or 128; 16 and 32 run as 64) on a CUDA ``device``."""
    out = [_I() for _ in range(5)]
    rc = _lib().repro_flash_attention_bwd_occupancy(
        d, device.index or 0, *(ctypes.byref(x) for x in out))
    if rc:
        raise RuntimeError(f"flash_attention_bwd occupancy query failed: "
                           f"CUDA error {rc}")
    return Occupancy(*(x.value for x in out))


def flash_attention_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                              v: torch.Tensor, o: torch.Tensor,
                              lse: torch.Tensor, do: torch.Tensor, *,
                              causal: bool = True) \
        -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch, with the kernels' arithmetic:
    fp32 scores, P = exp(s - L) fp32, delta = rowsum(do * o) fp32, P and
    dS = P (dP - delta) cast to the inputs' dtype before their products,
    fp32 products, the scale applied to dq and dk at the end; (dq, dk, dv)
    in the inputs' dtype."""
    b, sq, h, d = q.shape
    skv, g = k.shape[1], k.shape[2]
    dt = q.dtype
    scale = 1.0 / math.sqrt(d)
    qf = q.float().reshape(b, sq, g, h // g, d)
    dof = do.float().reshape(b, sq, g, h // g, d)
    kf, vf = k.float(), v.float()
    s = torch.einsum("bqgmd,bkgd->bgmqk", qf, kf) * scale
    p = torch.exp(s - lse.float().reshape(b, g, h // g, sq)[..., None])
    if causal:
        rows = torch.arange(sq, device=q.device)
        cols = torch.arange(skv, device=q.device)
        p = p.masked_fill(rows[:, None] < cols[None, :], 0.0)
    delta = (dof * o.float().reshape(b, sq, g, h // g, d)).sum(-1)
    delta = delta.permute(0, 2, 3, 1)                    # (b, g, m, sq)
    dv = torch.einsum("bgmqk,bqgmd->bkgd", p.to(dt).float(), dof)
    dp = torch.einsum("bqgmd,bkgd->bgmqk", dof, vf)
    ds = (p * (dp - delta[..., None])).to(dt).float()
    dq = torch.einsum("bgmqk,bkgd->bqgmd", ds, kf) * scale
    dk = torch.einsum("bgmqk,bqgmd->bkgd", ds, qf) * scale
    return dq.reshape(b, sq, h, d).to(dt), dk.to(dt), dv.to(dt)


def _check(q, k, v, o, lse, do) -> None:
    """What the kernels take, on any device: bf16 operands of one device
    with matching shapes, a head dim of ``HEAD_DIMS``, fp32 L (b, h, sq)
    contiguous, rows the copies can read, and sizes the grids hold."""
    for name, t in (("k", k), ("v", v), ("o", o), ("lse", lse),
                    ("do", do)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected "
                             f"{q.device}")
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got "
                            f"{t.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or o.shape != q.shape or do.shape != q.shape:
        raise ValueError(f"expected q, o, do (b, sq, h, d) and k, v (b, "
                         f"skv, kvh, d); got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, o "
                         f"{tuple(o.shape)}, do {tuple(do.shape)}")
    b, sq, h, d = q.shape
    _, skv, g, _ = k.shape
    if k.shape[0] != b or k.shape[3] != d or h % g:
        raise ValueError(f"q {tuple(q.shape)} does not match k/v "
                         f"{tuple(k.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not in {HEAD_DIMS}")
    if lse.dtype != torch.float32 or lse.shape != (b, h, sq) \
            or not lse.is_contiguous():
        raise ValueError(f"lse: needs fp32 (b, h, sq) = {(b, h, sq)} "
                         f"contiguous, got {lse.dtype} {tuple(lse.shape)}")
    # the dq grid is (b*h, q tiles), the dk/dv grid (b*kvh, kv tiles)
    check_attention_sizes(b, sq, skv, h, 0)
    check_attention_sizes(b, skv, sq, g, 0)
    for name, t in (("q", q), ("k", k), ("v", v), ("o", o), ("do", do)):
        check_rows(name, t)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, causal: bool = True) \
        -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, o, do (b, sq, h, d); k, v (b, skv, kvh, d); lse (b, h, sq) fp32
    -> (dq (b, sq, h, d), dk, dv (b, skv, kvh, d))."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal)
    _check(q, k, v, o, lse, do)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd runs on CUDA or the CPU, not "
                         f"{q.device}")
    b, sq, h, d = q.shape
    _, skv, g, _ = k.shape
    scale = 1.0 / math.sqrt(d)
    if d < TILE:
        # the kernels' panels are 64 columns: zero columns add nothing to
        # a score and get a zero gradient
        q, k, v, o, do = (F.pad(t, (0, TILE - d)) for t in (q, k, v, o, do))
    dp = q.shape[-1]
    dq = torch.empty((b, sq, h, dp), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, skv, g, dp), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    stats = torch.empty((b * h, 2, -(-sq // TILE) * TILE),
                        dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device)

    def strides(t):
        return _S(t.stride(0), t.stride(1), t.stride(2))

    rc = _lib().repro_flash_attention_bwd_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), stats.data_ptr(), b, sq, skv, h, g, dp,
        strides(q), strides(k), strides(v), strides(o), strides(do),
        int(causal), scale, q.device.index, stream.cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {rc}")
    for _ in range(2):
        launch_count.launched("flash_attention_bwd", stream)
    if dp != d:
        dq, dk, dv = dq[..., :d], dk[..., :d], dv[..., :d]
    return dq, dk, dv
