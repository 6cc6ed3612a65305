"""Chunked (flash-style) attention in eager torch, and its CUDA dispatch.

Torch counterpart of ``repro.models.attention``. The eager functions are the
CPU path and mirror the JAX package's chunked online softmax. When the
tensors lie on a CUDA device, ``chunked_attention`` and ``decode_attention``
run the hand-written kernels instead (``repro_torch.kernels``); the device
of the tensors decides, and a CUDA tensor never takes the eager path.

GQA layout convention: q is grouped as (b, s, g, m, hd) where g = n_kv_heads
and m = n_heads // n_kv_heads; k/v are (b, s, g, hd).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

NEG_INF = -1e30


def group_query_heads(q: torch.Tensor, n_kv_heads: int) -> torch.Tensor:
    """(b, s, n_heads, hd) -> (b, s, g, m, hd)."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, n_kv_heads, h // n_kv_heads, hd)


def ungroup_heads(o: torch.Tensor) -> torch.Tensor:
    b, s, g, m, hd = o.shape
    return o.reshape(b, s, g * m, hd)


def _block(q_blk, k_blk, v_blk, m_prev, l_prev, acc, row0: int, col0: int,
           causal: bool, kv_len: Optional[torch.Tensor], scale: float):
    """One online-softmax block update.

    q_blk: (b, qc, g, m, hd)   k_blk/v_blk: (b, kc, g, hd)
    m_prev/l_prev: (b, g, m, qc)  acc: (b, qc, g, m, hd) fp32
    """
    qc, kc = q_blk.shape[1], k_blk.shape[1]
    dev = q_blk.device
    s = torch.einsum("bqgmh,bkgh->bgmqk", q_blk.float(),
                     k_blk.float()) * scale
    rows = row0 + torch.arange(qc, device=dev)
    cols = col0 + torch.arange(kc, device=dev)
    mask = None
    if causal:
        mask = rows[:, None] >= cols[None, :]
    if kv_len is not None:
        lm = cols[None, :] < kv_len.reshape(-1, 1)               # (b, kc)
        lm = lm[:, None, None, None, :]                          # (b,1,1,1,kc)
        mask = lm if mask is None else mask & lm
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    m_new = torch.maximum(m_prev, s.amax(-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m_prev - m_new)
    l_new = l_prev * corr + p.sum(-1)
    pv = torch.einsum("bgmqk,bkgh->bqgmh", p.to(v_blk.dtype).float(),
                      v_blk.float())
    acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
    return m_new, l_new, acc


def _chunked_attention_eager(q, k, v, *, causal, q_chunk, kv_chunk, kv_len,
                             q_offset, block_skip):
    b, sq, g, m, hd = q.shape
    skv = k.shape[1]
    sq0, skv0 = sq, skv
    qc = min(q_chunk, sq)
    kc = min(kv_chunk, skv)
    qpad, kpad = (-sq) % qc, (-skv) % kc
    if qpad:
        q = F.pad(q, (0, 0, 0, 0, 0, 0, 0, qpad))
        sq += qpad
    if kpad:
        k = F.pad(k, (0, 0, 0, 0, 0, kpad))
        v = F.pad(v, (0, 0, 0, 0, 0, kpad))
        skv += kpad
        if kv_len is None:
            kv_len = torch.full((b,), skv0, dtype=torch.int32,
                                device=q.device)
    if kv_len is not None:
        kv_len = torch.as_tensor(kv_len, device=q.device).reshape(-1)
    nq, nk = sq // qc, skv // kc
    scale = 1.0 / math.sqrt(hd)
    outs = []
    for qi in range(nq):
        q_blk = q[:, qi * qc:(qi + 1) * qc]
        mx = torch.full((b, g, m, qc), NEG_INF, dtype=torch.float32,
                        device=q.device)
        l = torch.zeros((b, g, m, qc), dtype=torch.float32, device=q.device)
        acc = torch.zeros((b, qc, g, m, hd), dtype=torch.float32,
                          device=q.device)
        for kj in range(nk):
            # the triangular schedule skips blocks wholly above the
            # diagonal; they contribute nothing, so the result is the same
            if block_skip and kj * kc > q_offset + qi * qc + qc - 1:
                continue
            mx, l, acc = _block(q_blk, k[:, kj * kc:(kj + 1) * kc],
                                v[:, kj * kc:(kj + 1) * kc], mx, l, acc,
                                row0=q_offset + qi * qc, col0=kj * kc,
                                causal=causal, kv_len=kv_len, scale=scale)
        out = acc / torch.clamp(l, min=1e-37).permute(0, 3, 1, 2)[..., None]
        outs.append(out.to(q.dtype))
    return torch.cat(outs, dim=1)[:, :sq0]


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True,
                      q_chunk: int = 512, kv_chunk: int = 1024,
                      kv_len: Optional[torch.Tensor] = None,
                      q_offset: int = 0,
                      block_skip: bool = False) -> torch.Tensor:
    """Online-softmax attention over (q, kv) chunks.

    q: (b, sq, g, m, hd); k, v: (b, skv, g, hd). Returns (b, sq, g, m, hd).
    ``kv_len`` (scalar or (b,)) masks cache positions >= kv_len.
    ``q_offset``: absolute position of q[0] (for decode-with-history).
    On CUDA this is the flash-attention kernel (chunk sizes are the
    kernel's own tiles, and ``kv_len`` is not supported there).
    """
    if block_skip and not causal:
        raise ValueError("block_skip requires causal attention")
    if q.is_cuda:
        if kv_len is not None:
            raise NotImplementedError(
                "the CUDA flash-attention kernel takes no kv_len; the "
                "serving path never passes one to prefill")
        b, sq, g, m, hd = q.shape
        o = ops.attention_bshd(ungroup_heads(q), k, v, n_heads=g * m,
                               n_kv_heads=g, causal=causal,
                               q_offset=q_offset)
        return group_query_heads(o, g)
    return _chunked_attention_eager(q, k, v, causal=causal, q_chunk=q_chunk,
                                    kv_chunk=kv_chunk, kv_len=kv_len,
                                    q_offset=q_offset, block_skip=block_skip)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """Single-position attention against a (padded) KV cache.

    q: (b, 1, g, m, hd); caches: (b, S, g, hd), read through their strides
    (a layer's slice of the stacked cache is not copied); kv_len: (b,)
    int32 on the caches' device. On CUDA this is the flash-decode kernel.
    """
    b, _, g, m, hd = q.shape
    if q.is_cuda:
        o = ops.decode_attention_bshd(ungroup_heads(q), k_cache, v_cache,
                                      kv_len, n_heads=g * m, n_kv_heads=g)
        return group_query_heads(o, g)
    S = k_cache.shape[1]
    scale = 1.0 / math.sqrt(hd)
    s = torch.einsum("bqgmh,bkgh->bgmqk", q.float(), k_cache.float()) * scale
    kv_len = torch.as_tensor(kv_len, device=q.device).reshape(-1, 1)
    mask = torch.arange(S, device=q.device)[None, :] < kv_len
    s = torch.where(mask[:, None, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bgmqk,bkgh->bqgmh", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.to(q.dtype)


def reference_attention(q, k, v, *, causal=True, kv_len=None, q_offset=0):
    """O(s²)-memory oracle used by tests (never by the system itself)."""
    b, sq, g, m, hd = q.shape
    skv = k.shape[1]
    dev = q.device
    s = torch.einsum("bqgmh,bkgh->bgmqk", q.float(),
                     k.float()) / math.sqrt(hd)
    rows = q_offset + torch.arange(sq, device=dev)
    cols = torch.arange(skv, device=dev)
    mask = torch.ones((sq, skv), dtype=torch.bool, device=dev)
    if causal:
        mask = rows[:, None] >= cols[None, :]
    if kv_len is not None:
        lm = cols[None, :] < torch.as_tensor(kv_len, device=dev).reshape(-1, 1)
        s = torch.where(lm[:, None, None, None, :], s,
                        torch.full_like(s, NEG_INF))
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bgmqk,bkgh->bqgmh", p.to(v.dtype).float(),
                        v.float()).to(q.dtype)
