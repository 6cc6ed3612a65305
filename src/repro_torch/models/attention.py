"""Chunked (flash-style) attention in eager torch, and its CUDA dispatch.

Torch counterpart of ``repro.models.attention``. The eager functions are the
CPU path and mirror the JAX package's chunked online softmax. When the
tensors lie on a CUDA device, ``chunked_attention`` and ``decode_attention``
run the hand-written kernels instead (``repro_torch.kernels``); the device
of the tensors decides, and a CUDA tensor never takes the eager path.
Neither has a backward on CUDA (the kernels raise if asked for one).

Training goes through ``FlashAttentionFn``, the counterpart of the JAX
package's ``flash_attention_jax`` custom VJP: the forward is the
flash-attention kernel writing its row log-sum-exp L (on the CPU, the
kernel's plain version); the backward is the flash-attention backward
kernels on CUDA, and on the CPU ``_flash_bwd_rule`` blocked over (q chunk,
kv chunk) in fp32.

GQA layout convention: q is grouped as (b, s, g, m, hd) where g = n_kv_heads
and m = n_heads // n_kv_heads; k/v are (b, s, g, hd). The model calls them
through ``attend``, which groups q and ungroups the output; under a mesh
(the dry run's ``DTensor``s) it runs them on each device's own shards.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import cost, ops
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
from repro_torch.sharding.partition import active_mesh, run_local

NEG_INF = -1e30


def group_query_heads(q: torch.Tensor, n_kv_heads: int) -> torch.Tensor:
    """(b, s, n_heads, hd) -> (b, s, g, m, hd)."""
    b, s, h, hd = q.shape
    return q.reshape(b, s, n_kv_heads, h // n_kv_heads, hd)


def ungroup_heads(o: torch.Tensor) -> torch.Tensor:
    b, s, g, m, hd = o.shape
    return o.reshape(b, s, g * m, hd)


def attend(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           *rest: torch.Tensor) -> torch.Tensor:
    """``fn(q grouped by kv head, k, v, *rest)`` ungrouped back to the
    model layout: q (b, sq, h, hd), k/v (b, skv, g, hd) -> (b, sq, h, hd).
    ``fn`` is ``chunked_attention``, ``FlashAttentionFn.apply`` or
    ``decode_attention`` with its options bound. Under a mesh every device
    runs ``fn`` on its own shards (``_attend_local``)."""
    if active_mesh() is None:
        return ungroup_heads(fn(group_query_heads(q, k.shape[2]), k, v,
                                *rest))
    return _attend_local(fn, q, k, v, *rest)


def _attend_local(fn, q, k, v, *rest):
    """``attend`` on DTensors, per device (``sharding.run_local``), each
    device holding whole sequences of some (batch, query head) pairs.

    Batch shards stay; query-head shards stay, and the kv heads stay
    sharded with them where each device's kv heads are exactly its query
    heads' groups (g divisible by the mesh dim). Otherwise the kv heads
    are gathered and each device reads the ones its query heads use: a
    head split over both GQA dims (yi-6b's 32 heads on 4 kv heads over 16
    devices) has no DTensor placement in the grouped layout. Sequence
    shards (the residual stream's, long_500k's cache) are gathered. The
    gradient of gathered kv heads is partial: each device adds its own
    heads' part."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh = active_mesh()
    h, g = q.shape[2], k.shape[2]
    q_pl, kv_pl, kv_grad, head_dim = [], [], [], None
    for i, (a, c) in enumerate(zip(q.placements, k.placements)):
        n = mesh.size(i)
        if Shard(0) in (a, c):
            q_pl.append(Shard(0))
            kv_pl.append(Shard(0))
            kv_grad.append(Shard(0))
        elif a == Shard(2):
            head_dim = i
            q_pl.append(a)
            kv_pl.append(c if c == Shard(2) and g % n == 0 else Replicate())
            kv_grad.append(kv_pl[-1] if kv_pl[-1] == Shard(2) else Partial())
        else:
            q_pl.append(Replicate())
            kv_pl.append(Replicate())
            kv_grad.append(Replicate())
    rest_pl = [tuple(Shard(0) if p == Shard(0) else Replicate()
                     for p in q_pl) for _ in rest]
    gathered = head_dim is not None and kv_pl[head_dim] != Shard(2)

    def local(q_l, k_l, v_l, *rest_l):
        if gathered:
            # this device's query heads [off, off + h_l) read kv heads
            # (off + j) // m; a contiguous run keeps the grouping
            h_l, m = q_l.shape[2], h // g
            off = min(h, mesh.get_local_rank(head_dim)
                      * -(-h // mesh.size(head_dim)))
            kv0, kv1 = off // m, (off + h_l - 1) // m + 1
            if h_l % (kv1 - kv0) == 0 and all(
                    (off + j) // m - kv0 == j // (h_l // (kv1 - kv0))
                    for j in range(h_l)):
                k_l, v_l = k_l[:, :, kv0:kv1], v_l[:, :, kv0:kv1]
            else:
                idx = (off + torch.arange(h_l, device=q_l.device)) // m
                k_l, v_l = k_l[:, :, idx], v_l[:, :, idx]
        o = fn(group_query_heads(q_l, k_l.shape[2]), k_l, v_l, *rest_l)
        return ungroup_heads(o)

    return run_local(local, (q, k, v, *rest),
                     (tuple(q_pl), tuple(kv_pl), tuple(kv_pl), *rest_pl),
                     (tuple(q_pl), tuple(kv_grad), tuple(kv_grad), *rest_pl),
                     [tuple(q_pl)], lambda outs: [q.shape])


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
    if q.is_cuda or q.is_meta:
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


# ---------------------------------------------------------------------------
# flash-style autograd Function (the training path)
#
# The forward saves only (q, k, v, o, L = m + ln l) per row; the backward
# rebuilds each probability block: p = exp(s - L); dv += p^T do;
# ds = p * (do v^T - delta) * scale; dq += ds k; dk += ds^T q, with
# delta = sum(do * o) per row (repro/models/attention.py:258-311). Blocks
# are cut as the JAX package cuts them, except that the last one may be
# shorter: rows and columns are independent, so no padding is needed.
# ---------------------------------------------------------------------------

def _flash_bwd(q, k, v, o, L, do, causal: bool, q_chunk: int,
               kv_chunk: int):
    """(dq, dk, dv) in the inputs' dtypes, accumulated in fp32; dk and dv
    sum over the query heads of each kv head's group."""
    b, sq, g, m, hd = q.shape
    skv = k.shape[1]
    qc, kc = min(q_chunk, sq), min(kv_chunk, skv)
    scale = 1.0 / math.sqrt(hd)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = torch.einsum("bqgmh,bqgmh->bgmq", dof, o.float())
    dq = torch.zeros_like(qf)
    dk = torch.zeros_like(kf)
    dv = torch.zeros_like(vf)
    for q0 in range(0, sq, qc):
        q_blk, do_blk = qf[:, q0:q0 + qc], dof[:, q0:q0 + qc]
        L_blk, d_blk = L[..., q0:q0 + qc], delta[..., q0:q0 + qc]
        rows = q0 + torch.arange(q_blk.shape[1], device=q.device)
        for k0 in range(0, skv, kc):
            k_blk, v_blk = kf[:, k0:k0 + kc], vf[:, k0:k0 + kc]
            s = torch.einsum("bqgmh,bkgh->bgmqk", q_blk, k_blk) * scale
            if causal:
                cols = k0 + torch.arange(k_blk.shape[1], device=q.device)
                s = torch.where(rows[:, None] >= cols[None, :], s,
                                torch.full_like(s, NEG_INF))
            p = torch.exp(s - L_blk[..., None])
            dv[:, k0:k0 + kc] += torch.einsum("bgmqk,bqgmh->bkgh", p, do_blk)
            dp = torch.einsum("bqgmh,bkgh->bgmqk", do_blk, v_blk)
            ds = p * (dp - d_blk[..., None]) * scale
            dq[:, q0:q0 + qc] += torch.einsum("bgmqk,bkgh->bqgmh", ds, k_blk)
            dk[:, k0:k0 + kc] += torch.einsum("bgmqk,bqgmh->bkgh", ds, q_blk)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FlashAttentionFn(torch.autograd.Function):
    """Causal or full attention with a flash backward, for training.

    q (b, sq, g, m, hd); k, v (b, skv, g, hd) -> (b, sq, g, m, hd), the
    layout and semantics of ``chunked_attention`` without ``kv_len`` or
    ``q_offset``. The forward is the flash-attention kernel with its row
    log-sum-exp (``kernels.ops.attention_bshd(return_lse=True)``; on the
    CPU that is the kernel's plain version); the backward is the
    flash-attention backward kernels on CUDA
    (``kernels.flash_attention_bwd``) and ``_flash_bwd`` on the CPU. The
    chunks cut the CPU backward's blocks only."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True, q_chunk: int = 512,
                kv_chunk: int = 1024):
        b, sq, g, m, hd = q.shape
        o, L = ops.attention_bshd(ungroup_heads(q), k, v, n_heads=g * m,
                                  n_kv_heads=g, causal=causal,
                                  return_lse=True)
        o, L = group_query_heads(o, g), L.view(b, g, m, sq)
        ctx.save_for_backward(q, k, v, o, L)
        ctx.causal, ctx.q_chunk, ctx.kv_chunk = causal, q_chunk, kv_chunk
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, L = ctx.saved_tensors
        if q.is_meta and cost.evaluating():
            # abstract evaluation (the dry run): the blocked loop's work
            # charged, its gradients' shapes returned
            b, sq, g, m, hd = q.shape
            cost.charge("flash_attention_backward", cost.attention_bwd_flops(
                b, sq, k.shape[1], g * m, hd), 0)
            return (torch.empty_like(q), torch.empty_like(k),
                    torch.empty_like(v), None, None, None)
        if q.is_cuda:
            b, sq, g, m, hd = q.shape
            dq, dk, dv = flash_attention_bwd(
                ungroup_heads(q), k, v, ungroup_heads(o),
                L.view(b, g * m, sq), ungroup_heads(do.contiguous()),
                causal=ctx.causal)
            return group_query_heads(dq, g), dk, dv, None, None, None
        dq, dk, dv = _flash_bwd(q, k, v, o, L, do, ctx.causal, ctx.q_chunk,
                                ctx.kv_chunk)
        return dq, dk, dv, None, None, None


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """Single-position attention against a (padded) KV cache.

    q: (b, 1, g, m, hd); caches: (b, S, g, hd), read through their strides
    (a layer's slice of the stacked cache is not copied); kv_len: (b,)
    int32 on the caches' device. On CUDA this is the flash-decode kernel.
    """
    b, _, g, m, hd = q.shape
    if q.is_cuda or q.is_meta:
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
