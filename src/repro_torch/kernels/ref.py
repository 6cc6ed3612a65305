"""Plain oracles of the JAX package's kernel layouts (counterparts of
``repro.kernels.ref``): q (B·H, Sq, D), k/v (B·KVH, Skv, D); for the SSD
scan x (B·H, S, P), B/C (B·H, S, N)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, n_heads=None,
                        n_kv_heads=None):
    """q: (B·H, Sq, D); k, v: (B·KVH, Skv, D). The causal mask is aligned
    bottom-right (``tril(k=skv-sq)``), as the JAX oracle's."""
    BH, sq, d = q.shape
    skv = k.shape[1]
    group = n_heads // n_kv_heads
    b = BH // n_heads
    qh = q.reshape(b, n_heads, sq, d).float()
    kh = k.reshape(b, n_kv_heads, skv, d).repeat_interleave(group, 1).float()
    vh = v.reshape(b, n_kv_heads, skv, d).repeat_interleave(group, 1)
    s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) / math.sqrt(d)
    if causal:
        mask = torch.ones((sq, skv), dtype=torch.bool,
                          device=q.device).tril(skv - sq)
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    o = torch.einsum("bhqk,bhkd->bhqd", p, vh.float())
    return o.reshape(BH, sq, d).to(q.dtype)


def flash_decode_ref(q, k, v, kv_len, *, n_heads=None, n_kv_heads=None):
    """q: (B·H, D); k, v: (B·KVH, S, D); kv_len: (B,)."""
    BH, d = q.shape
    b = BH // n_heads
    group = n_heads // n_kv_heads
    S = k.shape[1]
    qh = q.reshape(b, n_heads, d).float()
    kh = k.reshape(b, n_kv_heads, S, d).repeat_interleave(group, 1).float()
    vh = v.reshape(b, n_kv_heads, S, d).repeat_interleave(group, 1)
    s = torch.einsum("bhd,bhkd->bhk", qh, kh) / math.sqrt(d)
    mask = torch.arange(S, device=q.device)[None, None, :] \
        < kv_len.reshape(-1)[:, None, None]
    s = s.masked_fill(~mask, NEG_INF)
    p = torch.softmax(s, dim=-1).to(v.dtype).float()
    o = torch.einsum("bhk,bhkd->bhd", p, vh.float())
    return o.reshape(BH, d).to(q.dtype)


def ssd_scan_ref(x, dt, A, B, C):
    """Sequential-recurrence oracle. x: (BH, S, P); dt: (BH, S); A: (BH,);
    B, C: (BH, S, N). Returns (BH, S, P)."""
    BH, S, P = x.shape
    N = B.shape[-1]
    xf, dtf, Bf, Cf = x.float(), dt.float(), B.float(), C.float()
    state = torch.zeros((BH, N, P), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        da = torch.exp(dtf[:, t] * A)                          # (BH,)
        state = state * da[:, None, None] + dtf[:, t, None, None] \
            * Bf[:, t, :, None] * xf[:, t, None, :]
        ys.append(torch.einsum("bn,bnp->bp", Cf[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype)
