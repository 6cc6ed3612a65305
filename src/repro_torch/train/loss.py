"""Losses and training metrics (torch counterpart of ``repro.train.loss``).

The label's logit is picked with ``gather`` where the JAX package contracts
with a one-hot (which it does to keep a sharded vocab dim sharded): the
other terms of that contraction are exact zeros, so the two agree, and the
(b, s, vocab) one-hot is never built. Under a mesh (the dry run), where
the vocab dim is sharded, the label's logit is that contraction, as in the
JAX package: DTensor's gather along a sharded dim cannot be reduced
(ROADMAP C11).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import checkpointed
from repro_torch.sharding.partition import active_mesh, matmul, on_shards


def _label_logit(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits[..., labels]: a gather, or under a mesh a one-hot
    contraction."""
    if active_mesh() is None:
        return logits.gather(-1, labels.long()[..., None])[..., 0]
    vocab = torch.arange(logits.shape[-1], device=logits.device)
    return (logits * (labels.long()[..., None] == vocab)).sum(-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) \
        -> Tuple[torch.Tensor, Dict]:
    """Token-mean cross entropy in fp32. logits: (b, s, v); labels: (b, s)."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    nll = lse - _label_logit(lf, labels)
    mask = torch.ones_like(nll) if mask is None else mask.float()
    denom = torch.clamp(mask.sum(), min=1.0)
    loss = (nll * mask).sum() / denom
    acc = ((lf.argmax(-1) == labels).float() * mask).sum() / denom
    return loss, {"loss": loss, "accuracy": acc, "tokens": denom}


def _chunk_sums(xb: torch.Tensor, w: torch.Tensor, lb: torch.Tensor,
                mb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked nll sum, masked correct count) of one sequence chunk."""
    logits = matmul(xb, w).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = _label_logit(logits, lb)
    correct = (logits.argmax(-1) == lb).float()
    return ((lse - ll) * mb).sum(), (correct * mb).sum()


def _pad_seq(t: torch.Tensor, pad: int) -> torch.Tensor:
    """t (b, s, ...) zero-padded to s + pad; under a mesh per device on its
    batch rows (torch 2.11's DTensor fails to pad a sharded tensor)."""
    axes = ("act_batch",) + (None,) * (t.dim() - 1)
    return on_shards(
        lambda t: F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad)), (t,), (axes,),
        [axes])


def chunked_cross_entropy(x: torch.Tensor, w: torch.Tensor,
                          labels: torch.Tensor,
                          mask: Optional[torch.Tensor] = None,
                          chunk: int = 1024) -> Tuple[torch.Tensor, Dict]:
    """Sequence-chunked, rematerialized CE: logits are produced (and, in the
    backward pass, re-produced) one seq-chunk at a time, so the peak logits
    footprint is (b, chunk, vocab) instead of (b, s, vocab), the dominant
    training temporary at a 100k vocab.

    x: (b, s, d) final hidden states; w: (d, v) unembedding.
    """
    b, s, d = x.shape
    if mask is None:
        mask = torch.ones((b, s), dtype=torch.float32, device=x.device)
    mask = mask.float()
    c = min(chunk, s)
    pad = (-s) % c
    if pad:
        x, labels, mask = (_pad_seq(t, pad) for t in (x, labels, mask))
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    nll_sum, acc_sum, cnt = zero, zero, zero
    for c0 in range(0, s + pad, c):
        mb = mask[:, c0:c0 + c]
        nll, acc = checkpointed(_chunk_sums, x[:, c0:c0 + c], w,
                         labels[:, c0:c0 + c], mb)
        nll_sum, acc_sum, cnt = nll_sum + nll, acc_sum + acc, cnt + mb.sum()
    denom = torch.clamp(cnt, min=1.0)
    loss = nll_sum / denom
    return loss, {"loss": loss, "accuracy": acc_sum / denom, "tokens": denom}
