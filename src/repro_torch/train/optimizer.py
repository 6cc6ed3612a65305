"""AdamW with fp32 master weights, global-norm clipping, and LR schedule
(torch counterpart of ``repro.train.optimizer``).

Trees are nested dicts of tensors, walked in sorted key order as
``jax.tree`` walks them. ``adamw_update`` updates the optimizer state and
the parameters in place (the JAX version returns new trees, which at 1.6 B
parameters would hold two copies of 26 GB of state) and returns them. It
takes one gradient tree, or the chunks' trees of a step (``ChunkGrads``),
and runs in two passes over the leaves, the hand-written kernel's on the
card (``kernels.adamw_step``) and the eager chain's plain version on the
CPU: the combined gradient's norm and clip scale, then AdamW.
The step count is a 0-d int32 tensor on the CPU, so the learning rate and
the bias corrections are worked out without a device round trip.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import adamw_step


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def tree_leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """A tree shaped like ``like`` holding ``leaves`` (in tree_leaves'
    order)."""
    return _unflatten(like, iter(leaves))


def _unflatten(node, it):
    # a module-level recursion: a nested function calling itself would be
    # a reference cycle holding ``it``, so ``leaves`` (a step's gradients)
    # would live until the garbage collector next ran
    if isinstance(node, dict):
        return {k: _unflatten(node[k], it) for k in sorted(node)}
    return next(it)


def tree_map(fn: Callable, tree, *rest):
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def lr_at(oc: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step``, in fp32 as the JAX package works it
    out: linear warmup, then cosine down to ``min_lr_frac``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(oc.warmup_steps, 1)
    prog = torch.clamp((step - oc.warmup_steps)
                       / max(oc.total_steps - oc.warmup_steps, 1), 0, 1)
    cos = oc.min_lr_frac + (1 - oc.min_lr_frac) * 0.5 \
        * (1 + torch.cos(math.pi * prog))
    return oc.lr * torch.where(step < oc.warmup_steps, warm, cos)


def init_opt_state(params) -> Dict:
    return {
        "master": tree_map(
            lambda p: p.detach().to(torch.float32, copy=True), params),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32),
    }


def abstract_opt_state(abstract_params) -> Dict:
    """``init_opt_state``'s tree on the meta device: fp32 master, m and v
    shaped as the parameters, and the 0-d int32 step."""
    def f32(p):
        return torch.empty(p.shape, dtype=torch.float32, device="meta")
    return {
        "master": tree_map(f32, abstract_params),
        "m": tree_map(f32, abstract_params),
        "v": tree_map(f32, abstract_params),
        "step": torch.empty((), dtype=torch.int32, device="meta"),
    }


def opt_state_axes(p_axes) -> Dict:
    return {"master": p_axes, "m": p_axes, "v": p_axes, "step": ()}


def global_norm(tree) -> torch.Tensor:
    return adamw_step.global_norm_plain(tree_leaves(tree))


def _host(t: torch.Tensor):
    """A 0-d tensor's value as a Python float; on the meta device (the
    dry run), which holds no values, the tensor itself."""
    return t if t.is_meta else float(t)


def _taken(g: torch.Tensor, device: Optional[torch.device]) \
        -> torch.Tensor:
    """A chunk's leaf as the kernel reads it: on ``device``, contiguous and
    16-byte aligned. A CUDA leaf was made on its chunk's stream and is read
    (copied, moved or passed to the kernel) on this one: record_stream
    keeps its memory from that stream's next allocations until the read is
    done, also where the leaf itself is dropped once copied."""
    if g.is_cuda:
        g.record_stream(torch.cuda.current_stream(g.device))
    if device is not None:
        g = g.to(device)
    if g.is_cuda and (not g.is_contiguous() or g.data_ptr() % 16):
        return g.clone(memory_format=torch.contiguous_format)
    return g


class ChunkGrads:
    """A step's gradients as its chunks left them, not yet combined: each
    chunk's tree (like the parameters, in their dtype) and its example
    count n. ``adamw_update`` combines them, sum g n / sum n in fp32, inside
    its two passes over the leaves (``kernels.adamw_step``); on the card
    the combined gradient is never stored. ``device``: where the leaves
    are moved first (a CPU group's chunks, for the card's update). A CUDA
    leaf that is not contiguous and 16-byte aligned, as autograd may give
    a view, is copied into one that is, as the kernel reads it."""

    def __init__(self, trees: Sequence, counts: Sequence[float],
                 device: Optional[torch.device] = None):
        chunks = [[_taken(g, device) for g in tree_leaves(t)]
                  for t in trees]
        #: leaf i's gradient from each chunk, in tree_leaves' order
        self.leaves: List[List[torch.Tensor]] = [list(c) for c in
                                                 zip(*chunks)]
        self.counts = [float(n) for n in counts]
        self._norm: Optional[adamw_step.GradNorm] = None

    def norm(self, oc: OptConfig) -> adamw_step.GradNorm:
        """The first pass, once: the combined gradient's global norm and
        the clip scale (``oc.clip_norm``), on the leaves' device."""
        if self._norm is None:
            self._norm = adamw_step.grad_norm(self.leaves, self.counts,
                                              oc.clip_norm)
        return self._norm


@torch.no_grad()
def adamw_update(oc: OptConfig, params, grads, opt: Dict) \
        -> Tuple[Dict, Dict, Dict]:
    """``grads``: a tree like ``params`` (one chunk of weight 1) or a
    ``ChunkGrads``, whose norm pass may have run already. Returns (params,
    opt, metrics): ``params`` and ``opt``'s trees are the ones passed in,
    updated in place, every tensor at its address."""
    if not isinstance(grads, ChunkGrads):
        grads = ChunkGrads([grads], [1.0])
    gn = grads.norm(oc)
    step = opt["step"] + 1
    lr = lr_at(oc, step)
    stepf = step.to(torch.float32)
    bc1 = _host(1 - torch.tensor(oc.beta1, dtype=torch.float32) ** stepf)
    bc2 = _host(1 - torch.tensor(oc.beta2, dtype=torch.float32) ** stepf)
    adamw_step.adamw_step(
        grads.leaves, grads.counts, gn, tree_leaves(opt["m"]),
        tree_leaves(opt["v"]), tree_leaves(opt["master"]),
        tree_leaves(params),
        adamw_step.Hyper(lr=_host(lr), beta1=oc.beta1, beta2=oc.beta2,
                         eps=oc.eps, weight_decay=oc.weight_decay, bc1=bc1,
                         bc2=bc2))
    opt["step"] = step
    return params, opt, {"grad_norm": gn.norm, "lr": lr}
