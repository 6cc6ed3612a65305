"""AdamW with fp32 master weights, global-norm clipping, and LR schedule
(torch counterpart of ``repro.train.optimizer``).

Trees are nested dicts of tensors, walked in sorted key order as
``jax.tree`` walks them. ``adamw_update`` updates the optimizer state and
the parameters in place (the JAX version returns new trees, which at 1.6 B
parameters would hold two copies of 26 GB of state) and returns them.
The step count is a 0-d int32 tensor on the CPU, so the learning rate and
the bias corrections are worked out without a device round trip.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, List, Tuple

import torch


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
    it = iter(leaves)

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        return next(it)

    return build(like)


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
    return torch.sqrt(sum(torch.sum(torch.square(leaf.float()))
                          for leaf in tree_leaves(tree)))


def _host(t: torch.Tensor):
    """A 0-d tensor's value as a Python float; on the meta device (the
    dry run), which holds no values, the tensor itself."""
    return t if t.is_meta else float(t)


@torch.no_grad()
def adamw_update(oc: OptConfig, params, grads, opt: Dict) \
        -> Tuple[Dict, Dict, Dict]:
    """Returns (params, opt, metrics): ``params`` and ``opt``'s trees are
    the ones passed in, updated in place."""
    step = opt["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(oc.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(oc, step)
    b1, b2 = oc.beta1, oc.beta2
    stepf = step.to(torch.float32)
    bc1 = _host(1 - torch.tensor(b1, dtype=torch.float32) ** stepf)
    bc2 = _host(1 - torch.tensor(b2, dtype=torch.float32) ** stepf)
    lr_f = _host(lr)
    for g, m, v, master, p in zip(tree_leaves(grads), tree_leaves(opt["m"]),
                                  tree_leaves(opt["v"]),
                                  tree_leaves(opt["master"]),
                                  tree_leaves(params)):
        g = g.float() * scale
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(torch.square(g) * (1 - b2))
        update = (m / bc1) / (torch.sqrt(v / bc2) + oc.eps) \
            + oc.weight_decay * master
        master.sub_(lr_f * update)
        p.copy_(master)
    opt["step"] = step
    return params, opt, {"grad_norm": gnorm, "lr": lr}
