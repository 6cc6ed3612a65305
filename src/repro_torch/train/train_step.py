"""The training step: loss, gradients, AdamW update (torch counterpart of
``repro.train.train_step``; each block is recomputed in the backward)."""
from __future__ import annotations

from functools import partial
from typing import Dict, Tuple

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models import model as M
from repro_torch.train.loss import chunked_cross_entropy
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         tree_leaves, tree_map,
                                         tree_unflatten)


def loss_fn(cfg: LMConfig, params, batch: Dict) -> Tuple[torch.Tensor, Dict]:
    hidden, aux = M.forward(cfg, params, batch["tokens"],
                            batch.get("prefix_emb"), remat=True,
                            return_hidden=True)
    # loss on text positions only (modality prefixes carry no labels)
    if cfg.prefix_len:
        hidden = hidden[:, cfg.prefix_len:, :]
    loss, metrics = chunked_cross_entropy(
        hidden, M.unembed_weight(cfg, params), batch["labels"],
        batch.get("loss_mask"))
    metrics["aux_loss"] = aux
    return loss + aux, metrics


def grad_step(cfg: LMConfig, params, batch):
    """Gradient-only step (used by the hetero trainer: groups compute grads
    on their chunks; the combine is example-count-weighted). Returns
    (grads, a tree like ``params``; metrics). Nothing here waits for the
    device."""
    live = tree_map(lambda p: p.detach().requires_grad_(), params)
    loss, metrics = loss_fn(cfg, live, batch)
    grads = torch.autograd.grad(loss, tree_leaves(live),
                                materialize_grads=True)
    return tree_unflatten(live, grads), metrics


def chunk_grad_step(cfg: LMConfig, params, batch):
    """A chunk's step as the hetero trainer combines it (the body of the
    JAX trainer's ``_grad_fn``, whose ``g * n`` the combine does in fp32):
    (grads, the loss times n, n), n the chunk's real examples (the rows
    whose loss mask is set; padded rows have none)."""
    grads, metrics = grad_step(cfg, params, batch)
    n = batch["loss_mask"][:, 0].sum()
    return grads, metrics["loss"].detach() * n, n


def train_step(cfg: LMConfig, oc: OptConfig, params, opt, batch):
    """One optimizer step. Returns (params', opt', metrics)."""
    grads, metrics = grad_step(cfg, params, batch)
    params, opt, opt_metrics = adamw_update(oc, params, grads, opt)
    metrics.update(opt_metrics)
    return params, opt, metrics


def make_train_step(cfg: LMConfig, oc: OptConfig):
    return partial(train_step, cfg, oc)
