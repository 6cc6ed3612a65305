"""Unified model API over the architecture families (torch counterpart of
``repro.models.model``), for the families this port runs:

    defs   = param_defs(cfg)                       # ParamDef tree
    params = init_params(cfg, generator, device)
    logits, cache = prefill(cfg, params, tokens, prefix_emb, max_len=...)
    logits, cache = decode_step(cfg, params, cache, tokens)
    cache  = init_cache(cfg, batch, max_len, device)
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models import hybrid as hyb
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import init_from_defs

#: the attention families, served by ``transformer``; ``hybrid`` (zamba2)
#: is served by ``hybrid``; ``moe`` and ``ssm`` are queued
ATTN_FAMILIES = ("dense", "vlm", "audio")

_NOT_PORTED = {
    "moe": "MoE FFN (ROADMAP.md, queue A item 8)",
    "ssm": "xLSTM (ROADMAP.md, queue A item 10)",
}


def _module(cfg: LMConfig):
    if cfg.family in ATTN_FAMILIES:
        return tfm
    if cfg.family == "hybrid":
        return hyb
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.arch_id}: family {cfg.family!r} is not ported yet: "
            f"{_NOT_PORTED[cfg.family]}")
    raise ValueError(cfg.family)


def param_defs(cfg: LMConfig) -> Dict:
    if _module(cfg) is hyb:
        return hyb.hybrid_defs(cfg)
    return tfm.transformer_defs(cfg)


def init_params(cfg: LMConfig, generator: torch.Generator, device) -> Dict:
    """Random weights drawn from ``generator`` (normal with stddev
    ``scale/sqrt(fan_in)``, zeros, ones, as the JAX package's
    ``init_params``), placed on ``device``."""
    return init_from_defs(param_defs(cfg), generator, device)


def prefill(cfg: LMConfig, params, tokens, prefix_emb=None, max_len=None):
    return _module(cfg).prefill(cfg, params, tokens, prefix_emb, max_len)


def decode_step(cfg: LMConfig, params, cache, tokens):
    return _module(cfg).decode_step(cfg, params, cache, tokens)


def init_cache(cfg: LMConfig, batch: int, max_len: int, device):
    return _module(cfg).init_cache(cfg, batch, max_len, device)
