"""Unified model API over the architecture families (torch counterpart of
``repro.models.model``), for the attention families of this port:

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
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import init_from_defs

#: the families this port runs; ``moe``, ``ssm`` and ``hybrid`` are queued
ATTN_FAMILIES = ("dense", "vlm", "audio")

_NOT_PORTED = {
    "moe": "MoE FFN (ROADMAP.md, queue A item 8)",
    "hybrid": "Mamba-2 / zamba2 hybrid and the ssd_scan kernel "
              "(ROADMAP.md, queue A item 9 and queue B item 3)",
    "ssm": "xLSTM (ROADMAP.md, queue A item 10)",
}


def _check_family(cfg: LMConfig) -> None:
    if cfg.family in ATTN_FAMILIES:
        return
    if cfg.family in _NOT_PORTED:
        raise NotImplementedError(
            f"{cfg.arch_id}: family {cfg.family!r} is not ported yet: "
            f"{_NOT_PORTED[cfg.family]}")
    raise ValueError(cfg.family)


def param_defs(cfg: LMConfig) -> Dict:
    _check_family(cfg)
    return tfm.transformer_defs(cfg)


def init_params(cfg: LMConfig, generator: torch.Generator, device) -> Dict:
    """Random weights drawn from ``generator`` (normal with stddev
    ``scale/sqrt(fan_in)``, zeros, ones, as the JAX package's
    ``init_params``), placed on ``device``."""
    return init_from_defs(param_defs(cfg), generator, device)


def prefill(cfg: LMConfig, params, tokens, prefix_emb=None, max_len=None):
    _check_family(cfg)
    return tfm.prefill(cfg, params, tokens, prefix_emb, max_len)


def decode_step(cfg: LMConfig, params, cache, tokens):
    _check_family(cfg)
    return tfm.decode_step(cfg, params, cache, tokens)


def init_cache(cfg: LMConfig, batch: int, max_len: int, device):
    _check_family(cfg)
    return tfm.init_cache(cfg, batch, max_len, device)
