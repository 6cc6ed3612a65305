"""Unified model API over the architecture families (torch counterpart of
``repro.models.model``):

    defs   = param_defs(cfg)                       # ParamDef tree
    params = init_params(cfg, generator, device)
    logits, aux   = forward(cfg, params, tokens, prefix_emb, remat=...)
    logits, cache = prefill(cfg, params, tokens, prefix_emb, max_len=...)
    logits, cache = decode_step(cfg, params, cache, tokens)
    cache  = init_cache(cfg, batch, max_len, device)   # "meta": abstract
    specs  = input_specs(cfg, shape)               # meta-device stand-ins

Every family serves and trains. The cache is allocated once, in
``prefill``, and decode steps update its states in place; the training
``forward`` writes nothing in place.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig, ShapeSuite
from repro_torch.models import granite_hybrid as granite
from repro_torch.models import hybrid as hyb
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import (ParamDef, abstract_from_defs,
                                       axes_from_defs, checkpointed,
                                       init_from_defs, norm, norm_defs)
from repro_torch.sharding.partition import place, settle

#: the attention families, served by ``transformer``; ``ssm`` (xLSTM) is
#: assembled here, ``hybrid`` (zamba2) is served by ``hybrid``,
#: ``granite_hybrid`` by ``granite_hybrid``
ATTN_FAMILIES = ("dense", "vlm", "audio", "moe")


# ---------------------------------------------------------------------------
# xLSTM model assembly (blocks live in models/ssm.py)
# ---------------------------------------------------------------------------

def _xlstm_layout(cfg: LMConfig):
    every = cfg.xlstm.slstm_every
    assert cfg.n_layers % every == 0, (cfg.n_layers, every)
    return cfg.n_layers // every, every - 1   # (n_pairs, mlstm_per_pair)


def _xlstm_defs(cfg: LMConfig) -> Dict:
    n_pairs, n_m = _xlstm_layout(cfg)
    return {
        "embed": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                          scale=cfg.d_model ** 0.5, dtype=cfg.dtype),
        "m": tfm.stacked(tfm.stacked(ssm_lib.mlstm_defs(cfg), n_m), n_pairs),
        "s": tfm.stacked(ssm_lib.slstm_defs(cfg), n_pairs),
        "final_norm": norm_defs(cfg.d_model, cfg.norm_type),
        "unembed": ParamDef((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                            dtype=cfg.dtype),
    }


def _xlstm_pair(cfg: LMConfig, mp: Dict, sp: Dict,
                x: torch.Tensor) -> torch.Tensor:
    """One pair: its mLSTM blocks (``mp``'s leaves stacked over them),
    then its sLSTM block."""
    for bp in tfm.unbind_layers(mp, _xlstm_layout(cfg)[1]):
        x = ssm_lib.mlstm_block_fwd(cfg, bp, x)
    return ssm_lib.slstm_block_fwd(cfg, sp, x)


def _xlstm_forward(cfg: LMConfig, params: Dict, tokens: torch.Tensor,
                   prefix_emb=None, remat=False, return_hidden=False):
    """The training forward: the pairs in order, each recomputed in the
    backward with ``remat`` (``jax.checkpoint`` of the pair in the JAX
    package), then the final norm; the aux loss is 0."""
    x, _ = tfm.embed_tokens(cfg, params, tokens, prefix_emb)
    n_pairs, _ = _xlstm_layout(cfg)
    for mp, sp in zip(tfm.unbind_layers(params["m"], n_pairs),
                      tfm.unbind_layers(params["s"], n_pairs)):
        if remat:
            x = checkpointed(_xlstm_pair, cfg, mp, sp, x)
        else:
            x = _xlstm_pair(cfg, mp, sp, x)
    x = norm(x, params["final_norm"], cfg.norm_type, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    return tfm.logits_fwd(cfg, params, x), aux


def _xlstm_init_cache(cfg: LMConfig, batch: int, max_len: int,
                      device) -> Dict[str, torch.Tensor]:
    """The recurrent states (fp32; the stabilisers ``mm`` and ``sm`` at
    -inf) and ``pos``. ``max_len`` is unused: the state does not grow."""
    n_pairs, n_m = _xlstm_layout(cfg)
    _, nh, dh = ssm_lib.xlstm_dims(cfg)
    dh_s = cfg.d_model // cfg.n_heads

    def mk(shape, fill=0.0, dtype=torch.float32):
        return torch.full(shape, fill, dtype=dtype, device=device)

    s_shape = (n_pairs, batch, cfg.n_heads, dh_s)
    return {
        "mC": mk((n_pairs, n_m, batch, nh, dh, dh)),
        "mn": mk((n_pairs, n_m, batch, nh, dh)),
        "mm": mk((n_pairs, n_m, batch, nh), -torch.inf),
        "sc": mk(s_shape), "sn": mk(s_shape), "sh": mk(s_shape),
        "sm": mk(s_shape, -torch.inf),
        "pos": mk((batch,), 0, torch.int32),
    }


def _xlstm_cache_axes(cfg: LMConfig):
    return {
        "mC": (None, None, "cache_batch", "ssm_heads", None, None),
        "mn": (None, None, "cache_batch", "ssm_heads", None),
        "mm": (None, None, "cache_batch", "ssm_heads"),
        "sc": (None, "cache_batch", "ssm_heads", None),
        "sn": (None, "cache_batch", "ssm_heads", None),
        "sh": (None, "cache_batch", "ssm_heads", None),
        "sm": (None, "cache_batch", "ssm_heads", None),
        "pos": ("cache_batch",),
    }


_M_STATE, _S_STATE = ("mC", "mn", "mm"), ("sc", "sn", "sh", "sm")


def _store(cache: Dict, keys, index, state) -> None:
    for key, t in zip(keys, state):
        cache[key][index].copy_(t)


def _xlstm_prefill(cfg: LMConfig, params: Dict, tokens: torch.Tensor,
                   prefix_emb=None, max_len=None):
    x, _ = tfm.embed_tokens(cfg, params, tokens, prefix_emb)
    b, s = x.shape[0], x.shape[1]
    n_pairs, n_m = _xlstm_layout(cfg)
    cache = place(lambda: _xlstm_init_cache(cfg, b, max_len or s, x.device),
                  _xlstm_cache_axes(cfg))
    for pi in range(n_pairs):
        mp = tfm.layer_params(params["m"], pi)
        for mi in range(n_m):
            x, st = ssm_lib.mlstm_block_fwd(cfg, tfm.layer_params(mp, mi), x,
                                            return_state=True)
            _store(cache, _M_STATE, (pi, mi), st)
        x, st = ssm_lib.slstm_block_fwd(
            cfg, tfm.layer_params(params["s"], pi), x, return_state=True)
        _store(cache, _S_STATE, pi, st)
    x = norm(x, params["final_norm"], cfg.norm_type, cfg.norm_eps)
    cache["pos"].fill_(s)
    return tfm.logits_fwd(cfg, params, x[:, -1:, :]), cache


def _xlstm_decode(cfg: LMConfig, params: Dict, cache: Dict,
                  tokens: torch.Tensor):
    """One decode step: each block's new state is copied into the cache
    in place and ``pos`` advanced in place (the JAX version returns a new
    cache)."""
    x = settle(F.embedding(tokens, params["embed"]))     # (b, 1, d)
    n_pairs, n_m = _xlstm_layout(cfg)
    for pi in range(n_pairs):
        mp = tfm.layer_params(params["m"], pi)
        for mi in range(n_m):
            x, st = ssm_lib.mlstm_decode_step(
                cfg, tfm.layer_params(mp, mi), x,
                tuple(cache[key][pi, mi] for key in _M_STATE))
            _store(cache, _M_STATE, (pi, mi), st)
        x, st = ssm_lib.slstm_decode_step(
            cfg, tfm.layer_params(params["s"], pi), x,
            tuple(cache[key][pi] for key in _S_STATE))
        _store(cache, _S_STATE, pi, st)
    x = norm(x, params["final_norm"], cfg.norm_type, cfg.norm_eps)
    cache["pos"].add_(1)
    return tfm.logits_fwd(cfg, params, x), cache


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

def param_defs(cfg: LMConfig) -> Dict:
    if cfg.family in ATTN_FAMILIES:
        return tfm.transformer_defs(cfg)
    if cfg.family == "ssm":
        return _xlstm_defs(cfg)
    if cfg.family == "hybrid":
        return hyb.hybrid_defs(cfg)
    if cfg.family == "granite_hybrid":
        return granite.granite_defs(cfg)
    raise ValueError(cfg.family)


def init_params(cfg: LMConfig, generator: torch.Generator, device) -> Dict:
    """Random weights drawn from ``generator`` (normal with stddev
    ``scale/sqrt(fan_in)``, zeros, ones, as the JAX package's
    ``init_params``), placed on ``device``."""
    return init_from_defs(param_defs(cfg), generator, device)


def abstract_params(cfg: LMConfig) -> Dict:
    """The parameters as meta-device tensors: shapes and dtypes, nothing
    allocated."""
    return abstract_from_defs(param_defs(cfg))


def param_axes(cfg: LMConfig) -> Dict:
    return axes_from_defs(param_defs(cfg))


def forward(cfg: LMConfig, params, tokens, prefix_emb=None, remat=False,
            return_hidden=False):
    if cfg.family in ATTN_FAMILIES:
        return tfm.forward(cfg, params, tokens, prefix_emb, remat,
                           return_hidden)
    if cfg.family == "ssm":
        return _xlstm_forward(cfg, params, tokens, prefix_emb, remat,
                              return_hidden)
    if cfg.family == "hybrid":
        return hyb.forward(cfg, params, tokens, prefix_emb, remat,
                           return_hidden)
    if cfg.family == "granite_hybrid":
        return granite.forward(cfg, params, tokens, prefix_emb, remat,
                               return_hidden)
    raise ValueError(cfg.family)


def unembed_weight(cfg: LMConfig, params):
    return params["embed"].T if cfg.tie_embeddings else params["unembed"]


def prefill(cfg: LMConfig, params, tokens, prefix_emb=None, max_len=None):
    if cfg.family in ATTN_FAMILIES:
        return tfm.prefill(cfg, params, tokens, prefix_emb, max_len)
    if cfg.family == "ssm":
        return _xlstm_prefill(cfg, params, tokens, prefix_emb, max_len)
    if cfg.family == "hybrid":
        return hyb.prefill(cfg, params, tokens, prefix_emb, max_len)
    if cfg.family == "granite_hybrid":
        return granite.prefill(cfg, params, tokens, prefix_emb, max_len)
    raise ValueError(cfg.family)


def decode_step(cfg: LMConfig, params, cache, tokens):
    if cfg.family in ATTN_FAMILIES:
        return tfm.decode_step(cfg, params, cache, tokens)
    if cfg.family == "ssm":
        return _xlstm_decode(cfg, params, cache, tokens)
    if cfg.family == "hybrid":
        return hyb.decode_step(cfg, params, cache, tokens)
    if cfg.family == "granite_hybrid":
        return granite.decode_step(cfg, params, cache, tokens)
    raise ValueError(cfg.family)


def init_cache(cfg: LMConfig, batch: int, max_len: int, device):
    """The zeroed caches on ``device``. On ``torch.device("meta")`` they
    are abstract, the JAX package's ``init_cache(abstract=True)``: shapes
    and dtypes, nothing allocated (the dry run's)."""
    if cfg.family in ATTN_FAMILIES:
        return tfm.init_cache(cfg, batch, max_len, device)
    if cfg.family == "ssm":
        return _xlstm_init_cache(cfg, batch, max_len, device)
    if cfg.family == "hybrid":
        return hyb.init_cache(cfg, batch, max_len, device)
    if cfg.family == "granite_hybrid":
        return granite.init_cache(cfg, batch, max_len, device)
    raise ValueError(cfg.family)


def cache_axes(cfg: LMConfig):
    if cfg.family in ATTN_FAMILIES:
        return tfm.cache_axes(cfg)
    if cfg.family == "ssm":
        return _xlstm_cache_axes(cfg)
    if cfg.family == "hybrid":
        return hyb.cache_axes(cfg)
    if cfg.family == "granite_hybrid":
        return granite.cache_axes(cfg)
    raise ValueError(cfg.family)


#: the kind of each cache leaf the engine counts: attention's K/V, the
#: recurrent states (Mamba-2's and xLSTM's), the Mamba-2 conv windows
CACHE_KINDS = {"k": "kv", "v": "kv", "ak": "kv", "av": "kv",
               "ssm_state": "ssm_state", "tail_state": "ssm_state",
               "conv": "conv", "tail_conv": "conv",
               **{k: "ssm_state" for k in ("mC", "mn", "mm", "sc", "sn",
                                           "sh", "sm")}}


def cache_bytes(cfg: LMConfig, batch: int, max_len: int) -> Dict[str, int]:
    """The bytes of a ``batch``-row cache by kind (``kv``, ``ssm_state``,
    ``conv``; ``pos`` not counted), from the abstract cache: nothing is
    allocated."""
    out = {"kv": 0, "ssm_state": 0, "conv": 0}
    for key, t in init_cache(cfg, batch, max_len,
                             torch.device("meta")).items():
        if key in CACHE_KINDS:
            out[CACHE_KINDS[key]] += t.numel() * t.element_size()
    return out


# ---------------------------------------------------------------------------
# input specs (meta-device stand-ins: nothing is allocated)
# ---------------------------------------------------------------------------

def text_len(cfg: LMConfig, shape: ShapeSuite) -> int:
    return shape.seq_len - cfg.prefix_len


def input_specs(cfg: LMConfig, shape: ShapeSuite) -> Dict:
    """Abstract inputs for one (arch x shape) dry-run cell."""
    B = shape.global_batch
    meta = torch.device("meta")

    def spec(shape_, dtype=torch.int32):
        return torch.empty(shape_, dtype=dtype, device=meta)

    if shape.kind == "train":
        s = text_len(cfg, shape)
        specs = {"tokens": spec((B, s)), "labels": spec((B, s))}
    elif shape.kind == "prefill":
        specs = {"tokens": spec((B, text_len(cfg, shape)))}
    else:  # decode / long_decode: one new token against a seq_len cache
        specs = {"tokens": spec((B, 1)),
                 "cache": init_cache(cfg, B, shape.seq_len, meta)}
    if cfg.prefix_len and shape.kind in ("train", "prefill"):
        specs["prefix_emb"] = spec((B, cfg.prefix_len, cfg.d_model),
                                   cfg.activation_dtype)
    return specs


def input_axes(cfg: LMConfig, shape: ShapeSuite) -> Dict:
    """Logical sharding axes matching :func:`input_specs`."""
    if shape.kind in ("train", "prefill"):
        axes = {"tokens": ("act_batch", "act_seq")}
        if shape.kind == "train":
            axes["labels"] = ("act_batch", "act_seq")
        if cfg.prefix_len:
            axes["prefix_emb"] = ("act_batch", "act_seq", "act_embed")
        return axes
    return {"tokens": ("act_batch", None), "cache": cache_axes(cfg)}
