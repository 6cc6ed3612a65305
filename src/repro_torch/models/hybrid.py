"""Zamba2-style hybrid backbone: Mamba-2 blocks + one parameter-shared
attention(+MLP) block applied every ``attn_every`` SSM blocks. Torch
counterpart of ``repro.models.hybrid``: the training forward, prefill and
decode.

Layer layout for n_layers=38, attn_every=6:
  6 groups of [6 mamba blocks -> shared attn block] + 2 tail mamba blocks.
The shared block's *weights* are reused across applications (Zamba weight
sharing); each application has its own KV-cache entries. The cache is
allocated at ``max_len`` in prefill and updated in place by every decode
step (the JAX version pads the K/V and returns a new cache). On CUDA the
Mamba-2 prefill runs the SSD-scan kernel, the shared attention the
flash-attention kernel in prefill and the flash-decode kernel in decode;
training runs the SSD-scan kernel through ``ssm.SSDScanFn`` and the
flash-attention kernel through ``FlashAttentionFn``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import attend, decode_attention
from repro_torch.models.layers import (ParamDef, checkpointed, norm,
                                       norm_defs)
from repro_torch.models.ssm import (mamba2_block_fwd, mamba2_decode_step,
                                    mamba2_defs, mamba2_dims)
from repro_torch.sharding.partition import lshard, place, settle


def hybrid_layout(cfg: LMConfig) -> Tuple[int, int, int]:
    k = cfg.hybrid.attn_every
    n_groups = cfg.n_layers // k
    tail = cfg.n_layers - n_groups * k
    return n_groups, k, tail


def hybrid_defs(cfg: LMConfig) -> Dict:
    n_groups, k, tail = hybrid_layout(cfg)
    blk = mamba2_defs(cfg)
    out = {
        "embed": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "embed"),
                          scale=cfg.d_model ** 0.5, dtype=cfg.dtype),
        "groups": tfm.stacked(tfm.stacked(blk, k), n_groups),
        "shared_attn": tfm.block_defs(cfg),
        "final_norm": norm_defs(cfg.d_model, cfg.norm_type),
        "unembed": ParamDef((cfg.d_model, cfg.vocab), ("embed", "vocab"),
                            dtype=cfg.dtype),
    }
    if tail:
        out["tail"] = tfm.stacked(blk, tail)
    return out


def _group_fwd(cfg: LMConfig, gp: Dict, shared: Dict, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    """One group: its Mamba-2 blocks (``gp``'s leaves stacked over them),
    then the shared attention block and the shared MLP."""
    for bp in tfm.unbind_layers(gp, cfg.hybrid.attn_every):
        x = mamba2_block_fwd(cfg, bp, x)
    x = tfm.attn_block_fwd(cfg, shared, x, positions)
    return tfm.ffn_block_fwd(cfg, shared, x)


def forward(cfg: LMConfig, params: Dict, tokens: torch.Tensor,
            prefix_emb: Optional[torch.Tensor] = None, remat: bool = False,
            return_hidden: bool = False):
    """The training forward: the groups in order, each recomputed in the
    backward with ``remat`` (``jax.checkpoint`` of the group in the JAX
    package), then the tail blocks, which are not, then the final norm.
    Returns (logits|hidden, aux = 0). The shared block's weights are used
    once a group, so their gradient sums over the groups."""
    x, positions = tfm.embed_tokens(cfg, params, tokens, prefix_emb)
    n_groups, _, tail = hybrid_layout(cfg)
    shared = params["shared_attn"]
    for gp in tfm.unbind_layers(params["groups"], n_groups):
        if remat:
            x = checkpointed(_group_fwd, cfg, gp, shared, x, positions)
        else:
            x = _group_fwd(cfg, gp, shared, x, positions)
    if tail:
        for bp in tfm.unbind_layers(params["tail"], tail):
            x = mamba2_block_fwd(cfg, bp, x)
    x = norm(x, params["final_norm"], cfg.norm_type, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    return tfm.logits_fwd(cfg, params, x), aux


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device) -> Dict[str, torch.Tensor]:
    n_groups, k, tail = hybrid_layout(cfg)
    s = cfg.ssm
    _, nh, conv_dim = mamba2_dims(cfg)
    g, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    dt = cfg.activation_dtype

    def mk(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    cache = {
        "ssm_state": mk((n_groups, k, batch, nh, s.head_dim, s.d_state),
                        torch.float32),
        "conv": mk((n_groups, k, batch, s.d_conv - 1, conv_dim), dt),
        "ak": mk((n_groups, batch, max_len, g, hd), dt),
        "av": mk((n_groups, batch, max_len, g, hd), dt),
        "pos": mk((batch,), torch.int32),
    }
    if tail:
        cache["tail_state"] = mk((tail, batch, nh, s.head_dim, s.d_state),
                                 torch.float32)
        cache["tail_conv"] = mk((tail, batch, s.d_conv - 1, conv_dim), dt)
    return cache


def cache_axes(cfg: LMConfig):
    n_groups, k, tail = hybrid_layout(cfg)
    ax = {
        "ssm_state": (None, None, "cache_batch", "ssm_heads", None, None),
        "conv": (None, None, "cache_batch", None, "conv_dim"),
        "ak": (None, "cache_batch", "cache_seq", "cache_kv_heads", None),
        "av": (None, "cache_batch", "cache_seq", "cache_kv_heads", None),
        "pos": ("cache_batch",),
    }
    if tail:
        ax["tail_state"] = (None, "cache_batch", "ssm_heads", None, None)
        ax["tail_conv"] = (None, "cache_batch", None, "conv_dim")
    return ax


def _shared_attn_prefill(cfg: LMConfig, bp: Dict, x: torch.Tensor,
                         positions: torch.Tensor):
    h = norm(x, bp["attn_norm"], cfg.norm_type, cfg.norm_eps)
    h = lshard(h, "act_batch", "act_seq", "act_embed")
    q, k, v = tfm._qkv(cfg, bp["attn"], h, positions)
    o = tfm._prefill_attention(cfg, q, k, v)
    x = x + lshard(tfm._attn_out(bp["attn"], o), "act_batch", "act_res_seq",
                   "act_embed")
    return tfm.ffn_block_fwd(cfg, bp, x), k, v


def prefill(cfg: LMConfig, params: Dict, tokens: torch.Tensor,
            prefix_emb: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None):
    """Forward + cache emission. Returns (logits at the last position,
    cache); the shared block's K/V go into a cache allocated at
    ``max_len``, zero past the prompt."""
    x, positions = tfm.embed_tokens(cfg, params, tokens, prefix_emb)
    b, s = x.shape[0], x.shape[1]
    n_groups, k, tail = hybrid_layout(cfg)
    cache = place(lambda: init_cache(cfg, b, max_len or s, x.device),
                  cache_axes(cfg))
    for gi in range(n_groups):
        gp = tfm.layer_params(params["groups"], gi)
        for li in range(k):
            x, (st, cb) = mamba2_block_fwd(cfg, tfm.layer_params(gp, li), x,
                                           return_state=True)
            cache["ssm_state"][gi, li] = st
            cache["conv"][gi, li] = cb
        x, kk, vv = _shared_attn_prefill(cfg, params["shared_attn"], x,
                                         positions)
        cache["ak"][gi, :, :s] = kk
        cache["av"][gi, :, :s] = vv
    for ti in range(tail):
        x, (st, cb) = mamba2_block_fwd(
            cfg, tfm.layer_params(params["tail"], ti), x, return_state=True)
        cache["tail_state"][ti] = st
        cache["tail_conv"][ti] = cb
    x = norm(x, params["final_norm"], cfg.norm_type, cfg.norm_eps)
    cache["pos"].fill_(s)
    return tfm.logits_fwd(cfg, params, x[:, -1:, :]), cache


def decode_step(cfg: LMConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor):
    """One decode step. tokens: (b, 1). Returns (logits, cache): the same
    dict, its SSM states, conv windows and each application's K/V row at
    ``pos`` updated in place, and ``pos`` advanced in place."""
    b = tokens.shape[0]
    pos = cache["pos"]                                   # (b,) int32
    x = settle(F.embedding(tokens, params["embed"]))     # (b, 1, d)
    x = lshard(x, "act_batch", "act_res_seq", "act_embed")
    positions = pos[:, None]
    kv_len = pos + 1
    n_groups, k, tail = hybrid_layout(cfg)
    g, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    # scatter index: row r writes cache[..., r, pos[r]]
    idx = pos.long().view(b, 1, 1, 1).expand(b, 1, g, hd)
    bp = params["shared_attn"]
    for gi in range(n_groups):
        gp = tfm.layer_params(params["groups"], gi)
        for li in range(k):
            x, _, _ = mamba2_decode_step(cfg, tfm.layer_params(gp, li), x,
                                         cache["ssm_state"][gi, li],
                                         cache["conv"][gi, li])
        h = norm(x, bp["attn_norm"], cfg.norm_type, cfg.norm_eps)
        q, kk, vv = tfm._qkv(cfg, bp["attn"], h, positions)
        k_cache, v_cache = cache["ak"][gi], cache["av"][gi]
        tfm.write_rows(k_cache, idx, kk)
        tfm.write_rows(v_cache, idx, vv)
        k_cache = lshard(k_cache, "cache_batch", "cache_seq",
                         "cache_kv_heads", None)
        v_cache = lshard(v_cache, "cache_batch", "cache_seq",
                         "cache_kv_heads", None)
        o = attend(decode_attention, q, k_cache, v_cache, kv_len)
        x = x + tfm._attn_out(bp["attn"], o)
        x = tfm.ffn_block_fwd(cfg, bp, x)
    for ti in range(tail):
        x, _, _ = mamba2_decode_step(cfg, tfm.layer_params(params["tail"], ti),
                                     x, cache["tail_state"][ti],
                                     cache["tail_conv"][ti])
    x = norm(x, params["final_norm"], cfg.norm_type, cfg.norm_eps)
    pos.add_(1)                                          # now kv_len
    return tfm.logits_fwd(cfg, params, x), cache
