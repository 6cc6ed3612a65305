"""Decoder-only transformer backbone (dense / vlm / audio families).

Torch counterpart of ``repro.models.transformer``. Parameters keep the JAX
package's pytree: per-layer weights are stacked along a leading ``layers``
axis, and the layer loop indexes them (a view, not a copy). On CUDA the
attention runs the flash-attention kernel in prefill and the flash-decode
kernel in every decode step; nothing here synchronises the host.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.models.attention import (chunked_attention, decode_attention,
                                          group_query_heads, ungroup_heads)
from repro_torch.models.layers import (ParamDef, apply_rope, mlp_defs,
                                       mlp_fwd, norm, norm_defs, rope_freqs)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def attn_defs(cfg: LMConfig) -> Dict[str, ParamDef]:
    d, h, g, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    dt = cfg.dtype
    return {
        "wq": ParamDef((d, h, hd), ("embed", "heads", "head_dim"), dtype=dt),
        "wk": ParamDef((d, g, hd), ("embed", "kv_heads", "head_dim"), dtype=dt),
        "wv": ParamDef((d, g, hd), ("embed", "kv_heads", "head_dim"), dtype=dt),
        "wo": ParamDef((h, hd, d), ("heads", "head_dim", "embed"), dtype=dt),
    }


def block_defs(cfg: LMConfig) -> Dict:
    if cfg.moe:
        raise NotImplementedError(
            "MoE blocks are not ported yet (ROADMAP.md, queue A item 8)")
    return {
        "attn": attn_defs(cfg),
        "attn_norm": norm_defs(cfg.d_model, cfg.norm_type),
        "mlp_norm": norm_defs(cfg.d_model, cfg.norm_type),
        "mlp": mlp_defs(cfg.d_model, cfg.d_ff, cfg.gated_mlp, cfg.dtype),
    }


def stacked(defs, n: int):
    """Stack per-layer ParamDefs along a leading `layers` axis."""
    if isinstance(defs, dict):
        return {k: stacked(v, n) for k, v in defs.items()}
    return ParamDef((n,) + defs.shape, ("layers",) + defs.axes, defs.init,
                    defs.scale, defs.dtype)


def transformer_defs(cfg: LMConfig) -> Dict:
    d = cfg.d_model
    out = {
        "embed": ParamDef((cfg.vocab, d), ("vocab", "embed"), scale=d ** 0.5,
                          dtype=cfg.dtype),
        "blocks": stacked(block_defs(cfg), cfg.n_layers),
        "final_norm": norm_defs(d, cfg.norm_type),
    }
    if not cfg.tie_embeddings:
        out["unembed"] = ParamDef((d, cfg.vocab), ("embed", "vocab"),
                                  dtype=cfg.dtype)
    if cfg.pos_emb == "learned":
        out["pos_emb"] = ParamDef((cfg.max_seq_len, d), ("pos", "embed"),
                                  dtype=cfg.dtype)
    return out


def layer_params(blocks: Dict, i: int) -> Dict:
    """Layer ``i``'s slice of the stacked block parameters (views)."""
    if isinstance(blocks, dict):
        return {k: layer_params(v, i) for k, v in blocks.items()}
    return blocks[i]


# ---------------------------------------------------------------------------
# forward pieces
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=16)
def _rope(cfg: LMConfig, device: torch.device) -> Tuple[torch.Tensor, int]:
    # built once per (config, device): a host-to-device copy inside a step
    # would synchronise the host with the stream
    return rope_freqs(cfg.resolved_head_dim, cfg.rope_fraction,
                      cfg.rope_theta, device)


def _qkv(cfg: LMConfig, p: Dict, h: torch.Tensor, positions: torch.Tensor):
    b, s, d = h.shape
    hd = cfg.resolved_head_dim
    q = (h @ p["wq"].reshape(d, -1)).view(b, s, cfg.n_heads, hd)
    k = (h @ p["wk"].reshape(d, -1)).view(b, s, cfg.n_kv_heads, hd)
    v = (h @ p["wv"].reshape(d, -1)).view(b, s, cfg.n_kv_heads, hd)
    if cfg.pos_emb == "rope":
        inv, rot = _rope(cfg, h.device)
        q = apply_rope(q, positions, inv, rot)
        k = apply_rope(k, positions, inv, rot)
    return q, k, v


def _attn_out(p: Dict, o: torch.Tensor) -> torch.Tensor:
    b, s = o.shape[:2]
    wo = p["wo"]
    return ungroup_heads(o).reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])


def ffn_block_fwd(cfg: LMConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    h = norm(x, p["mlp_norm"], cfg.norm_type, cfg.norm_eps)
    return x + mlp_fwd(p["mlp"], h, cfg.act, cfg.gated_mlp)


# ---------------------------------------------------------------------------
# embedding / logits
# ---------------------------------------------------------------------------

def embed_tokens(cfg: LMConfig, params: Dict, tokens: torch.Tensor,
                 prefix_emb: Optional[torch.Tensor], pos0: int = 0):
    x = F.embedding(tokens, params["embed"])
    if prefix_emb is not None:
        x = torch.cat([prefix_emb.to(x.dtype), x], dim=1)
    s = x.shape[1]
    positions = pos0 + torch.arange(s, device=x.device)[None, :]
    if cfg.pos_emb == "learned":
        x = x + params["pos_emb"][pos0:pos0 + s][None]
    return x, positions


def logits_fwd(cfg: LMConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return x @ w


# ---------------------------------------------------------------------------
# prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device) -> Dict[str, torch.Tensor]:
    g, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (cfg.n_layers, batch, max_len, g, hd)
    dt = cfg.activation_dtype
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": torch.zeros((batch,), dtype=torch.int32, device=device)}


def prefill(cfg: LMConfig, params: Dict, tokens: torch.Tensor,
            prefix_emb: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None):
    """Forward + KV-cache emission. Returns (logits at the last position,
    cache). The cache is allocated at ``max_len`` here, zero past the
    prompt, and later decode steps update it in place."""
    x, positions = embed_tokens(cfg, params, tokens, prefix_emb)
    b, s = x.shape[0], x.shape[1]
    cache = init_cache(cfg, b, max_len or s, x.device)
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        h = norm(x, bp["attn_norm"], cfg.norm_type, cfg.norm_eps)
        q, k, v = _qkv(cfg, bp["attn"], h, positions)
        o = chunked_attention(group_query_heads(q, cfg.n_kv_heads), k, v,
                              causal=True, q_chunk=cfg.q_chunk,
                              kv_chunk=cfg.kv_chunk,
                              block_skip=cfg.causal_block_skip)
        x = x + _attn_out(bp["attn"], o)
        x = ffn_block_fwd(cfg, bp, x)
        cache["k"][i, :, :s] = k
        cache["v"][i, :, :s] = v
    x = norm(x, params["final_norm"], cfg.norm_type, cfg.norm_eps)
    logits = logits_fwd(cfg, params, x[:, -1:, :])
    cache["pos"].fill_(s)
    return logits, cache


def decode_step(cfg: LMConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor):
    """One decode step. tokens: (b, 1). Returns (logits, cache).

    Unlike the JAX version, which is functional and returns a new cache,
    this writes each row's new K/V into the preallocated cache in place at
    that row's ``pos`` and advances ``pos``; the returned cache is the same
    dict."""
    b = tokens.shape[0]
    pos = cache["pos"]                                   # (b,) int32
    x = F.embedding(tokens, params["embed"])             # (b, 1, d)
    if cfg.pos_emb == "learned":
        x = x + params["pos_emb"][pos.long()][:, None, :]
    positions = pos[:, None]
    kv_len = pos + 1
    g, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    # scatter index: row r writes cache[:, r, pos[r]]
    idx = pos.long().view(b, 1, 1, 1).expand(b, 1, g, hd)
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        h = norm(x, bp["attn_norm"], cfg.norm_type, cfg.norm_eps)
        q, k, v = _qkv(cfg, bp["attn"], h, positions)
        k_cache, v_cache = cache["k"][i], cache["v"][i]
        k_cache.scatter_(1, idx, k)
        v_cache.scatter_(1, idx, v)
        o = decode_attention(group_query_heads(q, g), k_cache, v_cache,
                             kv_len)
        x = x + _attn_out(bp["attn"], o)
        x = ffn_block_fwd(cfg, bp, x)
    x = norm(x, params["final_norm"], cfg.norm_type, cfg.norm_eps)
    cache["pos"] = kv_len
    return logits_fwd(cfg, params, x), cache
