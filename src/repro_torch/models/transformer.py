"""Decoder-only transformer backbone (dense / vlm / audio / moe families).

Torch counterpart of ``repro.models.transformer``. Parameters keep the JAX
package's pytree: per-layer weights are stacked along a leading ``layers``
axis, and the layer loop indexes them (a view, not a copy). On CUDA the
attention runs the flash-attention kernel in prefill and the flash-decode
kernel in every decode step; nothing here synchronises the host.

``forward`` is the training forward: attention through ``FlashAttentionFn``
(the kernel with its row log-sum-exp on CUDA, and a written-out flash
backward), each block optionally recomputed in the backward (``remat``),
the MoE blocks' aux losses summed over the layers.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import (FlashAttentionFn, attend,
                                          chunked_attention, decode_attention)
from repro_torch.models.layers import (ParamDef, apply_rope, mlp_defs,
                                       checkpointed, mlp_fwd, norm,
                                       norm_defs, residual_add, rope_freqs)
from repro_torch.sharding.partition import (active_mesh, lshard, matmul,
                                           on_shards, place, run_local,
                                           settle)


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
    out = {
        "attn": attn_defs(cfg),
        "attn_norm": norm_defs(cfg.d_model, cfg.norm_type),
        "mlp_norm": norm_defs(cfg.d_model, cfg.norm_type),
    }
    if cfg.moe:
        out["moe"] = moe_lib.moe_defs(cfg)
    else:
        out["mlp"] = mlp_defs(cfg.d_model, cfg.d_ff, cfg.gated_mlp, cfg.dtype)
    return out


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

@functools.lru_cache(maxsize=None)
def _rope(cfg: LMConfig, device: torch.device) -> Tuple[torch.Tensor, int]:
    # built once per (config, device): a host-to-device copy inside a step
    # would synchronise the host with the stream. Never evicted: a captured
    # CUDA graph reads the table at the address it had at capture
    return rope_freqs(cfg.resolved_head_dim, cfg.rope_fraction,
                      cfg.rope_theta, device)


def _project(h: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """h (b, s, d) @ w (d, n, hd) -> (b, s, n, hd)."""
    b, s, d = h.shape
    return (h @ w.reshape(d, -1)).view(b, s, w.shape[1], w.shape[2])


def _heads(h: torch.Tensor, w: torch.Tensor, axis: str) -> torch.Tensor:
    """``_project``; under a mesh per device, column-parallel: the weight
    gathered over ``embed``, its heads as the rules shard ``axis`` (DTensor
    cannot flatten unevenly sharded heads)."""
    return on_shards(_project, (h, w),
                     (("act_batch", "act_seq", None), (None, axis, None)),
                     [("act_batch", "act_seq", axis, None)])


def _qkv(cfg: LMConfig, p: Dict, h: torch.Tensor, positions: torch.Tensor):
    q = _heads(h, p["wq"], "heads")
    k = _heads(h, p["wk"], "kv_heads")
    v = _heads(h, p["wv"], "kv_heads")
    q = lshard(q, "act_batch", "act_seq", "act_heads", None)
    k = lshard(k, "act_batch", "act_seq", "act_kv_heads", None)
    v = lshard(v, "act_batch", "act_seq", "act_kv_heads", None)
    if cfg.pos_emb == "rope":
        inv, rot = _rope(cfg, h.device)
        q = apply_rope(q, positions, inv, rot)
        k = apply_rope(k, positions, inv, rot)
    if cfg.attention_multiplier:
        # the softmax scale is attention_multiplier, and the kernels scale
        # by 1 / sqrt(head_dim): q takes the rest (exact in bf16 where it is
        # a power of two, as Granite's 1/64 · 8 is)
        q = q * (cfg.attention_multiplier * math.sqrt(cfg.resolved_head_dim))
    return q, k, v


def _out_proj(o: torch.Tensor, wo: torch.Tensor) -> torch.Tensor:
    b, s = o.shape[:2]
    return o.reshape(b, s, -1) @ wo.reshape(-1, wo.shape[-1])


def _attn_out(p: Dict, o: torch.Tensor) -> torch.Tensor:
    """o (b, s, h, hd) through the output projection; under a mesh per
    device, row-parallel: a partial sum over the devices of its heads."""
    return on_shards(_out_proj, (o, p["wo"]),
                     (("act_batch", "act_seq", "heads", None),
                      ("heads", None, None)),
                     [("act_batch", "act_seq", None)], partial=("heads",))


def _prefill_attention(cfg: LMConfig, q, k, v) -> torch.Tensor:
    return attend(lambda qg, k, v: chunked_attention(
        qg, k, v, causal=True, q_chunk=cfg.q_chunk, kv_chunk=cfg.kv_chunk,
        block_skip=cfg.causal_block_skip), q, k, v)


def ffn_block_fwd(cfg: LMConfig, p: Dict, x: torch.Tensor,
                  with_aux: bool = False):
    """The FFN sublayer with its residual; with ``with_aux`` also the MoE
    router's Switch loss (0 without MoE), else it is dropped, as the
    reference's prefill and decode_step drop it."""
    h = norm(x, p["mlp_norm"], cfg.norm_type, cfg.norm_eps)
    h = lshard(h, "act_batch", "act_seq", "act_embed")   # bf16 SP boundary
    if cfg.moe:
        y, aux = moe_lib.moe_fwd(cfg, p["moe"], h)
    else:
        y, aux = mlp_fwd(p["mlp"], h, cfg.act, cfg.gated_mlp), None
    if not with_aux:
        return residual_add(cfg, x, y)
    if aux is None:
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return residual_add(cfg, x, y), aux


def attn_block_fwd(cfg: LMConfig, p: Dict, x: torch.Tensor,
                   positions: torch.Tensor) -> torch.Tensor:
    """The attention sublayer with its residual, for training: whether or
    not ``cfg.attn_custom_vjp`` is set (the JAX package's two routes give
    the same gradient), through ``FlashAttentionFn``."""
    h = norm(x, p["attn_norm"], cfg.norm_type, cfg.norm_eps)
    # SP boundary: re-gather the sequence on the bf16 normed tensor, before
    # the projections
    h = lshard(h, "act_batch", "act_seq", "act_embed")
    q, k, v = _qkv(cfg, p["attn"], h, positions)
    o = attend(lambda qg, k, v: FlashAttentionFn.apply(
        qg, k, v, True, cfg.q_chunk, cfg.kv_chunk), q, k, v)
    return residual_add(cfg, x, lshard(_attn_out(p["attn"], o), "act_batch",
                                       "act_res_seq", "act_embed"))


def block_fwd(cfg: LMConfig, p: Dict, x: torch.Tensor,
              positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One training block: (x, the block's aux loss: the MoE router's
    Switch loss, 0 without MoE)."""
    x = attn_block_fwd(cfg, p, x, positions)
    return ffn_block_fwd(cfg, p, x, with_aux=True)


def unbind_layers(blocks: Dict, n: int) -> List[Dict]:
    """The stacked block parameters as ``n`` per-layer dicts, by one
    ``unbind`` per leaf: its backward stacks the layers' gradients in one
    operation, where indexing each layer would add ``n`` zero-padded
    gradients of the whole stack."""
    if isinstance(blocks, dict):
        per = {k: unbind_layers(v, n) for k, v in blocks.items()}
        return [{k: per[k][i] for k in per} for i in range(n)]
    return list(torch.unbind(blocks, 0))


# ---------------------------------------------------------------------------
# embedding / logits
# ---------------------------------------------------------------------------

def embed_tokens(cfg: LMConfig, params: Dict, tokens: torch.Tensor,
                 prefix_emb: Optional[torch.Tensor], pos0: int = 0):
    x = settle(F.embedding(tokens, params["embed"]))
    if prefix_emb is not None:
        x = torch.cat([prefix_emb.to(x.dtype), x], dim=1)
    s = x.shape[1]
    positions = pos0 + torch.arange(s, device=x.device)[None, :]
    if cfg.pos_emb == "learned":
        x = x + params["pos_emb"][pos0:pos0 + s][None]
    x = lshard(x, "act_batch", "act_res_seq", "act_embed")
    return x, positions


def logits_fwd(cfg: LMConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    w = params["embed"].T if cfg.tie_embeddings else params["unembed"]
    return lshard(matmul(x, w), "act_batch", "act_seq", "act_vocab")


# ---------------------------------------------------------------------------
# full forward (train / scoring)
# ---------------------------------------------------------------------------

def forward(cfg: LMConfig, params: Dict, tokens: torch.Tensor,
            prefix_emb: Optional[torch.Tensor] = None, remat: bool = False,
            return_hidden: bool = False) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """Training/scoring forward. Returns (logits|hidden, aux_loss). With
    ``remat`` each block keeps only its input and is recomputed in the
    backward (``jax.checkpoint`` of the block in the JAX package)."""
    x, positions = embed_tokens(cfg, params, tokens, prefix_emb)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for bp in unbind_layers(params["blocks"], cfg.n_layers):
        if remat:
            x, a = checkpointed(block_fwd, cfg, bp, x, positions)
        else:
            x, a = block_fwd(cfg, bp, x, positions)
        aux = aux + a
    x = norm(x, params["final_norm"], cfg.norm_type, cfg.norm_eps)
    if return_hidden:
        return x, aux
    return logits_fwd(cfg, params, x), aux


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


def cache_axes(cfg: LMConfig):
    ax = ("layers", "cache_batch", "cache_seq", "cache_kv_heads", None)
    return {"k": ax, "v": ax, "pos": ("cache_batch",)}


def prefill(cfg: LMConfig, params: Dict, tokens: torch.Tensor,
            prefix_emb: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None):
    """Forward + KV-cache emission. Returns (logits at the last position,
    cache). The cache is allocated at ``max_len`` here, zero past the
    prompt, and later decode steps update it in place."""
    x, positions = embed_tokens(cfg, params, tokens, prefix_emb)
    b, s = x.shape[0], x.shape[1]
    cache = place(lambda: init_cache(cfg, b, max_len or s, x.device),
                  cache_axes(cfg))
    for i in range(cfg.n_layers):
        bp = layer_params(params["blocks"], i)
        h = norm(x, bp["attn_norm"], cfg.norm_type, cfg.norm_eps)
        h = lshard(h, "act_batch", "act_seq", "act_embed")
        q, k, v = _qkv(cfg, bp["attn"], h, positions)
        o = _prefill_attention(cfg, q, k, v)
        x = x + lshard(_attn_out(bp["attn"], o), "act_batch", "act_res_seq",
                       "act_embed")
        x = ffn_block_fwd(cfg, bp, x)
        cache["k"][i, :, :s] = lshard(k, "cache_batch", "cache_seq",
                                      "cache_kv_heads", None)
        cache["v"][i, :, :s] = lshard(v, "cache_batch", "cache_seq",
                                      "cache_kv_heads", None)
    x = norm(x, params["final_norm"], cfg.norm_type, cfg.norm_eps)
    logits = logits_fwd(cfg, params, x[:, -1:, :])
    cache["pos"].fill_(s)
    return logits, cache


def write_rows(cache: torch.Tensor, idx: torch.Tensor,
               new: torch.Tensor) -> None:
    """cache[r, pos[r]] = new[r] in place; idx is pos (b,) expanded to
    new's (b, 1, g, hd). Under a mesh per device on its own block of the
    cache (DTensor cannot scatter into a sequence-sharded cache in place),
    a row outside the block left alone."""
    if active_mesh() is None:
        cache.scatter_(1, idx, new)
        return
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.sharding.rules import local_box
    mesh = active_mesh()
    pl = tuple(cache.placements)
    rows = tuple(p if p in (Shard(0), Shard(2)) else Replicate() for p in pl)
    seq0 = local_box(cache.shape, mesh, pl)[0][1]

    def local(cache, idx, new):
        at = idx - seq0
        inside = (at >= 0) & (at < cache.shape[1])
        at = at.clamp(0, max(cache.shape[1] - 1, 0))
        cache.scatter_(1, at, torch.where(inside, new, cache.gather(1, at)))
        return cache

    run_local(local, (cache, idx, new), (pl, rows, rows), (pl, rows, rows),
              [pl], lambda outs: [cache.shape])


def decode_step(cfg: LMConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor):
    """One decode step. tokens: (b, 1). Returns (logits, cache).

    Unlike the JAX version, which is functional and returns a new cache,
    this writes each row's new K/V into the preallocated cache in place at
    that row's ``pos`` and advances ``pos`` in place; the returned cache is
    the same dict, every leaf the same tensor (a captured CUDA graph of the
    step reads and writes them at their addresses)."""
    b = tokens.shape[0]
    pos = cache["pos"]                                   # (b,) int32
    x = settle(F.embedding(tokens, params["embed"]))     # (b, 1, d)
    if cfg.pos_emb == "learned":
        x = x + F.embedding(pos.long(), params["pos_emb"])[:, None, :]
    x = lshard(x, "act_batch", "act_res_seq", "act_embed")
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
        write_rows(k_cache, idx, k)
        write_rows(v_cache, idx, v)
        k_cache = lshard(k_cache, "cache_batch", "cache_seq",
                         "cache_kv_heads", None)
        v_cache = lshard(v_cache, "cache_batch", "cache_seq",
                         "cache_kv_heads", None)
        o = attend(decode_attention, q, k_cache, v_cache, kv_len)
        x = x + lshard(_attn_out(bp["attn"], o), "act_batch", "act_res_seq",
                       "act_embed")
        x = ffn_block_fwd(cfg, bp, x)
    x = norm(x, params["final_norm"], cfg.norm_type, cfg.norm_eps)
    pos.add_(1)                                          # now kv_len
    return logits_fwd(cfg, params, x), cache
