"""Granite-4.0-H-style hybrid (family ``granite_hybrid``): a pattern of
layers, each a mixer, Mamba-2 or GQA attention (the attention layers are
``cfg.hybrid.attn_layers``), followed by the layer's own gated MLP. Every
layer has its own weights; muP multipliers scale the embedding, each
mixer's and each MLP's output, the softmax and the logits:

    x = embed(tokens) * embedding_multiplier
    each layer: x = x + m * mixer(norm(x)); x = x + m * mlp(norm(x)),
                m = residual_multiplier
    logits = (norm(x) / logits_scaling) @ embed^T

Attention has no positional encoding (``pos_emb`` "none") and a softmax
scale of ``attention_multiplier``, folded into q (``transformer._qkv``).
The logits' divisor is applied to the final hidden state, which the
training loss reads too: where it is a power of two (Granite's 8) that is
the logits divided exactly.

The weights are stacked by kind, each stack in layer order: ``mamba``
({"mixer": the Mamba-2 block's weights with its pre-norm, "mlp_norm",
"mlp"}) and ``attn`` (the dense transformer's block). The cache holds both
kinds of state side by side: each Mamba-2 layer's fp32 state and conv
window (``ssm_state``, ``conv``), each attention layer's K/V at ``max_len``
(``k``, ``v``), and ``pos``. On CUDA prefill runs the SSD-scan kernel in
each Mamba-2 layer and the flash-attention kernel in each attention
layer; decode runs the one-token recurrence and the flash-decode kernel,
updating the cache in place; training runs ``ssm.SSDScanFn`` and
``FlashAttentionFn``, each layer recomputed in the backward with
``remat``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.models import transformer as tfm
from repro_torch.models.attention import attend, decode_attention
from repro_torch.models.layers import (ParamDef, checkpointed, mlp_defs,
                                       norm, norm_defs, residual_add)
from repro_torch.models.ssm import (mamba2_block_fwd, mamba2_decode_step,
                                    mamba2_defs, mamba2_dims)
from repro_torch.sharding.partition import lshard, place, settle


def layout(cfg: LMConfig) -> List[Tuple[str, int]]:
    """Each layer's kind (``"mamba"`` or ``"attn"``) and its index in that
    kind's stack, in layer order."""
    attn = set(cfg.hybrid.attn_layers)
    seen = {"mamba": 0, "attn": 0}
    out = []
    for i in range(cfg.n_layers):
        kind = "attn" if i in attn else "mamba"
        out.append((kind, seen[kind]))
        seen[kind] += 1
    return out


def counts(cfg: LMConfig) -> Tuple[int, int]:
    """(Mamba-2 layers, attention layers)."""
    n_attn = len(cfg.hybrid.attn_layers)
    return cfg.n_layers - n_attn, n_attn


def granite_defs(cfg: LMConfig) -> Dict:
    d = cfg.d_model
    n_mamba, n_attn = counts(cfg)
    out = {"embed": ParamDef((cfg.vocab, d), ("vocab", "embed"),
                             scale=d ** 0.5, dtype=cfg.dtype)}
    if n_mamba:
        out["mamba"] = tfm.stacked({
            "mixer": mamba2_defs(cfg),
            "mlp_norm": norm_defs(d, cfg.norm_type),
            "mlp": mlp_defs(d, cfg.d_ff, cfg.gated_mlp, cfg.dtype)}, n_mamba)
    if n_attn:
        out["attn"] = tfm.stacked(tfm.block_defs(cfg), n_attn)
    out["final_norm"] = norm_defs(d, cfg.norm_type)
    if not cfg.tie_embeddings:
        out["unembed"] = ParamDef((d, cfg.vocab), ("embed", "vocab"),
                                  dtype=cfg.dtype)
    return out


def _scaled(cfg: LMConfig, x: torch.Tensor) -> torch.Tensor:
    m = cfg.embedding_multiplier
    return x if m == 1.0 else x * m


def _final(cfg: LMConfig, params: Dict, x: torch.Tensor) -> torch.Tensor:
    """The final norm, divided by ``logits_scaling``: what the unembedding
    reads."""
    x = norm(x, params["final_norm"], cfg.norm_type, cfg.norm_eps)
    return x if cfg.logits_scaling == 1.0 else x / cfg.logits_scaling


def _mamba_layer(cfg: LMConfig, p: Dict, x: torch.Tensor) -> torch.Tensor:
    return tfm.ffn_block_fwd(cfg, p, mamba2_block_fwd(cfg, p["mixer"], x))


def _attn_layer(cfg: LMConfig, p: Dict, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    return tfm.ffn_block_fwd(cfg, p, tfm.attn_block_fwd(cfg, p, x,
                                                        positions))


def forward(cfg: LMConfig, params: Dict, tokens: torch.Tensor,
            prefix_emb: Optional[torch.Tensor] = None, remat: bool = False,
            return_hidden: bool = False):
    """The training forward: the layers in order, each recomputed in the
    backward with ``remat``, then the final norm. Returns (logits|hidden,
    aux = 0)."""
    x, positions = tfm.embed_tokens(cfg, params, tokens, prefix_emb)
    x = _scaled(cfg, x)
    n_mamba, n_attn = counts(cfg)
    stacks = {"mamba": tfm.unbind_layers(params["mamba"], n_mamba)
              if n_mamba else [],
              "attn": tfm.unbind_layers(params["attn"], n_attn)
              if n_attn else []}
    for kind, i in layout(cfg):
        p = stacks[kind][i]
        args = (cfg, p, x) if kind == "mamba" else (cfg, p, x, positions)
        fn = _mamba_layer if kind == "mamba" else _attn_layer
        x = checkpointed(fn, *args) if remat else fn(*args)
    x = _final(cfg, params, x)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_hidden:
        return x, aux
    return tfm.logits_fwd(cfg, params, x), aux


def init_cache(cfg: LMConfig, batch: int, max_len: int,
               device) -> Dict[str, torch.Tensor]:
    n_mamba, n_attn = counts(cfg)
    s = cfg.ssm
    _, nh, conv_dim = mamba2_dims(cfg)
    g, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    dt = cfg.activation_dtype

    def mk(shape, dtype):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "ssm_state": mk((n_mamba, batch, nh, s.head_dim, s.d_state),
                        torch.float32),
        "conv": mk((n_mamba, batch, s.d_conv - 1, conv_dim), dt),
        "k": mk((n_attn, batch, max_len, g, hd), dt),
        "v": mk((n_attn, batch, max_len, g, hd), dt),
        "pos": mk((batch,), torch.int32),
    }


def cache_axes(cfg: LMConfig):
    kv = ("layers", "cache_batch", "cache_seq", "cache_kv_heads", None)
    return {"ssm_state": (None, "cache_batch", "ssm_heads", None, None),
            "conv": (None, "cache_batch", None, "conv_dim"),
            "k": kv, "v": kv, "pos": ("cache_batch",)}


def _attn_out(cfg: LMConfig, p: Dict, x: torch.Tensor,
              o: torch.Tensor) -> torch.Tensor:
    return residual_add(cfg, x, lshard(tfm._attn_out(p["attn"], o),
                                       "act_batch", "act_res_seq",
                                       "act_embed"))


def prefill(cfg: LMConfig, params: Dict, tokens: torch.Tensor,
            prefix_emb: Optional[torch.Tensor] = None,
            max_len: Optional[int] = None):
    """Forward + cache emission. Returns (logits at the last position,
    cache); the K/V go into a cache allocated at ``max_len``, zero past
    the prompt."""
    x, positions = tfm.embed_tokens(cfg, params, tokens, prefix_emb)
    x = _scaled(cfg, x)
    b, s = x.shape[0], x.shape[1]
    cache = place(lambda: init_cache(cfg, b, max_len or s, x.device),
                  cache_axes(cfg))
    for kind, i in layout(cfg):
        p = tfm.layer_params(params[kind], i)
        if kind == "mamba":
            x, (st, cb) = mamba2_block_fwd(cfg, p["mixer"], x,
                                           return_state=True)
            cache["ssm_state"][i] = st
            cache["conv"][i] = cb
        else:
            h = norm(x, p["attn_norm"], cfg.norm_type, cfg.norm_eps)
            h = lshard(h, "act_batch", "act_seq", "act_embed")
            q, k, v = tfm._qkv(cfg, p["attn"], h, positions)
            x = _attn_out(cfg, p, x, tfm._prefill_attention(cfg, q, k, v))
            cache["k"][i, :, :s] = lshard(k, "cache_batch", "cache_seq",
                                          "cache_kv_heads", None)
            cache["v"][i, :, :s] = lshard(v, "cache_batch", "cache_seq",
                                          "cache_kv_heads", None)
        x = tfm.ffn_block_fwd(cfg, p, x)
    cache["pos"].fill_(s)
    return tfm.logits_fwd(cfg, params, _final(cfg, params, x[:, -1:, :])), \
        cache


def decode_step(cfg: LMConfig, params: Dict, cache: Dict,
                tokens: torch.Tensor):
    """One decode step. tokens: (b, 1). Returns (logits, cache): the same
    dict, each Mamba-2 layer's state and conv window and each attention
    layer's K/V row at ``pos`` updated in place, and ``pos`` advanced in
    place."""
    b = tokens.shape[0]
    pos = cache["pos"]                                   # (b,) int32
    x = _scaled(cfg, settle(F.embedding(tokens, params["embed"])))
    x = lshard(x, "act_batch", "act_res_seq", "act_embed")
    positions = pos[:, None]
    kv_len = pos + 1
    g, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    # scatter index: row r writes cache[i, r, pos[r]]
    idx = pos.long().view(b, 1, 1, 1).expand(b, 1, g, hd)
    for kind, i in layout(cfg):
        p = tfm.layer_params(params[kind], i)
        if kind == "mamba":
            x, _, _ = mamba2_decode_step(cfg, p["mixer"], x,
                                         cache["ssm_state"][i],
                                         cache["conv"][i])
        else:
            h = norm(x, p["attn_norm"], cfg.norm_type, cfg.norm_eps)
            q, k, v = tfm._qkv(cfg, p["attn"], h, positions)
            k_cache, v_cache = cache["k"][i], cache["v"][i]
            tfm.write_rows(k_cache, idx, k)
            tfm.write_rows(v_cache, idx, v)
            k_cache = lshard(k_cache, "cache_batch", "cache_seq",
                             "cache_kv_heads", None)
            v_cache = lshard(v_cache, "cache_batch", "cache_seq",
                             "cache_kv_heads", None)
            x = _attn_out(cfg, p, x, attend(decode_attention, q, k_cache,
                                            v_cache, kv_len))
        x = tfm.ffn_block_fwd(cfg, p, x)
    pos.add_(1)                                          # now kv_len
    return tfm.logits_fwd(cfg, params, _final(cfg, params, x)), cache
