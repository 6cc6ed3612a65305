"""Mixture-of-Experts FFN with capacity-based gather/scatter dispatch.

Torch counterpart of ``repro.models.moe``. Per dispatch group and expert
the top-C tokens by routing priority are gathered, the experts run as
three batched products over (E, G·C, d), and the results are scattered
back. Tokens routed beyond an expert's capacity are dropped (GShard /
Switch semantics); slots an expert fills with unrouted tokens carry a zero
gate. A Switch-style load-balancing auxiliary loss is returned. The JAX
package's ``lshard`` annotations have no counterpart: without a mesh they
are the identity.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models.layers import ParamDef, act_fn


def moe_defs(cfg: LMConfig) -> Dict[str, ParamDef]:
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    dt = cfg.dtype
    out = {
        "router": ParamDef((d, e), ("embed", "experts"), dtype="float32"),
        "wi": ParamDef((e, d, ff), ("experts", "embed", "mlp"), dtype=dt),
        "wo": ParamDef((e, ff, d), ("experts", "mlp", "embed"), dtype=dt),
    }
    if cfg.gated_mlp:
        out["wg"] = ParamDef((e, d, ff), ("experts", "embed", "mlp"), dtype=dt)
    return out


def expert_capacity(cfg: LMConfig, n_tokens: int) -> int:
    m = cfg.moe
    cap = int(n_tokens * m.top_k / m.num_experts * m.capacity_factor)
    cap = max(cap, 8)
    # round up to a multiple of 8 for clean tiling
    return min(n_tokens, (cap + 7) // 8 * 8)


def _route(cfg: LMConfig, p: Dict, xf: torch.Tensor):
    """Router in fp32: (probs (T, E), renormalised top-k gates (T, k),
    their experts (T, k))."""
    probs = torch.softmax(xf.float() @ p["router"], dim=-1)
    top_p, top_idx = torch.topk(probs, cfg.moe.top_k, dim=-1)
    top_p = top_p / top_p.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, top_p, top_idx


def _aux_loss(cfg: LMConfig, probs: torch.Tensor,
              routed: torch.Tensor) -> torch.Tensor:
    """Switch aux loss: E * sum_e f_e * P_e (f = token fraction routed to
    e, P = mean router probability of e)."""
    m = cfg.moe
    f = routed.mean(0) / m.top_k * m.num_experts
    return m.num_experts * (f * probs.mean(0)).sum() * m.aux_loss_weight


def _experts(cfg: LMConfig, p: Dict, x_e: torch.Tensor) -> torch.Tensor:
    """x_e (E, n, d) -> (E, n, d): each expert's MLP, batched over E."""
    h = torch.bmm(x_e, p["wi"])
    if cfg.gated_mlp:
        h = act_fn(cfg.act)(torch.bmm(x_e, p["wg"])) * h
    else:
        h = act_fn(cfg.act)(h)
    return torch.bmm(h, p["wo"])


def _capacity(cfg: LMConfig, prio: torch.Tensor):
    """Capacity selection from the priorities ``prio`` (T, E): G dispatch
    groups of T/G tokens, capacity C/G per (group, expert). Returns the
    gates and the tokens each expert takes, expert-major (E, G·Cg), so
    that each weight is one batched product over experts. Ties between
    zero priorities may pick other tokens than jax.lax.top_k does, and
    those slots carry a zero gate."""
    T, E = prio.shape
    G = max(1, min(cfg.moe.dispatch_groups, T))
    Cg = max(1, expert_capacity(cfg, T) // G)
    gates, tok = torch.topk(prio.view(G, T // G, E).transpose(1, 2), Cg,
                            dim=-1)                              # (G, E, Cg)
    tok = tok + (torch.arange(G, device=prio.device) * (T // G))[:, None, None]
    return (gates.transpose(0, 1).reshape(E, G * Cg),
            tok.transpose(0, 1).reshape(E, G * Cg))


def moe_fwd(cfg: LMConfig, p: Dict, x: torch.Tensor) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d) -> (out (b, s, d), aux_loss scalar)."""
    m = cfg.moe
    b, s, d = x.shape
    T, E, k = b * s, m.num_experts, m.top_k
    xf = x.reshape(T, d)
    probs, top_p, top_idx = _route(cfg, p, xf)

    # dense routing-priority matrix: prio[t, e] = renormalised gate if
    # expert e is in token t's top-k, else 0
    prio = torch.zeros(T, E, dtype=torch.float32, device=x.device) \
        .scatter_(1, top_idx, top_p)
    gates, tok = _capacity(cfg, prio)
    y_e = _experts(cfg, p, xf[tok])                              # (E, G·Cg, d)

    # combine in fp32, cast once. Each picked (token, expert) pair owns the
    # row t·k + j of the buffer (j: the expert's place in the token's
    # top-k), so no two writes meet on a kept row and the k rows of a
    # token are summed in a fixed order: the same bits on every run, where
    # a bf16 index_add_ over tokens would race on the card's atomics.
    # Slots holding a token the expert was not picked by (zero gate) all
    # go to one extra row, which is dropped.
    slot = torch.full((T, E), T * k, dtype=torch.long, device=x.device)
    slot.scatter_(1, top_idx, torch.arange(T * k, device=x.device).view(T, k))
    dest = slot[tok, torch.arange(E, device=x.device)[:, None]]  # (E, G·Cg)
    buf = torch.zeros(T * k + 1, d, dtype=torch.float32, device=x.device)
    buf.index_add_(0, dest.reshape(-1),
                   (y_e.float() * gates[..., None]).reshape(-1, d))
    out = buf[:T * k].view(T, k, d).sum(1)
    aux = _aux_loss(cfg, probs, (prio > 0).float())
    return out.reshape(b, s, d).to(x.dtype), aux


def moe_fwd_reference(cfg: LMConfig, p: Dict, x: torch.Tensor) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """Loop-over-experts dense oracle (no capacity drops), for tests."""
    m = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(-1, d)
    probs, top_p, top_idx = _route(cfg, p, xf)
    out = torch.zeros(xf.shape, dtype=torch.float32, device=x.device)
    for e in range(m.num_experts):
        w = torch.where(top_idx == e, top_p, 0.0).sum(-1)        # (T,)
        y = _experts(cfg, {k: v[e:e + 1] for k, v in p.items()
                           if k != "router"}, xf[None])[0]
        out = out + y.float() * w[:, None]
    routed = torch.zeros(xf.shape[0], m.num_experts, device=x.device) \
        .scatter_(1, top_idx, 1.0)
    aux = _aux_loss(cfg, probs, routed)
    return out.reshape(b, s, d).to(x.dtype), aux
