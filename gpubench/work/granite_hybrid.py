"""The Granite 4.0-H hybrid's work, counted from its configuration's
widths: model FLOPs, and the hand-written kernels' launches with each
launch's operations and bytes.

``serve_*`` count one chunk of the serving engine: a prefill of ``b``
prompts of ``prompt`` tokens (K1 once an attention layer, K3 once a
Mamba-2 layer; logits at the last position only), then ``decode - 1``
steps of one token each (K2 once an attention layer against the cache,
whose rows ``pos + 1`` every row reads; the Mamba-2 layers' one-token
recurrence runs no hand-written kernel).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from gpubench import cost


def _dims(cfg: Dict):
    s = cfg["ssm"]
    di = s["expand"] * cfg["d_model"]
    nh = di // s["head_dim"]
    gn = s["n_groups"] * s["d_state"]
    return di, nh, gn, di + 2 * gn


def _counts(cfg: Dict) -> Tuple[int, int]:
    n_attn = len(cfg["hybrid"]["attn_layers"])
    return cfg["n_layers"] - n_attn, n_attn


def _attn_dims(cfg: Dict):
    d, h, g = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"]
    return d, h, g, cfg.get("head_dim") or d // h


def mlp_flops(cfg: Dict, tokens: int) -> int:
    return 2 * tokens * 3 * cfg["d_model"] * cfg["d_ff"]


def mamba_flops(cfg: Dict, b: int, n: int, scan: bool) -> int:
    """One Mamba-2 mixer over ``n`` new positions of ``b`` rows: its
    projections and conv, and the scan (chunked over a prompt with
    ``scan``, else the one-token recurrence: the state's write and
    read-out, 4 P N a head)."""
    s, d = cfg["ssm"], cfg["d_model"]
    di, nh, gn, conv_dim = _dims(cfg)
    t = b * n
    total = 2 * t * d * (2 * di + 2 * gn + nh) + 2 * t * di * d \
        + 2 * t * conv_dim * s["d_conv"]
    if scan:
        total += cost.ssd_flops(b, n, nh, s["head_dim"], s["d_state"],
                                s["chunk_size"])
    else:
        total += 4 * t * nh * s["head_dim"] * s["d_state"]
    return total


def attn_flops(cfg: Dict, b: int, n: int, q_offset: int) -> int:
    d, h, g, hd = _attn_dims(cfg)
    weights = d * h * hd + 2 * d * g * hd + h * hd * d
    return 2 * b * n * weights + cost.attention_flops(
        b, n, q_offset + n, h, hd, True, q_offset)


def forward_flops(cfg: Dict, b: int, n: int, q_offset: int,
                  logit_rows: int) -> int:
    """Every layer over ``n`` new positions of ``b`` rows that follow
    ``q_offset`` earlier ones, and the logits of ``logit_rows`` rows."""
    n_mamba, n_attn = _counts(cfg)
    return n_mamba * mamba_flops(cfg, b, n, scan=n > 1) \
        + n_attn * attn_flops(cfg, b, n, q_offset) \
        + cfg["n_layers"] * mlp_flops(cfg, b * n) \
        + 2 * logit_rows * cfg["d_model"] * cfg["vocab"]


def serve_flops(cfg: Dict, b: int, prompt: int, decode: int) -> int:
    total = forward_flops(cfg, b, prompt, 0, b)
    for j in range(decode - 1):
        total += forward_flops(cfg, b, 1, prompt + j, b)
    return total


def _k3(cfg: Dict, b: int, n: int) -> Tuple[int, int]:
    s = cfg["ssm"]
    _, nh, _, _ = _dims(cfg)
    return (cost.ssd_flops(b, n, nh, s["head_dim"], s["d_state"],
                           s["chunk_size"]),
            cost.ssd_bytes(b, n, nh, s["head_dim"], s["n_groups"],
                           s["d_state"], False))


def serve_kernels(cfg: Dict, b: int, prompt: int, decode: int) \
        -> Dict[str, List[Tuple[int, int]]]:
    d, h, g, hd = _attn_dims(cfg)
    n_mamba, n_attn = _counts(cfg)
    k1 = [(cost.attention_flops(b, prompt, prompt, h, hd),
           cost.attention_bytes(b, prompt, prompt, h, g, hd))] * n_attn
    k2 = []
    for j in range(decode - 1):
        rows = b * (prompt + j + 1)
        k2 += [(cost.decode_flops(rows, h, hd),
                cost.decode_bytes(b, h, g, hd, rows))] * n_attn
    return {"k1": k1, "k2": k2, "k3": [_k3(cfg, b, prompt)] * n_mamba}

