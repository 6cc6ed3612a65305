"""The dense decoder-only transformer in plain PyTorch: token embedding,
``n_layers`` pre-norm blocks (softmax attention with partial RoPE, gated
MLP), a final norm and an untied unembedding (StableLM 2's layout, without
its q/k/v biases, which the program under test does not have).

``forward`` gives float32 logits at every position of ``tokens``; the
weights it reads are the benchmark's, upcast, never the program's.
"""
from __future__ import annotations

from typing import Dict

import torch

from gpubench.reference import layers as L


def param_specs(cfg: Dict) -> Dict:
    out = L.embed_specs(cfg)
    out["blocks"] = L.stacked(L.block_specs(cfg), cfg["n_layers"])
    out["final_norm"] = L.norm_specs(cfg)
    return out


def forward(cfg: Dict, params: Dict, tokens: torch.Tensor,
            prec: L.Precision, remat: bool = False,
            keep_from: int = 0) -> torch.Tensor:
    """tokens (b, s) int -> logits (b, s - keep_from, vocab) float32, at
    the positions from ``keep_from`` on. With ``remat``
    each block's activations are recomputed in the backward."""
    x = params["embed"].float()[tokens.long()]
    pos = torch.arange(tokens.shape[1], device=tokens.device)
    for i in range(cfg["n_layers"]):
        p = L.layer(params["blocks"], i)
        if remat:
            x = torch.utils.checkpoint.checkpoint(
                L.block, cfg, p, x, pos, prec, use_reentrant=False)
        else:
            x = L.block(cfg, p, x, pos, prec)
    return L.logits(cfg, params, x[:, keep_from:], prec)
