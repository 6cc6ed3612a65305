"""Plain PyTorch pieces the family references share: the precision a
reference computes in, the weights' layout and initialisation, norms,
rotary embeddings, causal attention and the gated MLP.

Everything here is written from the published descriptions of the layers
(pre-norm decoder blocks, RoPE, softmax attention, SwiGLU) in float32,
with no kernel, cache or batching, and imports nothing of the program
under test. The weights are laid out as the program takes them (matrices
stored (in, out), per-layer leaves stacked on a leading axis), because
the benchmark makes one set of weights and hands the same tensors to
both sides.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

#: the largest normal float8 e4m3 value
FP8_MAX = 448.0


@dataclass(frozen=True)
class Spec:
    """One weight: its shape, dtype (matrices in the configuration's),
    how it starts (``normal``, ``zeros``
    or ``ones``), and for ``normal`` its stddev's numerator; the
    denominator is the square root of ``fan_in``, the input width of one
    layer's own matrix (not of a stack of layers)."""
    shape: Tuple[int, ...]
    dtype: str = "bfloat16"
    init: str = "normal"
    scale: float = 1.0
    fan_in: int = 1

    @property
    def std(self) -> float:
        return self.scale / math.sqrt(max(self.fan_in, 1))


def stacked(specs, n: int):
    """The specs of ``n`` layers stacked on a leading axis."""
    if isinstance(specs, dict):
        return {k: stacked(v, n) for k, v in specs.items()}
    return Spec((n,) + specs.shape, specs.dtype, specs.init, specs.scale,
                specs.fan_in)


class Precision:
    """How a reference computes its products. ``float32`` multiplies
    float32 operands with TF32 off. ``fp8`` is the control: every product's
    operands are rounded to float8 e4m3 first, each row of the left operand
    and each column of the right one scaled by its own largest magnitude
    (per-token activations, per-channel weights), as fp8 serving does."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "fp8"):
            raise ValueError(f"precision {name!r}: float32 or fp8")
        self.name = name

    def q(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """``x`` in float32, rounded through fp8 along the contraction
        dimension ``dim`` under the control."""
        x = x.float()
        if self.name == "float32":
            return x
        with torch.no_grad():
            amax = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12)
            scale = amax / FP8_MAX
            q = (x / scale).to(torch.float8_e4m3fn).float() * scale
        # the rounded value forward, the gradient passed straight through
        return x + (q - x).detach()

    def mm(self, a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """a (..., k) @ w (k, n)."""
        return self.q(a, -1) @ self.q(w, 0)


def float32_matmuls() -> None:
    """Keep float32 products in float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def rmsnorm(x, w, eps):
    x = x.float()
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w.float()


def layernorm(x, w, b, eps):
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = (x - mu).square().mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * w.float() + b.float()


def norm(cfg: Dict, p: Dict, x):
    if cfg["norm_type"] == "layernorm":
        return layernorm(x, p["scale"], p["bias"], cfg["norm_eps"])
    return rmsnorm(x, p["scale"], cfg["norm_eps"])


def norm_specs(cfg: Dict) -> Dict[str, Spec]:
    d = cfg["d_model"]
    out = {"scale": Spec((d,), "float32", "ones")}
    if cfg["norm_type"] == "layernorm":
        out["bias"] = Spec((d,), "float32", "zeros")
    return out


def head_dim(cfg: Dict) -> int:
    return cfg.get("head_dim") or cfg["d_model"] // cfg["n_heads"]


def rope(cfg: Dict, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Rotary embedding of the first ``rope_fraction`` of each head's dims,
    rotating adjacent pairs (2i, 2i + 1) by pos * theta^(-2i / rot).
    x: (b, s, h, hd); pos: (s,)."""
    hd = x.shape[-1]
    rot = int(hd * cfg["rope_fraction"]) // 2 * 2
    if rot == 0:
        return x
    inv = 1.0 / (cfg["rope_theta"] ** (
        torch.arange(0, rot, 2, dtype=torch.float64) / rot))
    ang = pos.double()[:, None] * inv.to(pos.device)[None, :]     # (s, rot/2)
    cos = torch.cos(ang).float()[None, :, None, :]
    sin = torch.sin(ang).float()[None, :, None, :]
    x1, x2 = x[..., 0:rot:2], x[..., 1:rot:2]
    r = torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return torch.cat([r.flatten(-2), x[..., rot:]], dim=-1)


def attn_specs(cfg: Dict) -> Dict[str, Spec]:
    d, h, g, hd = cfg["d_model"], cfg["n_heads"], cfg["n_kv_heads"], \
        head_dim(cfg)
    dt = cfg["dtype"]
    return {"wq": Spec((d, h, hd), dt, fan_in=d),
            "wk": Spec((d, g, hd), dt, fan_in=d),
            "wv": Spec((d, g, hd), dt, fan_in=d),
            "wo": Spec((h, hd, d), dt, fan_in=h * hd)}


def mlp_specs(cfg: Dict) -> Dict[str, Spec]:
    d, f, dt = cfg["d_model"], cfg["d_ff"], cfg["dtype"]
    return {"wi": Spec((d, f), dt, fan_in=d),
            "wg": Spec((d, f), dt, fan_in=d),
            "wo": Spec((f, d), dt, fan_in=f)}


def attention(cfg: Dict, p: Dict, x, pos, prec: Precision):
    """Causal softmax attention of x (b, s, d) with its own q, k, v; the
    output projection applied."""
    b, s, d = x.shape
    h, g, hd = cfg["n_heads"], cfg["n_kv_heads"], head_dim(cfg)
    q = prec.mm(x, p["wq"].reshape(d, h * hd)).view(b, s, h, hd)
    k = prec.mm(x, p["wk"].reshape(d, g * hd)).view(b, s, g, hd)
    v = prec.mm(x, p["wv"].reshape(d, g * hd)).view(b, s, g, hd)
    q, k = rope(cfg, q, pos), rope(cfg, k, pos)
    k = k.repeat_interleave(h // g, dim=2)
    v = v.repeat_interleave(h // g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", prec.q(q, -1),
                          prec.q(k, -1)) / math.sqrt(hd)
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, -torch.inf), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", prec.q(probs, -1), prec.q(v, 1))
    return prec.mm(o.reshape(b, s, h * hd), p["wo"].reshape(h * hd, d))


def gated_mlp(cfg: Dict, p: Dict, x, prec: Precision):
    """SwiGLU: (act(x Wg) * (x Wi)) Wo."""
    act = {"silu": F.silu,
           "gelu": lambda t: F.gelu(t, approximate="tanh")}[cfg["act"]]
    return prec.mm(act(prec.mm(x, p["wg"])) * prec.mm(x, p["wi"]), p["wo"])


def block(cfg: Dict, p: Dict, x, pos, prec: Precision):
    """A pre-norm decoder block: x + attn(norm(x)), then + mlp(norm(x))."""
    x = x + attention(cfg, p["attn"], norm(cfg, p["attn_norm"], x), pos,
                      prec)
    return x + gated_mlp(cfg, p["mlp"], norm(cfg, p["mlp_norm"], x), prec)


def block_specs(cfg: Dict) -> Dict:
    return {"attn": attn_specs(cfg), "attn_norm": norm_specs(cfg),
            "mlp_norm": norm_specs(cfg), "mlp": mlp_specs(cfg)}


def embed_specs(cfg: Dict) -> Dict[str, Spec]:
    d, v = cfg["d_model"], cfg["vocab"]
    # the embedding's rows have stddev sqrt(d / vocab), the unembedding's
    # columns 1 / sqrt(d): unit-scale logits after the final norm
    return {"embed": Spec((v, d), cfg["dtype"], scale=math.sqrt(d),
                          fan_in=v),
            "unembed": Spec((d, v), cfg["dtype"], fan_in=d)}


def layer(tree: Dict, i) -> Dict:
    """Layer ``i`` of a stacked tree."""
    if isinstance(tree, dict):
        return {k: layer(v, i) for k, v in tree.items()}
    return tree[i]


def logits(cfg: Dict, params: Dict, x, prec: Precision):
    return prec.mm(norm(cfg, params["final_norm"], x), params["unembed"])
