"""Granite 4.0-H (``granitemoehybrid`` without experts) in plain PyTorch:
a pattern of layers, each a mixer, Mamba-2 or grouped-query attention,
then the layer's own SwiGLU MLP, with the muP multipliers of the
published configuration:

    x = embed(tokens) * embedding_multiplier
    each layer: x = x + m * mixer(rmsnorm(x)); x = x + m * mlp(rmsnorm(x)),
                m = residual_multiplier
    logits = rmsnorm(x) @ embed^T / logits_scaling       (tied embeddings)

Attention has no positional encoding and its softmax scale is
``attention_multiplier``. The Mamba-2 mixer: one input projection to
(z, x, B, C, dt), a causal depthwise conv with bias over (x, B, C) and
SiLU, dt = softplus(dt + dt_bias), A = -exp(A_log), the state-space scan
y_t = C_t . h_t + D x_t with h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,
a gated RMSNorm (y * silu(z)) and the output projection.

The scan here is the chunked dual form of the Mamba-2 paper (Dao and Gu,
2024, the ``ssd_minimal`` listing: a segment sum of the log decays within
each chunk, the chunks' end states, a recurrence over the chunks, the
states' contribution to the outputs), all in float32: its sum does not
depend on the chunk. Everything is float32 with no kernel, cache or
batching; the weights are the benchmark's, laid out as the program takes
them (per-kind stacks in layer order: ``mamba`` and ``attn``), upcast.
The configuration's keys are the program's (``n_layers``, ``d_model``,
``ssm``, ``hybrid.attn_layers``, the multipliers under their published
names); the published ones beside them in the file say the same.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from gpubench.reference import layers as L
from gpubench.reference.layers import Spec


def _dims(cfg: Dict):
    s = cfg["ssm"]
    d_inner = s["expand"] * cfg["d_model"]
    nh = d_inner // s["head_dim"]
    gn = s["n_groups"] * s["d_state"]
    return d_inner, nh, gn, d_inner + 2 * gn


def _layout(cfg: Dict) -> List[Tuple[str, int]]:
    """(kind, index in its stack) of each layer, in order."""
    attn = set(cfg["hybrid"]["attn_layers"])
    seen = {"mamba": 0, "attn": 0}
    out = []
    for i in range(cfg["n_layers"]):
        kind = "attn" if i in attn else "mamba"
        out.append((kind, seen[kind]))
        seen[kind] += 1
    return out


#: the stddevs' numerator of the matrices that write into the residual
#: stream (each Mamba-2 mixer's and attention's output projection, each
#: MLP's down projection). With random weights and tied embeddings, a
#: residual stream that the embedding (x 12) outweighs makes every
#: position's best logit its own token's (e_t . e_t): the served tokens
#: would read nothing of the layers. At 32 / sqrt(fan-in) the 80 branches,
#: each x 0.22, outweigh the embedding about 20 to 1, and the best logit
#: is the position's own token at about 2% of positions (at 1 / sqrt(fan-
#: in): at all of them)
OUT_SCALE = 32.0

#: the stddevs of the Mamba-2 layers' A_log and dt_bias: drawn normal (the
#: published init, A in [1, 16] and dt in [1e-3, 1e-1], is no kind the
#: benchmark's weights have), wide enough that a sizeable share of heads
#: decays by less than half over hundreds of tokens, so that a fault in the
#: state carried between chunks or into decode shows
A_LOG_STD, DT_BIAS_STD = 2.5, 2.5


def mixer_specs(cfg: Dict) -> Dict[str, Spec]:
    s, d, dt = cfg["ssm"], cfg["d_model"], cfg["dtype"]
    di, nh, gn, conv_dim = _dims(cfg)
    return {
        "in_proj": Spec((d, 2 * di + 2 * gn + nh), dt, fan_in=d),
        "conv_w": Spec((s["d_conv"], conv_dim), dt, fan_in=s["d_conv"]),
        "conv_b": Spec((conv_dim,), dt, fan_in=s["d_conv"]),
        "A_log": Spec((nh,), "float32", scale=A_LOG_STD),
        "dt_bias": Spec((nh,), "float32", scale=DT_BIAS_STD),
        "D": Spec((nh,), "float32", "ones"),
        "norm": Spec((di,), "float32", "ones"),
        "out_proj": Spec((di, d), dt, scale=OUT_SCALE, fan_in=di),
        "pre_norm": Spec((d,), "float32", "ones"),
    }


def _writes(spec: Spec) -> Spec:
    """``spec`` drawn at ``OUT_SCALE``: a matrix writing into the residual
    stream."""
    return Spec(spec.shape, spec.dtype, spec.init, OUT_SCALE, spec.fan_in)


def param_specs(cfg: Dict) -> Dict:
    n_attn = len(cfg["hybrid"]["attn_layers"])
    n_mamba = cfg["n_layers"] - n_attn
    d = cfg["d_model"]
    mlp = dict(L.mlp_specs(cfg))
    mlp["wo"] = _writes(mlp["wo"])
    # the embedding is also the (tied) unembedding: its rows at stddev
    # logits_scaling / sqrt(d) give unit-scale logits after the division
    out = {"embed": Spec((cfg["vocab"], d), cfg["dtype"],
                         scale=cfg["logits_scaling"], fan_in=d),
           "final_norm": L.norm_specs(cfg)}
    if n_mamba:
        out["mamba"] = L.stacked({"mixer": mixer_specs(cfg),
                                  "mlp_norm": L.norm_specs(cfg),
                                  "mlp": mlp}, n_mamba)
    if n_attn:
        block = L.block_specs(cfg)
        block["attn"] = dict(block["attn"], wo=_writes(block["attn"]["wo"]))
        block["mlp"] = mlp
        out["attn"] = L.stacked(block, n_attn)
    return out


def segsum(a: torch.Tensor) -> torch.Tensor:
    """a (..., T) -> (..., T, T): entry (i, j) is a_{j+1} + ... + a_i for
    j <= i (0 on the diagonal), -inf above it."""
    T = a.shape[-1]
    x = a[..., None].expand(*a.shape, T)                  # x[.., i, j] = a_i
    below = torch.ones(T, T, dtype=torch.bool, device=a.device).tril(-1)
    x = x.masked_fill(~below, 0.0).cumsum(-2)
    keep = torch.ones(T, T, dtype=torch.bool, device=a.device).tril()
    return x.masked_fill(~keep, -torch.inf)


def ssd(x, dt, A, B, C, chunk: int, prec: L.Precision) -> torch.Tensor:
    """The scan: x (b, s, h, p), dt (b, s, h), A (h,), B, C (b, s, g, n)
    -> y (b, s, h, p), with no skip term. Padded to whole chunks with dt =
    0 (no decay, nothing written). Under the control x, B and C are
    rounded through fp8 first, as an fp8 scan would take them."""
    b, s, h, p = x.shape
    g = B.shape[2]
    x, B, C = prec.q(x, -1), prec.q(B, -1), prec.q(C, -1)
    B = B.repeat_interleave(h // g, dim=2)
    C = C.repeat_interleave(h // g, dim=2)
    pad = (-s) % chunk
    if pad:
        x, B, C = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (x, B, C))
        dt = F.pad(dt, (0, 0, 0, pad))
    n = (s + pad) // chunk
    X = (x * dt[..., None]).reshape(b, n, chunk, h, p)
    a = (dt * A).reshape(b, n, chunk, h).permute(0, 3, 1, 2)   # (b,h,c,l)
    B = B.reshape(b, n, chunk, h, -1)
    C = C.reshape(b, n, chunk, h, -1)
    a_cum = a.cumsum(-1)
    # within each chunk
    decay = torch.exp(segsum(a))                               # (b,h,c,l,l)
    y = torch.einsum("bclhn,bcshn,bhcls,bcshp->bclhp", C, B, decay, X)
    # each chunk's end state (the decay from each step to the chunk's
    # end is the segment sum's last row), then the state entering each
    # chunk
    to_end = decay[..., -1, :]                                 # (b,h,c,l)
    states = torch.einsum("bclhn,bhcl,bclhp->bchpn", B, to_end, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    across = torch.exp(segsum(F.pad(a_cum[..., -1], (1, 0))))  # (b,h,c+1,c+1)
    entering = torch.einsum("bhzc,bchpn->bzhpn", across, states)[:, :-1]
    y = y + torch.einsum("bclhn,bchpn,bhcl->bclhp", C, entering,
                         torch.exp(a_cum))
    return y.reshape(b, n * chunk, h, p)[:, :s]


def mamba(cfg: Dict, p: Dict, x, prec: L.Precision):
    """The Mamba-2 mixer of x (b, s, d), its pre-norm included."""
    s_cfg, eps = cfg["ssm"], cfg["norm_eps"]
    di, nh, gn, conv_dim = _dims(cfg)
    b, s, _ = x.shape
    h = L.rmsnorm(x, p["pre_norm"], eps)
    z, xbc, dt = prec.mm(h, p["in_proj"]).split([di, conv_dim, nh], dim=-1)
    # causal depthwise conv: out_t = sum_k w_k in_{t - K + 1 + k} + bias
    K = s_cfg["d_conv"]
    w = p["conv_w"].float()
    padded = F.pad(xbc, (0, 0, K - 1, 0))
    xbc = sum(w[k] * padded[:, k:k + s] for k in range(K)) \
        + p["conv_b"].float()
    xbc = F.silu(xbc)
    xs, B, C = xbc.split([di, gn, gn], dim=-1)
    xs = xs.reshape(b, s, nh, s_cfg["head_dim"])
    B = B.reshape(b, s, s_cfg["n_groups"], s_cfg["d_state"])
    C = C.reshape(b, s, s_cfg["n_groups"], s_cfg["d_state"])
    dt = F.softplus(dt + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    y = ssd(xs, dt, A, B, C, s_cfg["chunk_size"], prec)
    y = (y + p["D"].float()[:, None] * xs).reshape(b, s, di)
    y = L.rmsnorm(y * F.silu(z), p["norm"], eps)
    return prec.mm(y, p["out_proj"])


def attention(cfg: Dict, p: Dict, x, prec: L.Precision):
    """Causal grouped-query attention with no positional encoding and a
    softmax scale of ``attention_multiplier``."""
    b, s, d = x.shape
    h, g, hd = cfg["n_heads"], cfg["n_kv_heads"], L.head_dim(cfg)
    q = prec.mm(x, p["wq"].reshape(d, h * hd)).view(b, s, h, hd)
    k = prec.mm(x, p["wk"].reshape(d, g * hd)).view(b, s, g, hd)
    v = prec.mm(x, p["wv"].reshape(d, g * hd)).view(b, s, g, hd)
    k = k.repeat_interleave(h // g, dim=2)
    v = v.repeat_interleave(h // g, dim=2)
    scores = torch.einsum("bqhd,bkhd->bhqk", prec.q(q, -1), prec.q(k, -1)) \
        * cfg["attention_multiplier"]
    mask = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~mask, -torch.inf), dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", prec.q(probs, -1), prec.q(v, 1))
    return prec.mm(o.reshape(b, s, h * hd), p["wo"].reshape(h * hd, d))


def mamba_layer(cfg: Dict, p: Dict, x, prec: L.Precision):
    m = cfg["residual_multiplier"]
    x = x + m * mamba(cfg, p["mixer"], x, prec)
    return x + m * L.gated_mlp(cfg, p["mlp"], L.norm(cfg, p["mlp_norm"], x),
                               prec)


def attn_layer(cfg: Dict, p: Dict, x, prec: L.Precision):
    m = cfg["residual_multiplier"]
    x = x + m * attention(cfg, p["attn"], L.norm(cfg, p["attn_norm"], x),
                          prec)
    return x + m * L.gated_mlp(cfg, p["mlp"], L.norm(cfg, p["mlp_norm"], x),
                               prec)


def forward(cfg: Dict, params: Dict, tokens: torch.Tensor,
            prec: L.Precision, remat: bool = False,
            keep_from: int = 0) -> torch.Tensor:
    """tokens (b, s) int -> logits (b, s - keep_from, vocab) float32, at
    the positions from ``keep_from`` on. With ``remat`` each layer's
    activations are recomputed in the backward."""
    x = params["embed"].float()[tokens.long()] * cfg["embedding_multiplier"]
    for kind, i in _layout(cfg):
        p = L.layer(params[kind], i)
        fn = mamba_layer if kind == "mamba" else attn_layer
        if remat:
            x = checkpoint(fn, cfg, p, x, prec, use_reentrant=False)
        else:
            x = fn(cfg, p, x, prec)
    x = L.norm(cfg, params["final_norm"], x[:, keep_from:])
    return prec.mm(x, params["embed"].T) / cfg["logits_scaling"]
