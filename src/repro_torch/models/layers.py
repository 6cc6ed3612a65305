"""Shared layers: param-spec system, norms, activations, RoPE, MLP.

Torch counterparts of ``repro.models.layers``. Every function keeps the JAX
package's layouts (weights stored ``(in, out)``, activations ``(..., d)``)
so the parity tests compare like with like.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import _TORCH_DTYPES
from repro_torch.sharding.partition import lshard, matmul


class ParamDef(NamedTuple):
    """Declarative parameter: shape + logical sharding axes + initializer."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | small_normal
    scale: float = 1.0            # stddev multiplier for normal inits
    dtype: str = "bfloat16"


def is_param_def(x) -> bool:
    return isinstance(x, ParamDef)


def _map_defs(fn, defs):
    """``fn`` on every ParamDef of a nested dict, in the dict's order."""
    if is_param_def(defs):
        return fn(defs)
    return {k: _map_defs(fn, v) for k, v in defs.items()}


def init_from_defs(defs, generator: torch.Generator, device) -> Dict:
    """Materialize a nested dict of ParamDef into tensors on ``device``.

    Same distributions as the JAX package (normal with stddev
    ``scale/sqrt(fan_in)``, zeros, ones), drawn from ``generator`` in the
    order the defs are walked. The numbers differ from ``jax.random``'s:
    parity tests bring JAX weights over with ``repro_torch.bridge``.
    """
    device = torch.device(device)

    def init(d: ParamDef) -> torch.Tensor:
        dt = _TORCH_DTYPES[d.dtype]
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=dt, device=device)
        if d.init == "ones":
            return torch.ones(d.shape, dtype=dt, device=device)
        fan_in = d.shape[0] if d.shape else 1
        std = d.scale / math.sqrt(max(fan_in, 1))
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=generator.device)
        return (x * std).to(device=device, dtype=dt)

    return _map_defs(init, defs)


def abstract_from_defs(defs):
    """Tensors on the meta device with each def's shape and dtype, the
    counterpart of the JAX package's ShapeDtypeStruct tree: nothing is
    allocated and no generator is drawn (the dry run's stand-ins)."""
    def abstract(d: ParamDef) -> torch.Tensor:
        return torch.empty(d.shape, dtype=_TORCH_DTYPES[d.dtype],
                           device="meta")

    return _map_defs(abstract, defs)


def axes_from_defs(defs):
    return _map_defs(lambda d: d.axes, defs)


# ---------------------------------------------------------------------------
# norms / activations
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) \
        -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def layernorm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    # population variance, as jnp.var: F.layer_norm normalizes with it
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(),
                        eps).to(x.dtype)


def norm(x, p: Dict, kind: str, eps: float):
    if kind == "layernorm":
        return layernorm(x, p["scale"], p["bias"], eps)
    return rmsnorm(x, p["scale"], eps)


def norm_defs(d_model: int, kind: str) -> Dict[str, ParamDef]:
    out = {"scale": ParamDef((d_model,), ("norm",), "ones", dtype="float32")}
    if kind == "layernorm":
        out["bias"] = ParamDef((d_model,), ("norm",), "zeros", dtype="float32")
    return out


def act_fn(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# RoPE (with partial-rotary support, e.g. stablelm rope_fraction=0.25)
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, fraction: float, theta: float,
               device=None) -> Tuple[torch.Tensor, int]:
    """Inverse frequencies, built in float64 numpy and cast to fp32 (as the
    JAX package does), and the number of rotated dims."""
    rot = int(head_dim * fraction) // 2 * 2
    inv = 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float64) / rot))
    return torch.tensor(inv, dtype=torch.float32, device=device), rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor, rot: int) -> torch.Tensor:
    """x: (..., seq, n_heads, head_dim); positions: broadcastable to
    (..., seq). Rotates *interleaved* pairs ``x[..., 0::2]`` /
    ``x[..., 1::2]`` of the first ``rot`` dims, not the half-split layout."""
    if rot == 0:
        return x
    angles = positions[..., :, None].float() * inv_freq      # (..., s, rot/2)
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    x1, x2 = x_rot[..., 0::2], x_rot[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    rotated = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape).to(x.dtype)
    if x_pass.shape[-1]:
        return torch.cat([rotated, x_pass], dim=-1)
    return rotated


# ---------------------------------------------------------------------------
# MLP (gated or plain)
# ---------------------------------------------------------------------------

def mlp_defs(d_model: int, d_ff: int, gated: bool, dtype: str):
    out = {
        "wi": ParamDef((d_model, d_ff), ("embed", "mlp"), dtype=dtype),
        "wo": ParamDef((d_ff, d_model), ("mlp", "embed"), dtype=dtype),
    }
    if gated:
        out["wg"] = ParamDef((d_model, d_ff), ("embed", "mlp"), dtype=dtype)
    return out


def mlp_fwd(p: Dict, x: torch.Tensor, act: str, gated: bool) -> torch.Tensor:
    h = matmul(x, p["wi"])
    if gated:
        h = act_fn(act)(matmul(x, p["wg"])) * h
    else:
        h = act_fn(act)(h)
    h = lshard(h, "act_batch", "act_seq", "act_mlp")
    return matmul(h, p["wo"])
