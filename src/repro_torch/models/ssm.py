"""Mamba-2 (SSD) blocks: torch counterpart of the Mamba-2 half of
``repro.models.ssm``.

The chunked SSD scan is ``repro_torch.kernels.ssd_scan``: for CUDA tensors
the hand-written kernel, for CPU tensors its plain version, which follows
the JAX package's ``ssd_scan`` step for step. The tensors' device decides,
and a CUDA tensor never takes the plain path. ``mamba2_decode_step`` is a
one-token recurrence (the JAX package has no kernel for it) and updates
the state and the conv window in place, so no step synchronises the host.
The xLSTM half is not ported yet (ROADMAP.md, queue A item 10).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import ParamDef, norm_defs, rmsnorm


def mamba2_dims(cfg: LMConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    nheads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, nheads, conv_dim


def mamba2_defs(cfg: LMConfig) -> Dict[str, ParamDef]:
    s = cfg.ssm
    d = cfg.d_model
    di, nh, conv_dim = mamba2_dims(cfg)
    proj_out = 2 * di + 2 * s.n_groups * s.d_state + nh
    dt = cfg.dtype
    return {
        "in_proj": ParamDef((d, proj_out), ("embed", "ssm_inner"), dtype=dt),
        "conv_w": ParamDef((s.d_conv, conv_dim), (None, "conv_dim"),
                           init="normal", dtype=dt),
        "conv_b": ParamDef((conv_dim,), ("conv_dim",), init="zeros", dtype=dt),
        "A_log": ParamDef((nh,), ("ssm_heads",), init="zeros", dtype="float32"),
        "dt_bias": ParamDef((nh,), ("ssm_heads",), init="zeros",
                            dtype="float32"),
        "D": ParamDef((nh,), ("ssm_heads",), init="ones", dtype="float32"),
        "norm": ParamDef((di,), ("ssm_inner",), init="ones", dtype="float32"),
        "out_proj": ParamDef((di, d), ("ssm_inner", "embed"), dtype=dt),
        "pre_norm": norm_defs(d, cfg.norm_type)["scale"],
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, left-padded by k - 1. x: (b, s, ch),
    w: (k, ch) -> (b, s, ch), contiguous: the SSD-scan kernel reads its
    x/B/C column slices with the channels contiguous."""
    k, ch = w.shape
    xp = F.pad(x.transpose(1, 2), (k - 1, 0))                # (b, ch, s+k-1)
    out = F.conv1d(xp, w.T[:, None, :], groups=ch)            # (b, ch, s)
    return out.transpose(1, 2).contiguous() + b


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None):
    """Chunked state-space-dual scan.

    x: (b, s, nh, hd); dt: (b, s, nh); A: (nh,) (negative);
    B, C: (b, s, g, n) with nh % g == 0.
    Returns (y (b, s, nh, hd), final_state (b, nh, hd, n)).
    """
    return ops.ssd_bshn(x, dt, A, B, C, chunk=chunk, init_state=init_state)


def mamba2_split(cfg: LMConfig, zxbcdt: torch.Tensor):
    s = cfg.ssm
    di, nh, _ = mamba2_dims(cfg)
    gn = s.n_groups * s.d_state
    return zxbcdt.split([di, di, gn, gn, nh], dim=-1)


def _heads(cfg: LMConfig, xBC: torch.Tensor):
    """Views of the conv output (..., conv_dim) as x (..., nh, hd) and
    B, C (..., g, n)."""
    s = cfg.ssm
    di, nh, _ = mamba2_dims(cfg)
    gn = s.n_groups * s.d_state
    xin, B, C = xBC.split([di, gn, gn], dim=-1)
    return (xin.unflatten(-1, (nh, s.head_dim)),
            B.unflatten(-1, (s.n_groups, s.d_state)),
            C.unflatten(-1, (s.n_groups, s.d_state)))


def mamba2_block_fwd(cfg: LMConfig, p: Dict, x: torch.Tensor,
                     init_state: Optional[torch.Tensor] = None,
                     return_state: bool = False):
    """Full-sequence Mamba-2 block. x: (b, s, d). With ``return_state``
    also returns (final ssm state (b, nh, hd, n) fp32, the last d_conv - 1
    rows of the conv input (b, d_conv - 1, conv_dim))."""
    s_cfg = cfg.ssm
    b, s, d = x.shape
    di, nh, conv_dim = mamba2_dims(cfg)
    h = rmsnorm(x, p["pre_norm"], cfg.norm_eps)
    zxbcdt = h @ p["in_proj"]
    z, _, _, _, dtr = mamba2_split(cfg, zxbcdt)
    # x, B and C sit side by side in zxbcdt: their concatenation is a view
    xBC_raw = zxbcdt[..., di:di + conv_dim]
    xBC = F.silu(_causal_conv(xBC_raw, p["conv_w"], p["conv_b"]))
    xh, Bg, Cg = _heads(cfg, xBC)
    dt = F.softplus(dtr.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, Sf = ssd_scan(xh, dt, A, Bg, Cg, s_cfg.chunk_size, init_state)
    y = y + (p["D"][:, None] * xh.float()).to(y.dtype)
    y = y.reshape(b, s, di)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = x + y @ p["out_proj"]
    if return_state:
        assert s >= s_cfg.d_conv - 1, "prefill shorter than conv window"
        conv_tail = xBC_raw[:, s - (s_cfg.d_conv - 1):, :]
        return out, (Sf, conv_tail)
    return out


def mamba2_decode_step(cfg: LMConfig, p: Dict, x: torch.Tensor,
                       state: torch.Tensor, conv_buf: torch.Tensor):
    """One-token Mamba-2 step. x: (b, 1, d); state: (b, nh, hd, n) fp32;
    conv_buf: (b, d_conv-1, conv_dim). Returns (out, state, conv_buf).

    Unlike the JAX version, which returns new arrays, this updates
    ``state`` and ``conv_buf`` in place (they may be views into a cache)
    and returns the same tensors."""
    s_cfg = cfg.ssm
    b = x.shape[0]
    di, nh, conv_dim = mamba2_dims(cfg)
    h = rmsnorm(x, p["pre_norm"], cfg.norm_eps)
    zxbcdt = h @ p["in_proj"]
    z, _, _, _, dtr = mamba2_split(cfg, zxbcdt)
    xBC_new = zxbcdt[..., di:di + conv_dim]                  # (b, 1, ch)
    win = torch.cat([conv_buf, xBC_new], dim=1)              # (b, d_conv, ch)
    conv_out = torch.einsum("bkc,kc->bc", win, p["conv_w"]) + p["conv_b"]
    xh, Bg, Cg = _heads(cfg, F.silu(conv_out))
    rep = nh // s_cfg.n_groups
    Bh = Bg.float().repeat_interleave(rep, dim=1)            # (b, nh, n)
    Ch = Cg.float().repeat_interleave(rep, dim=1)
    xf = xh.float()                                          # (b, nh, hd)
    dt = F.softplus(dtr[:, 0].float() + p["dt_bias"])        # (b, nh)
    dA = torch.exp(dt * -torch.exp(p["A_log"]))
    state.mul_(dA[..., None, None]).add_(
        (xf * dt[..., None])[..., :, None] * Bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    y = y + p["D"][:, None] * xf
    y = y.reshape(b, 1, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = x + y @ p["out_proj"]
    conv_buf.copy_(win[:, 1:])
    return out, state, conv_buf
