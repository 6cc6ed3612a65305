"""State-space / recurrent blocks: torch counterpart of
``repro.models.ssm``, Mamba-2 (SSD) and xLSTM (mLSTM + sLSTM).

The chunked SSD scan is ``repro_torch.kernels.ssd_scan``: for CUDA tensors
the hand-written kernel, for CPU tensors its plain version, which follows
the JAX package's ``ssd_scan`` step for step. The tensors' device decides,
and a CUDA tensor never takes the plain path forward. Training goes
through ``SSDScanFn``: the same forward, and a backward that
differentiates the plain version, as the JAX package differentiates its
``ssd_scan``. ``mamba2_decode_step`` is a
one-token recurrence (the JAX package has no kernel for it) and updates
the state and the conv window in place, so no step synchronises the host.

The xLSTM cells are plain torch, as they are plain JAX in the reference
(no Pallas kernel): the mLSTM in the stabilised chunkwise-parallel form,
a Python loop over chunks carrying the running-max stabiliser; the sLSTM
as a time scan, one step per token, issued eagerly. On the meta device,
under the dry run's abstract evaluation, both loops are ``meta_scan``s:
their body evaluated once, its cost charged for every step. Their functions
return new states and write nothing in place; the model writes them into
its cache. The mLSTM's normaliser floor exp(-m) is capped below fp32's
overflow, where the reference's gradient turns NaN (ROADMAP C8).
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import LMConfig
from repro_torch.kernels import cost, ops
from repro_torch.kernels.ssd_scan import ssd_scan_plain
from repro_torch.models.layers import (ParamDef, mlp_defs, mlp_fwd,
                                       norm_defs, rmsnorm)
from repro_torch.sharding.partition import (elementwise, lshard, matmul,
                                           on_shards, pin, split_last)

NEG_INF = -1e30


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


class SSDScanFn(torch.autograd.Function):
    """The chunked SSD scan with a backward, for training.

    The forward is ``kernels.ops.ssd_bshn``: the SSD-scan kernel for CUDA
    tensors, its plain version for CPU ones. The backward, the same code
    on both devices, recomputes the plain version from the saved inputs
    and differentiates it: the JAX package's gradient, autodiff of its
    pure-JAX ``ssd_scan``, with the same bf16 roundings. x, B and C are
    saved as they come, column views of the conv output, not copies. The
    final state's incoming gradient is None when the state is unused (in
    training) and counts as zero."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int, init_state=None):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C, init_state)
        ctx.chunk = chunk
        return ops.ssd_bshn(x, dt, A, B, C, chunk=chunk,
                            init_state=init_state)

    @staticmethod
    def backward(ctx, dy, dstate):
        wants = ctx.needs_input_grad[:5] + ctx.needs_input_grad[6:]
        with torch.enable_grad():
            ins = [None if t is None else t.detach().requires_grad_(w)
                   for t, w in zip(ctx.saved_tensors, wants)]
            y, state = ssd_scan_plain(*ins[:5], ctx.chunk, ins[5])
            outs = [(o, g) for o, g in ((y, dy), (state, dstate))
                    if g is not None]
            need = [t for t in ins if t is not None and t.requires_grad]
            got = iter(torch.autograd.grad(
                [o for o, _ in outs], need, [g for _, g in outs],
                allow_unused=True) if outs else [None] * len(need))
        dx, ddt, dA, dB, dC, dinit = (
            next(got) if t is not None and t.requires_grad else None
            for t in ins)
        return dx, ddt, dA, dB, dC, None, dinit


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None):
    """Chunked state-space-dual scan.

    x: (b, s, nh, hd); dt: (b, s, nh); A: (nh,) (negative);
    B, C: (b, s, g, n) with nh % g == 0.
    Returns (y (b, s, nh, hd), final_state (b, nh, hd, n)). Through
    ``SSDScanFn`` when a gradient is wanted, else the kernel's wrapper;
    under a mesh, per device on its batch rows and heads (B and C
    gathered, which keeps each head's group only with one group).
    """
    nh, g = x.shape[2], B.shape[2]

    def local(x, dt, A, B, C, init_state):
        if g > 1 and x.shape[2] != nh:
            raise NotImplementedError(
                f"{g} B/C groups with the {nh} heads sharded")
        return _ssd_scan(x, dt, A, B, C, chunk, init_state)

    heads = ("act_batch", None, "ssm_heads", None)
    state = ("act_batch", "ssm_heads", None, None)
    return on_shards(local, (x, dt, A, B, C, init_state),
                     (heads, heads[:3], ("ssm_heads",),
                      ("act_batch", None, None, None),
                      ("act_batch", None, None, None), state),
                     [heads, state])


def _ssd_scan(x, dt, A, B, C, chunk: int, init_state):
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (x, dt, A, B, C, init_state)):
        return SSDScanFn.apply(x, dt, A, B, C, chunk, init_state)
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
    return (split_last(xin, nh, s.head_dim),
            split_last(B, s.n_groups, s.d_state),
            split_last(C, s.n_groups, s.d_state))


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
    zxbcdt = matmul(h, p["in_proj"])
    z, _, _, _, dtr = mamba2_split(cfg, zxbcdt)
    # x, B and C sit side by side in zxbcdt: their concatenation is a view
    xBC_raw = zxbcdt[..., di:di + conv_dim]
    # per device on its batch rows and channels: DTensor has no strategy
    # for a depthwise convolution
    xBC = F.silu(on_shards(_causal_conv, (xBC_raw, p["conv_w"], p["conv_b"]),
                           (("act_batch", None, "conv_dim"),
                            (None, "conv_dim"), ("conv_dim",)),
                           [("act_batch", None, "conv_dim")]))
    xh, Bg, Cg = _heads(cfg, xBC)
    xh = lshard(xh, "act_batch", "act_seq", "act_ssm_inner", None)
    dt = F.softplus(dtr.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, Sf = ssd_scan(xh, dt, A, Bg, Cg, s_cfg.chunk_size, init_state)
    y = y + (p["D"][:, None] * xh.float()).to(y.dtype)
    y = y.reshape(b, s, di)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = lshard(x + matmul(y, p["out_proj"]), "act_batch", "act_res_seq",
                 "act_embed")
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
    # per device on its batch rows and heads under a mesh: DTensor plans
    # the einsum's redistributions slowly on the 2 x 16 x 16 mesh
    rows = ("cache_batch", "ssm_heads", None)
    y = on_shards(_ssm_recurrence, (state, xf, dt, p["A_log"], Bh, Ch,
                                    p["D"]),
                  (rows + (None,), rows, rows[:2], ("ssm_heads",), rows,
                   rows, ("ssm_heads",)), [rows])
    y = y.reshape(b, 1, di).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = x + y @ p["out_proj"]
    conv_buf.copy_(win[:, 1:])
    return out, state, conv_buf


def _ssm_recurrence(state, xf, dt, A_log, Bh, Ch, D):
    """One step of the SSD recurrence, ``state`` updated in place: the
    readout y (b, nh, hd)."""
    dA = torch.exp(dt * -torch.exp(A_log))
    state.mul_(dA[..., None, None]).add_(
        (xf * dt[..., None])[..., :, None] * Bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return y + D[:, None] * xf


# ===========================================================================
# xLSTM: mLSTM (chunkwise parallel) + sLSTM (time scan)
# ===========================================================================

def xlstm_dims(cfg: LMConfig):
    x = cfg.xlstm
    di = x.proj_factor_m * cfg.d_model
    nh = cfg.n_heads
    return di, nh, di // nh


def mlstm_defs(cfg: LMConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    di, nh, dh = xlstm_dims(cfg)
    dt = cfg.dtype
    return {
        "pre_norm": norm_defs(d, "rmsnorm"),
        "up": ParamDef((d, 2 * di), ("embed", "ssm_inner"), dtype=dt),
        "wq": ParamDef((di, di), ("ssm_inner", None), dtype=dt),
        "wk": ParamDef((di, di), ("ssm_inner", None), dtype=dt),
        "wv": ParamDef((di, di), ("ssm_inner", None), dtype=dt),
        "wif": ParamDef((di, 2 * nh), ("ssm_inner", None), dtype="float32"),
        "norm": ParamDef((di,), ("ssm_inner",), init="ones", dtype="float32"),
        "down": ParamDef((di, d), ("ssm_inner", "embed"), dtype=dt),
    }


def _headwise_rmsnorm(y: torch.Tensor, w: torch.Tensor, nh: int,
                      eps: float) -> torch.Tensor:
    b, s, di = y.shape
    yf = split_last(y, nh, di // nh).float()
    var = yf.square().mean(-1, keepdim=True)
    yn = pin((yf * torch.rsqrt(var + eps)).reshape(b, s, di))
    return (yn * w.float()).to(y.dtype)


def _exp_floor(m: torch.Tensor) -> torch.Tensor:
    """exp(-m), the normaliser's floor, with -m capped at 88, below fp32's
    overflow at 88.72. Where the reference's exp(-m) overflows to inf (a
    stabiliser m below -88.7: every log input gate so far that low), h is
    num / inf = 0, and the backward multiplies the zero gradient there by
    exp(-m) = inf, which is NaN (ROADMAP C8). Capped, the floor is 1.7e38:
    h is 0 to within 1e-38 and its gradient is 0, the limit of the
    reference's num * exp(m)."""
    return torch.exp(torch.clamp_max(-m, 88.0))


def mlstm_chunkwise(q, k, v, li, lf, chunk: int, init=None):
    """Stabilised chunkwise mLSTM.

    q/k/v: (b, s, nh, dh); li/lf: (b, s, nh) fp32 log input/forget gates;
    init: (C (b, nh, dh, dh), n (b, nh, dh), m (b, nh)) fp32 or None.
    Returns (h (b, s, nh, dh), (C, n, m) final states). Under a mesh, per
    device on its batch rows and heads."""
    seq = ("act_batch", None, "ssm_heads", None)
    states = (("act_batch", "ssm_heads", None, None),
              ("act_batch", "ssm_heads", None), ("act_batch", "ssm_heads"))
    init = tuple(init) if init is not None else (None,) * 3
    h, *fin = on_shards(
        lambda q, k, v, li, lf, *init: _mlstm_chunkwise(
            q, k, v, li, lf, chunk, None if init[0] is None else init),
        (q, k, v, li, lf, *init), (seq,) * 3 + (seq[:3],) * 2 + states,
        [seq, *states])
    return h, tuple(fin)


def _mlstm_chunkwise(q, k, v, li, lf, chunk: int, init):
    b, s, nh, dh = q.shape
    L = min(chunk, s)
    s0 = s
    pad = (-s) % L
    if pad:
        # li = NEG_INF (no write) and lf = 0 (no decay) on the padded steps
        # keep the final (C, n, m) equal to the state at s0 (NEG_INF is
        # finite, as in the reference)
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
        li = F.pad(li, (0, 0, 0, pad), value=NEG_INF)
        lf = F.pad(lf, (0, 0, 0, pad))
        s += pad
    nc = s // L
    k = k / math.sqrt(dh)
    qc, kc, vc = (t.reshape(b, nc, L, nh, dh) for t in (q, k, v))
    lic = li.reshape(b, nc, L, nh)
    Fc = lf.reshape(b, nc, L, nh).cumsum(2)                   # inclusive
    Ftot = Fc[:, :, -1, :]                                     # (b, nc, nh)
    gvec = Ftot[:, :, None, :] - Fc + lic                      # (b, nc, L, nh)
    # intra-chunk decay D_ij = F_i - F_j + li_j for j <= i
    Dm = Fc[:, :, :, None, :] - Fc[:, :, None, :, :] + lic[:, :, None, :, :]
    tri = torch.ones(L, L, dtype=torch.bool, device=q.device).tril()
    Dm = Dm.masked_fill(~tri[None, None, :, :, None], NEG_INF)
    # an fp32 product of the bf16 q and k, as the reference's
    # preferred_element_type: cast up before the product, since a bf16
    # matmul would round its output
    scores = torch.einsum("bclhd,bcmhd->bclmh", qc.float(), kc.float())

    if init is None:
        C = torch.zeros(b, nh, dh, dh, dtype=torch.float32, device=q.device)
        n = torch.zeros(b, nh, dh, dtype=torch.float32, device=q.device)
        m = torch.full((b, nh), -math.inf, dtype=torch.float32,
                       device=q.device)
    else:
        C, n, m = init
    xs = (Fc, Ftot, gvec, qc, kc, vc, Dm, scores)
    if q.is_meta and cost.evaluating():
        h, C, n, m = meta_scan("mlstm_chunks", _mlstm_chunk, xs, (C, n, m))
    else:
        hs = []
        for c in range(nc):
            h_c, C, n, m = _mlstm_chunk(*(t[:, c] for t in xs), C, n, m)
            hs.append(h_c)
        h = torch.stack(hs, 1)
    h = h.reshape(b, s, nh, dh)[:, :s0]
    return h.to(q.dtype), C, n, m


def _mlstm_chunk(F_c, Ftot_c, g_c, q_c, k_c, v_c, D_c, sc_c, C, n, m):
    """One chunk of the chunkwise mLSTM: (h (b, L, nh, dh), C, n, m)."""
    qf, vf = q_c.float(), v_c.float()
    # with m = -inf (no state yet) a is -inf and w_inter exp(-inf) = 0
    a = F_c + m[:, None, :]                                    # (b, L, nh)
    m_i = torch.maximum(D_c.amax(2), a)                        # (b, L, nh)
    w_inter = torch.exp(a - m_i)
    ws = torch.exp(D_c - m_i[:, :, None, :]) * sc_c
    num = w_inter[..., None] * torch.einsum("blhd,bhde->blhe", qf, C) \
        + torch.einsum("blmh,bmhe->blhe", ws, vf)
    den = w_inter * torch.einsum("blhd,bhd->blh", qf, n) + ws.sum(2)
    h = num / torch.maximum(den.abs(), _exp_floor(m_i))[..., None]
    # state update to the end of the chunk
    m_new = torch.maximum(m + Ftot_c, g_c.amax(1))             # (b, nh)
    sc_old = torch.exp(m + Ftot_c - m_new)
    kw = k_c * torch.exp(g_c - m_new[:, None, :])[..., None]   # fp32
    C = C * sc_old[..., None, None] \
        + torch.einsum("blhd,blhe->bhde", kw, vf)
    n = n * sc_old[..., None] + kw.sum(1)
    return h, C, n, m_new


def _mlstm_in(cfg: LMConfig, p: Dict, x: torch.Tensor):
    """The mLSTM block's projections: (q, k, v (b, s, nh, dh), fp32 log
    gates li, lf (b, s, nh), the output gate's input z (b, s, di))."""
    di, nh, dh = xlstm_dims(cfg)
    b, s, _ = x.shape
    h = rmsnorm(x, p["pre_norm"]["scale"], cfg.norm_eps)
    xi, z = matmul(h, p["up"]).chunk(2, dim=-1)
    xi = lshard(xi, "act_batch", "act_seq", "act_ssm_inner")
    q, k, v = (split_last(matmul(xi, p[w]), nh, dh)
               for w in ("wq", "wk", "wv"))
    li, lfr = matmul(xi.float(), p["wif"]).chunk(2, dim=-1)    # (b, s, nh)
    lf = elementwise(F.logsigmoid, lfr + 3.0)                  # forget bias +3
    return q, k, v, li, lf, z


def _mlstm_out(cfg: LMConfig, p: Dict, x: torch.Tensor, y: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    di, nh, _ = xlstm_dims(cfg)
    b, s, _ = x.shape
    y = pin(y.reshape(b, s, di)) * F.silu(z)
    y = _headwise_rmsnorm(y, p["norm"], nh, cfg.norm_eps)
    return lshard(x + matmul(y, p["down"]), "act_batch", "act_res_seq",
                  "act_embed")


def mlstm_block_fwd(cfg: LMConfig, p: Dict, x: torch.Tensor, init=None,
                    return_state: bool = False):
    q, k, v, li, lf, z = _mlstm_in(cfg, p, x)
    y, state = mlstm_chunkwise(q, k, v, li, lf, cfg.xlstm.chunk_size, init)
    out = _mlstm_out(cfg, p, x, y, z)
    if return_state:
        return out, state
    return out


def mlstm_decode_step(cfg: LMConfig, p: Dict, x: torch.Tensor, state):
    """One-token mLSTM step. x: (b, 1, d); state (C, n, m) fp32. Returns
    (out, new state)."""
    _, _, dh = xlstm_dims(cfg)
    C, n, m = state
    q, k, v, li, lf, z = _mlstm_in(cfg, p, x)
    qf, vf = q[:, 0].float(), v[:, 0].float()
    kf = (k[:, 0] / math.sqrt(dh)).float()                     # (b, nh, dh)
    li, lf = li[:, 0], lf[:, 0]                                # (b, nh)
    m_new = torch.maximum(lf + m, li)
    iw = torch.exp(li - m_new)
    fw = torch.exp(lf + m - m_new)
    C = C * fw[..., None, None] \
        + iw[..., None, None] * (kf[..., :, None] * vf[..., None, :])
    n = n * fw[..., None] + iw[..., None] * kf
    num = torch.einsum("bhd,bhde->bhe", qf, C)
    den = (qf * n).sum(-1)
    y = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return _mlstm_out(cfg, p, x, y.to(x.dtype), z), (C, n, m_new)


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_defs(cfg: LMConfig) -> Dict[str, ParamDef]:
    d = cfg.d_model
    nh = cfg.n_heads
    dh = d // nh
    ff = cfg.xlstm.ff_factor_s * d
    dt = cfg.dtype
    return {
        "pre_norm": norm_defs(d, "rmsnorm"),
        "W": ParamDef((d, 4 * d), ("embed", "ssm_inner"), dtype="float32"),
        "R": ParamDef((nh, dh, 4 * dh), ("ssm_heads", None, None),
                      scale=0.5, dtype="float32"),
        "b": ParamDef((4 * d,), ("ssm_inner",), init="zeros", dtype="float32"),
        "ffn_norm": norm_defs(d, "rmsnorm"),
        "ffn": mlp_defs(d, ff, True, dt),
    }


def _slstm_step(pre_t, R, c, n, h, m):
    """One sLSTM step: pre_t (b, nh, 4 dh) and the state (c, n, h, m)
    -> the next state."""
    u = pre_t + torch.einsum("bhd,hdk->bhk", h, R)
    i_r, f_r, z_r, o_r = u.chunk(4, dim=-1)
    lf = F.logsigmoid(f_r + 3.0)
    # with m = -inf (no state yet) fw is exp(-inf) = 0
    m_new = torch.maximum(lf + m, i_r)
    iw = torch.exp(i_r - m_new)
    fw = torch.exp(lf + m - m_new)
    c = fw * c + iw * torch.tanh(z_r)
    n = fw * n + iw
    h = torch.sigmoid(o_r) * c / n.clamp_min(1e-6)
    return c, n, h, m_new


def _slstm_scan_step(pre_t, c, n, h, m, R):
    """``_slstm_step`` as a scan's step: (y_t = h, the next state)."""
    c, n, h, m = _slstm_step(pre_t, R, c, n, h, m)
    return h, c, n, h, m


def _counted(fn):
    """(``fn()``, the products it does (``torch.utils.flop_counter``)), with
    every other dispatch mode off."""
    from torch.utils._python_dispatch import _disable_current_modes
    from torch.utils.flop_counter import FlopCounterMode
    with _disable_current_modes(), FlopCounterMode(display=False) as fc:
        out = fn()
    return out, fc.get_total_flops()


class _MetaScan(torch.autograd.Function):
    """A scan on the meta device, the counterpart of XLA compiling a
    ``lax.scan`` body once: ``step(*x_t, *carry, *consts) -> (y_t,
    *carry)`` is evaluated once, on the first step's slices of ``xs``
    (their dim 1 is the scan's), the outputs come out at full shape (every
    step's y stacked at dim 1, the final carry), and the step's products
    are charged once a step (``kernels.cost``, under ``name``). The
    backward returns gradients of the inputs' shapes and charges a step's
    backward once a step."""

    @staticmethod
    def forward(ctx, name, step, n_xs, *tensors):
        n = tensors[0].shape[1]
        first = [x[:, 0] for x in tensors[:n_xs]]
        (y, *carry), flops = _counted(lambda: step(*first, *tensors[n_xs:]))
        cost.charge(name, flops, 0, times=n)
        ctx.save_for_backward(*tensors)
        ctx.name, ctx.step, ctx.n_xs = name, step, n_xs
        return (y.new_empty(y.shape[:1] + (n,) + y.shape[1:]), *carry)

    @staticmethod
    def backward(ctx, *grads):
        tensors = ctx.saved_tensors
        wants = list(ctx.needs_input_grad[3:])
        # past the first step the carry depends on whatever needs a gradient
        n_carry = len(grads) - 1
        wants[ctx.n_xs:ctx.n_xs + n_carry] = [any(wants)] * n_carry

        def one_step():
            with torch.enable_grad():
                ins = [t.detach().requires_grad_(w and t.is_floating_point())
                       for t, w in zip(
                           [x[:, 0] for x in tensors[:ctx.n_xs]]
                           + list(tensors[ctx.n_xs:]), wants)]
                out = ctx.step(*ins)
                torch.autograd.grad(out, [t for t in ins if t.requires_grad],
                                    [torch.empty_like(o) for o in out],
                                    allow_unused=True)

        cost.charge(ctx.name, _counted(one_step)[1], 0,
                    times=tensors[0].shape[1])
        return (None, None, None) + tuple(
            torch.empty_like(t) if want else None
            for t, want in zip(tensors, ctx.needs_input_grad[3:]))


def meta_scan(name: str, step, xs, carry, consts=()):
    """``_MetaScan``: (ys, *final carry)."""
    return _MetaScan.apply(name, step, len(xs), *xs, *carry, *consts)


def slstm_cell_scan(cfg: LMConfig, p: Dict, x: torch.Tensor, init=None):
    """x: (b, s, d). Sequential exponential-gated sLSTM over the s steps;
    init: (c, n, h, m) each (b, nh, dh) fp32, or None. Returns (y (b, s,
    d), final (c, n, h, m)). Under a mesh, per device on its batch rows,
    the weights gathered."""
    row, state = ("act_batch", None, None), ("act_batch", None, None)
    init = tuple(init) if init is not None else (None,) * 4
    y, *fin = on_shards(
        lambda x, W, b, R, *init: _slstm_scan(cfg, x, W, b, R, init),
        (x, p["W"], p["b"], p["R"], *init),
        (row, (None, None), (None,), (None, None, None)) + (state,) * 4,
        [row] + [state] * 4)
    return y, tuple(fin)


def _slstm_scan(cfg: LMConfig, x, W, bias, R, init):
    b, s, d = x.shape
    nh = cfg.n_heads
    dh = d // nh
    pre = split_last(x.float() @ W + bias, nh, 4 * dh)
    if init[0] is None:
        zeros = torch.zeros(b, nh, dh, dtype=torch.float32, device=x.device)
        init = (zeros, zeros + 1e-6, zeros,
                torch.full_like(zeros, -math.inf))
    if x.is_meta and cost.evaluating():
        ys, *state = meta_scan("slstm_scan", _slstm_scan_step, (pre,), init,
                               (R,))
        return (ys.reshape(b, s, d).to(x.dtype), *state)
    c, n, h, m = init
    ys = []
    for t in range(s):
        c, n, h, m = _slstm_step(pre[:, t], R, c, n, h, m)
        ys.append(h)
    y = torch.stack(ys, 1).reshape(b, s, d)
    return y.to(x.dtype), c, n, h, m


def slstm_block_fwd(cfg: LMConfig, p: Dict, x: torch.Tensor, init=None,
                    return_state: bool = False):
    h = rmsnorm(x, p["pre_norm"]["scale"], cfg.norm_eps)
    y, state = slstm_cell_scan(cfg, p, h, init)
    x = x + y
    h = rmsnorm(x, p["ffn_norm"]["scale"], cfg.norm_eps)
    x = lshard(x + mlp_fwd(p["ffn"], h, "silu", True), "act_batch",
               "act_res_seq", "act_embed")
    if return_state:
        return x, state
    return x


def slstm_decode_step(cfg: LMConfig, p: Dict, x: torch.Tensor, state):
    """One-token sLSTM block: the block forward seeded with ``state``.
    Returns (out, new state)."""
    return slstm_block_fwd(cfg, p, x, state, return_state=True)
