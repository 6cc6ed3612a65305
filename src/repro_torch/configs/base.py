"""Model/architecture configuration system.

Every assigned architecture is expressed as an :class:`LMConfig`. The config is a
plain frozen dataclass so it can be hashed into jit static args and serialized
into dry-run / checkpoint metadata.

Families
--------
``dense``   decoder-only transformer (GQA + RoPE + gated MLP)
``vlm``     dense backbone + stubbed patch-embedding prefix (frontend is a stub)
``audio``   dense backbone over EnCodec-token streams (frontend is a stub)
``moe``     dense attention + mixture-of-experts FFN (top-k routing, EP-sharded)
``ssm``     xLSTM: alternating mLSTM / sLSTM blocks
``hybrid``  Zamba2-style: Mamba-2 backbone with a shared attention block
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch


#: ``LMConfig.dtype`` strings to torch dtypes (the JAX package maps them
#: with ``jnp.dtype``)
_TORCH_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 0
    top_k: int = 0
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    # load-balancing auxiliary loss weight (Switch-style)
    aux_loss_weight: float = 0.01
    # expert-dispatch locality: 1 = global top-C per expert (simplest);
    # N > 1 = capacity enforced per dispatch group (align with the data-
    # parallel axis so the combine scatter stays shard-local and the
    # cross-shard all-reduce of the full token array disappears —
    # EXPERIMENTS.md §Perf, phi3.5-moe iteration 1)
    dispatch_groups: int = 1


@dataclass(frozen=True)
class SSMConfig:
    """Mamba-2 (SSD) block hyper-parameters."""
    d_state: int = 64
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64          # SSD head dim (d_inner / head_dim heads)
    n_groups: int = 1           # B/C groups (GQA-analogue for SSD)
    chunk_size: int = 128       # SSD chunked-scan block length


@dataclass(frozen=True)
class XLSTMConfig:
    """xLSTM block hyper-parameters (alternating mLSTM / sLSTM)."""
    proj_factor_m: int = 2       # mLSTM up-projection factor
    ff_factor_s: int = 2         # sLSTM post-cell GLU FFN factor
    chunk_size: int = 128        # mLSTM chunkwise-parallel block length
    slstm_every: int = 2         # every k-th block is sLSTM (rest mLSTM)


@dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: Mamba-2 backbone + shared attention block."""
    attn_every: int = 6          # apply the shared attention block every k SSM blocks


@dataclass(frozen=True)
class LMConfig:
    arch_id: str
    family: str                  # dense | vlm | audio | moe | ssm | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    norm_type: str = "rmsnorm"   # rmsnorm | layernorm
    act: str = "silu"            # silu | gelu
    gated_mlp: bool = True
    rope_fraction: float = 1.0   # fraction of head_dim that is rotated
    rope_theta: float = 10_000.0
    pos_emb: str = "rope"        # rope | learned | none
    tie_embeddings: bool = False
    prefix_len: int = 0          # stubbed modality prefix (vlm/audio conditioning)
    norm_eps: float = 1e-5
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    hybrid: Optional[HybridConfig] = None
    dtype: str = "bfloat16"      # activation/param compute dtype
    # sub-quadratic? full-attention archs must skip long_500k
    subquadratic: bool = False
    # attention chunking (pure-JAX flash-style path)
    q_chunk: int = 512
    kv_chunk: int = 1024
    # causal block-sparse attention: skip fully-masked kv blocks (beyond-paper perf opt)
    causal_block_skip: bool = False
    # flash custom-VJP attention for training (saves only (o, L) row stats;
    # backward rebuilds probability tiles — EXPERIMENTS.md §Perf)
    attn_custom_vjp: bool = False
    # unroll the decode layer loop: each layer's KV-cache update becomes an
    # independent in-place dynamic-update-slice (with donation), instead of
    # the scan threading full stacked caches through every iteration
    # (EXPERIMENTS.md §Perf, decode iteration 1)
    decode_unroll: bool = False
    max_seq_len: int = 32_768

    # ---- derived -------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def activation_dtype(self) -> torch.dtype:
        return _TORCH_DTYPES[self.dtype]

    def replace(self, **kw) -> "LMConfig":
        return dataclasses.replace(self, **kw)

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Analytic parameter count (used for 6·N·D model-FLOP accounting)."""
        d, hd = self.d_model, self.resolved_head_dim
        n_emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.family in ("dense", "vlm", "audio", "moe"):
            attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                + self.n_heads * hd * d
            if self.moe:
                mlp = d * self.moe.num_experts  # router
                mlp += self.moe.num_experts * (
                    d * self.d_ff * (3 if self.gated_mlp else 2))
            else:
                mlp = d * self.d_ff * (3 if self.gated_mlp else 2)
            per_layer = attn + mlp + 2 * d
        elif self.family == "ssm":
            x = self.xlstm or XLSTMConfig()
            di = d * x.proj_factor_m
            nh = self.n_heads
            dh = d // nh
            # mLSTM block: pre_norm + up(d,2di) + q/k/v(di,di) + wif(di,2nh)
            #              + headwise norm + down(di,d)
            m = d + 2 * d * di + 3 * di * di + 2 * di * nh + di + di * d
            # sLSTM block: pre_norm + W(d,4d) + R(nh,dh,4dh) + b(4d)
            #              + ffn_norm + gated FFN(3·d·ff)
            ff = x.ff_factor_s * d
            s = d + 4 * d * d + nh * dh * 4 * dh + 4 * d + d + 3 * d * ff
            n_s = self.n_layers // x.slstm_every
            total = n_s * s + (self.n_layers - n_s) * m
            return n_emb + total + d
        elif self.family == "hybrid":
            s = self.ssm or SSMConfig()
            d_inner = s.expand * d
            nheads = d_inner // s.head_dim
            in_proj = d * (2 * d_inner + 2 * s.n_groups * s.d_state + nheads)
            blk = in_proj + s.d_conv * (d_inner + 2 * s.n_groups * s.d_state) \
                + d_inner * d + 2 * d
            shared_attn = d * self.n_heads * hd * 2 \
                + 2 * d * self.n_kv_heads * hd + d * self.d_ff * 3
            return n_emb + self.n_layers * blk + shared_attn
        total = n_emb + self.n_layers * per_layer + d
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only top-k experts count)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        expert_p = d * self.d_ff * (3 if self.gated_mlp else 2)
        inactive = self.n_layers * (self.moe.num_experts - self.moe.top_k) * expert_p
        return self.param_count() - inactive


@dataclass(frozen=True)
class ShapeSuite:
    """One assigned (seq_len, global_batch) input-shape cell."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode | long_decode

    @property
    def is_decode(self) -> bool:
        return self.kind in ("decode", "long_decode")


SHAPES: Tuple[ShapeSuite, ...] = (
    ShapeSuite("train_4k", 4_096, 256, "train"),
    ShapeSuite("prefill_32k", 32_768, 32, "prefill"),
    ShapeSuite("decode_32k", 32_768, 128, "decode"),
    ShapeSuite("long_500k", 524_288, 1, "long_decode"),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def shape_applicable(cfg: LMConfig, shape: ShapeSuite) -> Tuple[bool, str]:
    """Whether a shape cell applies to an architecture (per assignment rules)."""
    if shape.kind == "long_decode" and not cfg.subquadratic:
        return False, "long_500k needs sub-quadratic attention; " \
                      f"{cfg.arch_id} is pure full-attention (skip per assignment)"
    return True, ""


def reduced(cfg: LMConfig) -> LMConfig:
    """A tiny same-family config for CPU smoke tests (shapes asserted, no NaNs)."""
    kw = dict(
        n_layers=2 if cfg.family not in ("ssm", "hybrid") else 4,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        prefix_len=min(cfg.prefix_len, 4),
        q_chunk=16,
        kv_chunk=16,
        max_seq_len=128,
    )
    if cfg.moe:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2))
    if cfg.ssm:
        kw["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=8, head_dim=16, expand=2, chunk_size=16)
    if cfg.xlstm:
        kw["xlstm"] = dataclasses.replace(cfg.xlstm, chunk_size=16)
    if cfg.hybrid:
        kw["hybrid"] = dataclasses.replace(cfg.hybrid, attn_every=2)
    return cfg.replace(**kw)
