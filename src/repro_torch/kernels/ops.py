"""Model-layout entry points of the CUDA kernels (counterparts of the JAX
package's ``repro.kernels.ops``). The kernels read the model layout through
strides, so unlike the JAX wrappers these transpose nothing."""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode


def attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   n_heads: int, n_kv_heads: int, causal: bool = True,
                   q_offset: int = 0) -> torch.Tensor:
    """Model layout: q (b, s, h, d); k/v (b, s, kvh, d) -> (b, s, h, d)."""
    if q.shape[2] != n_heads or k.shape[2] != n_kv_heads:
        raise ValueError(f"heads {q.shape[2]}/{k.shape[2]} != "
                         f"{n_heads}/{n_kv_heads}")
    return flash_attention(q, k, v, causal=causal, q_offset=q_offset)


def decode_attention_bshd(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                          n_heads: int, n_kv_heads: int) -> torch.Tensor:
    """q (b, 1, h, d); caches (b, S, kvh, d); kv_len (b,) -> (b, 1, h, d)."""
    if q.shape[2] != n_heads or k_cache.shape[2] != n_kv_heads:
        raise ValueError(f"heads {q.shape[2]}/{k_cache.shape[2]} != "
                         f"{n_heads}/{n_kv_heads}")
    return flash_decode(q, k_cache, v_cache, kv_len)
