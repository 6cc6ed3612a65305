"""Model-layout entry points of the CUDA kernels (counterparts of the JAX
package's ``repro.kernels.ops``). The kernels read the model layout through
strides, so unlike the JAX wrappers these transpose nothing."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_decode import flash_decode
from repro_torch.kernels.ssd_scan import ssd_scan
from repro_torch.kernels.ssm_state_step import ssm_state_step


def attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   n_heads: int, n_kv_heads: int, causal: bool = True,
                   q_offset: int = 0, return_lse: bool = False):
    """Model layout: q (b, s, h, d); k/v (b, s, kvh, d) -> (b, s, h, d), and
    with ``return_lse`` also the fp32 row log-sum-exp (b, h, s)."""
    if q.shape[2] != n_heads or k.shape[2] != n_kv_heads:
        raise ValueError(f"heads {q.shape[2]}/{k.shape[2]} != "
                         f"{n_heads}/{n_kv_heads}")
    return flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                           return_lse=return_lse)


def decode_attention_bshd(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                          n_heads: int, n_kv_heads: int) -> torch.Tensor:
    """q (b, 1, h, d); caches (b, S, kvh, d); kv_len (b,) -> (b, 1, h, d)."""
    if q.shape[2] != n_heads or k_cache.shape[2] != n_kv_heads:
        raise ValueError(f"heads {q.shape[2]}/{k_cache.shape[2]} != "
                         f"{n_heads}/{n_kv_heads}")
    return flash_decode(q, k_cache, v_cache, kv_len)


def ssd_bshn(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, *, chunk: int = 128,
             init_state: Optional[torch.Tensor] = None) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """Model layout: x (b, s, nh, p); dt (b, s, nh); A (nh,); B/C
    (b, s, g, n); init_state (b, nh, p, n) or None -> (y (b, s, nh, p),
    final state (b, nh, p, n)). Unlike the JAX wrapper, B/C are not
    repeated to every head and A is not tiled: the kernel reads group
    ``h // (nh / g)`` for head ``h``."""
    if x.shape[2] % B.shape[2]:
        raise ValueError(f"{x.shape[2]} heads are not a multiple of "
                         f"{B.shape[2]} groups")
    return ssd_scan(x, dt, A, B, C, chunk, init_state)


def ssm_step_bhpn(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                  A_log: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                  D: torch.Tensor) -> torch.Tensor:
    """Model layout of one decode token: state (b, nh, p, n) fp32, updated
    in place; x (b, nh, p); dt (b, nh); A_log, D (nh,); B/C (b, g, n) ->
    y (b, nh, p) fp32. B/C are not repeated to every head: the kernel
    reads group ``h // (nh / g)`` for head ``h``."""
    return ssm_state_step(state, x, dt, A_log, B, C, D)
