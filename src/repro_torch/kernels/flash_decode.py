"""Flash-decode: the hand-written CUDA kernel, its wrapper, and its plain
PyTorch versions.

Replaces the Pallas TPU kernel ``repro.kernels.flash_decode``. The kernel
(``csrc/flash_decode.cu``) takes one query row per head, q (b, 1, h, d),
against the caches (b, S, kvh, d) read through their strides (a layer's
slice of the stacked cache, not copied), stops at ``kv_len[b]`` read from
device memory, and writes o (b, 1, h, d). The cache is split across
``n_split`` blocks per (b, kv head), each serving all h/kvh query heads of
that kv head; the last block of each to finish merges the splits.

``flash_decode`` launches the kernel for CUDA tensors (bf16, head dims
16/32/64/96/128, h/kvh in 1/2/4/8) and raises on anything it does not
take; for CPU tensors it computes ``flash_decode_plain``. ``launches``
counts kernel launches (one per call). ``flash_decode_split_plain``
computes the function the way the kernel cuts it, for the tests. On the
meta device under abstract evaluation (the dry run's
``kernels.cost.recording``) it launches nothing: it returns an empty
output and charges the work of reading every cache row.
Precondition: ``kv_len >= 1``.
"""
from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import _build, cost, launch_count
from repro_torch.kernels._checks import (HEAD_DIMS, check_cuda_bf16,
                                         check_no_grad, check_rows)

NEG_INF = -1e30
#: query heads per kv head the kernel is instantiated for
GROUPS = (1, 2, 4, 8)
#: cache rows of one warp's tile (the kernel's 4 warps take turns)
TILE_ROWS = 16
#: the fewest rows of the padded cache a split is given (four tiles for
#: each warp): shorter splits were slower at every shape chip_smoke.py
#: times, since the merge costs round trips to L2 that they cannot hide
MIN_SPLIT_ROWS = 16 * TILE_ROWS
#: the most blocks along the cache per (b, kv head)
MAX_SPLIT = 64
#: kernel launches made by flash_decode() (the CUDA route only), counted
#: through ``launch_count``, which keeps them exact under CUDA graphs
launches = 0
_launches_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: (device index, stream, b * kv heads) -> the split merge's int32
#: tickets, one per (b, kv head), zero between calls (the merging block
#: resets its own). A buffer is never replaced or freed: a captured CUDA
#: graph keeps the address it was given
_counters: Dict[Tuple[int, int, int], torch.Tensor] = {}


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_decode")
    fn = lib.repro_flash_decode_bf16
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   _L, _L, _L, _L, _L, _L, _L, _L,
                   ctypes.c_float, _I, _P]
    fn.restype = _I
    occ = lib.repro_flash_decode_occupancy
    occ.argtypes = [_I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    occ.restype = _I
    return lib


def occupancy(d: int, group: int, device: torch.device) -> Tuple[int, int]:
    """(resident blocks per SM, dynamic shared memory bytes per block) of
    the kernel for head dim ``d`` and ``group`` query heads per kv head on
    a CUDA ``device``."""
    blocks, smem = _I(), _I()
    rc = _lib().repro_flash_decode_occupancy(
        d, group, device.index or 0, ctypes.byref(blocks),
        ctypes.byref(smem))
    if rc:
        raise RuntimeError(f"flash_decode occupancy query failed: CUDA error "
                           f"{rc}")
    return blocks.value, smem.value


def split_count(b: int, kvh: int, S: int, n_sm: int) -> int:
    """Blocks along the cache for each (b, kv head): about two blocks per
    SM over the grid, at most one per ``MIN_SPLIT_ROWS`` rows of the
    padded cache and at most ``MAX_SPLIT``. Only sizes the host already
    has: the kernel reads ``kv_len`` itself and deals its rows evenly to
    the splits, so nothing waits on the device."""
    want = max(1, 2 * n_sm // (b * kvh))
    return max(1, min(want, S // MIN_SPLIT_ROWS, MAX_SPLIT))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _tickets(device: torch.device, stream: torch.cuda.Stream,
             n: int) -> torch.Tensor:
    key = (device.index, stream.cuda_stream, n)
    buf = _counters.get(key)
    if buf is None:
        buf = _counters[key] = torch.zeros(n, dtype=torch.int32,
                                           device=device)
    return buf


def flash_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                       v_cache: torch.Tensor,
                       kv_len: torch.Tensor) -> torch.Tensor:
    """The same function in plain PyTorch. Raises unless every
    ``kv_len >= 1`` (the Pallas kernel and the jnp oracle disagree at 0)."""
    b, _, h, d = q.shape
    S, g = k_cache.shape[1], k_cache.shape[2]
    kv_len = kv_len.reshape(-1)
    if not bool((kv_len >= 1).all()):
        raise ValueError("flash_decode needs kv_len >= 1 for every row")
    qg = q.float().reshape(b, g, h // g, d)
    s = torch.einsum("bgmd,bkgd->bgmk", qg, k_cache.float()) / math.sqrt(d)
    mask = torch.arange(S, device=q.device)[None, :] < kv_len[:, None]
    s = s.masked_fill(~mask[:, None, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1).to(v_cache.dtype).float()
    o = torch.einsum("bgmk,bkgd->bgmd", p, v_cache.float())
    return o.reshape(b, 1, h, d).to(q.dtype)


def flash_decode_split_plain(q: torch.Tensor, k_cache: torch.Tensor,
                             v_cache: torch.Tensor, kv_len: torch.Tensor,
                             n_split: int) -> torch.Tensor:
    """``flash_decode_plain``'s function computed the way the kernel cuts
    it: the first ``kv_len[b]`` rows in ``TILE_ROWS``-row tiles, dealt
    evenly to ``n_split`` splits; per split its max m, sum l and
    unnormalised P V (P in v's dtype); then O = sum_s e^(m_s - M) acc_s /
    max(sum_s e^(m_s - M) l_s, 1e-37). An empty split is (NEG_INF, 0, 0)
    and weighs 0. For the tests; the main path never calls it."""
    b, _, h, d = q.shape
    S, g = k_cache.shape[1], k_cache.shape[2]
    kv_len = kv_len.reshape(-1)
    if not bool((kv_len >= 1).all()):
        raise ValueError("flash_decode needs kv_len >= 1 for every row")
    qg = q.float().reshape(b, g, h // g, d) / math.sqrt(d)
    out = []
    for bi in range(b):
        n = min(int(kv_len[bi]), S)
        tiles = -(-n // TILE_ROWS)
        per = -(-tiles // n_split) * TILE_ROWS     # rows of each split
        ms, ls, accs = [], [], []
        for sp in range(n_split):
            r0, r1 = min(sp * per, n), min((sp + 1) * per, n)
            if r0 == r1:
                ms.append(torch.full((g, h // g), NEG_INF, device=q.device))
                ls.append(torch.zeros(g, h // g, device=q.device))
                accs.append(torch.zeros(g, h // g, d, device=q.device))
                continue
            s = torch.einsum("gmd,kgd->gmk", qg[bi],
                             k_cache[bi, r0:r1].float())
            m = s.amax(-1)
            p = torch.exp(s - m[..., None])
            ms.append(m)
            ls.append(p.sum(-1))
            accs.append(torch.einsum("gmk,kgd->gmd",
                                     p.to(v_cache.dtype).float(),
                                     v_cache[bi, r0:r1].float()))
        m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
        w = torch.exp(m - m.amax(0))
        out.append((w[..., None] * acc).sum(0)
                   / torch.clamp((w * l).sum(0), min=1e-37)[..., None])
    return torch.stack(out).reshape(b, 1, h, d).to(q.dtype)


def flash_decode(q: torch.Tensor, k_cache: torch.Tensor,
                 v_cache: torch.Tensor, kv_len: torch.Tensor, *,
                 n_split: Optional[int] = None) -> torch.Tensor:
    """q (b, 1, h, d); caches (b, S, kvh, d); kv_len (b,) int32 ->
    (b, 1, h, d). ``n_split`` (CUDA only) overrides ``split_count``: the
    tests force the merge with it, chip_smoke.py times other counts."""
    if q.device.type == "meta" and cost.evaluating():
        check_no_grad("flash_decode", q=q, k_cache=k_cache, v_cache=v_cache)
        # kv_len has no values here: every row of the cache is charged
        b, _, h, d = q.shape
        _, S, g, _ = k_cache.shape
        cost.charge("flash_decode", cost.decode_flops(b * S, h, d),
                    cost.decode_bytes(b, h, g, d, b * S))
        return torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    if q.device.type == "cpu":
        return flash_decode_plain(q, k_cache, v_cache, kv_len)
    check_no_grad("flash_decode", q=q, k_cache=k_cache, v_cache=v_cache)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on CUDA or the CPU, not "
                         f"{q.device}")
    check_cuda_bf16(q.device, q=q, k_cache=k_cache, v_cache=v_cache)
    if q.dim() != 4 or q.shape[1] != 1 or k_cache.dim() != 4 \
            or k_cache.shape != v_cache.shape:
        raise ValueError(f"expected q (b, 1, h, d) and caches (b, S, kvh, "
                         f"d); got {tuple(q.shape)}, {tuple(k_cache.shape)},"
                         f" {tuple(v_cache.shape)}")
    b, _, h, d = q.shape
    _, S, g, _ = k_cache.shape
    if k_cache.shape[0] != b or k_cache.shape[3] != d or h % g:
        raise ValueError(f"q {tuple(q.shape)} does not match the caches "
                         f"{tuple(k_cache.shape)}")
    if d not in HEAD_DIMS or h // g not in GROUPS:
        raise ValueError(f"head dim {d} / group {h // g} not in "
                         f"{HEAD_DIMS} / {GROUPS}")
    if kv_len.device != q.device or kv_len.dtype != torch.int32 \
            or kv_len.shape != (b,) or not kv_len.is_contiguous():
        raise ValueError(f"kv_len must be a contiguous ({b},) int32 tensor "
                         f"on {q.device}")
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        check_rows(name, t)
    if n_split is None:
        n_split = split_count(b, g, S, _sm_count(q.device.index))
    elif not 1 <= n_split <= MAX_SPLIT:
        raise ValueError(f"n_split {n_split} not in [1, {MAX_SPLIT}]")
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device)
    part = tickets = None
    if n_split > 1:
        part = torch.empty(b * g * n_split * (h // g) * (d + 2),
                           dtype=torch.float32, device=q.device)
        tickets = _tickets(q.device, stream, b * g)
    rc = _lib().repro_flash_decode_bf16(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        kv_len.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(),
        None if tickets is None else tickets.data_ptr(),
        b, S, h, g, d, n_split,
        q.stride(0), q.stride(2),
        k_cache.stride(0), k_cache.stride(1), k_cache.stride(2),
        v_cache.stride(0), v_cache.stride(1), v_cache.stride(2),
        1.0 / math.sqrt(d), q.device.index, stream.cuda_stream)
    if rc:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{rc}")
    launch_count.launched("flash_decode", stream)
    return out
