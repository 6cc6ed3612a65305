"""Mamba-2 SSD chunked scan: the hand-written CUDA kernel, its wrapper, and
its plain PyTorch version.

Replaces the Pallas TPU kernel ``repro.kernels.ssd_scan.ssd_scan_kernel``
and computes what ``repro.models.ssm.ssd_scan`` computes, in model layout:
x (b, s, nh, P), dt (b, s, nh), A (nh,), B/C (b, s, g, N), an optional
``init_state`` (b, nh, P, N) -> y (b, s, nh, P) and the final state
(b, nh, P, N). The kernel (``csrc/ssd_scan.cu``) reads x, B and C through
their strides (column slices of the conv output, not copied), head ``h``
reads group ``h // (nh / g)`` (B/C are not repeated to every head), and
one block per (b, head) loops over the chunks in order with the N×P state
in registers (at N = 128 in all 8 warps, one block per SM), its
products on the tensor cores (bf16 operands rounded
where ``repro.models.ssm`` rounds them, fp32 accumulation) and the next
chunk's x/B/C in flight. A ragged last chunk is masked: steps past ``s``
are never read and act as dt = 0 (no decay, no state write), as the
padding of the reference does.

``ssd_scan`` launches the kernel for CUDA tensors (x/B/C bf16, dt/A/
``init_state`` fp32, (P, N) in ``SHAPES``, chunk a multiple of 8 up to 128)
and raises on anything it does not take; for CPU tensors it computes
``ssd_scan_plain``. ``launches`` counts kernel launches. On the meta
device under abstract evaluation (the dry run's ``kernels.cost.recording``)
it launches nothing: it returns empty outputs of the kernel's shapes and
dtypes and charges its work.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build, cost, launch_count
from repro_torch.kernels._checks import (check_cuda_bf16, check_no_grad,
                                         check_rows)

NEG_INF = -1e30
#: (head dim P, state size N) pairs the kernel is instantiated for
SHAPES = ((16, 8), (64, 64), (64, 128))
#: the largest chunk the kernel's shared memory is sized for
MAX_CHUNK = 128
#: kernel launches made by ssd_scan() (the CUDA route only), counted
#: through ``launch_count``, which keeps them exact under CUDA graphs
launches = 0
_launches_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    fn = lib.repro_ssd_scan_bf16
    fn.argtypes = [_P, _P, _P, _P, _P, _P, _P, _P,
                   _I, _I, _I, _I, _I, _I, _I,
                   _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L, _L,
                   _I, _P]
    fn.restype = _I
    occ = lib.repro_ssd_scan_occupancy
    occ.argtypes = [_I, _I, _I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
    occ.restype = _I
    return lib


def occupancy(P: int, N: int, device: torch.device) -> Tuple[int, int]:
    """(resident blocks per SM, dynamic shared memory bytes per block) of
    the kernel for (P, N) on a CUDA ``device``."""
    blocks, smem = _I(), _I()
    rc = _lib().repro_ssd_scan_occupancy(
        P, N, device.index or 0, ctypes.byref(blocks), ctypes.byref(smem))
    if rc:
        raise RuntimeError(f"ssd_scan occupancy query failed: CUDA error "
                           f"{rc}")
    return blocks.value, smem.value


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                   B: torch.Tensor, C: torch.Tensor, chunk: int,
                   init_state: Optional[torch.Tensor] = None) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """The same function in plain PyTorch, step for step as
    ``repro.models.ssm.ssd_scan``, its roundings to x's dtype included
    (the decay-masked weights, the state-write weights and exp(cum)·C)."""
    b, s, nh, hd = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = nh // g
    Q = min(chunk, s)
    s0 = s
    pad = (-s) % Q
    if pad:
        # dt = 0 on padded steps: no decay and no state write, so the
        # final state is exactly the state at s0
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
        s += pad
    nc = s // Q
    xc = x.reshape(b, nc, Q, nh, hd)
    dtc = dt.reshape(b, nc, Q, nh)
    Bc = B.repeat_interleave(rep, dim=2).reshape(b, nc, Q, nh, n)
    Cc = C.repeat_interleave(rep, dim=2).reshape(b, nc, Q, nh, n)

    cum = torch.cumsum(dtc * A, dim=2)                       # (b,nc,Q,nh)
    # intra-chunk: y[i] = sum_{j<=i} exp(cum_i - cum_j) dt_j (C_i·B_j) x_j
    Lmat = cum[:, :, :, None, :] - cum[:, :, None, :, :]      # (b,nc,Q,Q,nh)
    upper = torch.ones((Q, Q), dtype=torch.bool, device=x.device).triu(1)
    Lmat = Lmat.masked_fill(upper[None, None, :, :, None], NEG_INF)
    scores = torch.einsum("bcqhn,bckhn->bcqkh", Cc.float(), Bc.float())
    wgt = torch.exp(Lmat) * scores * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", wgt.to(x.dtype).float(),
                           xc.float())

    # chunk end-states: S_c = sum_j exp(cum_last - cum_j) dt_j B_j ⊗ x_j
    decay_end = torch.exp(cum[:, :, -1:, :] - cum)
    sw = (decay_end * dtc).to(x.dtype)
    states = torch.einsum("bckhn,bckhp->bchnp", (Bc * sw[..., None]).float(),
                          xc.float())                         # (b,nc,nh,n,hd)
    chunk_decay = torch.exp(cum[:, :, -1, :])                 # (b, nc, nh)
    S = torch.zeros((b, nh, n, hd), dtype=torch.float32, device=x.device) \
        if init_state is None else init_state.transpose(2, 3).float()
    S_in = []
    for c in range(nc):                  # the state entering each chunk
        S_in.append(S)
        S = S * chunk_decay[:, c, :, None, None] + states[:, c]
    y_inter = torch.einsum(
        "bcqhn,bchnp->bcqhp",
        (Cc * torch.exp(cum)[..., None]).to(x.dtype).float(),
        torch.stack(S_in, dim=1))
    y = (y_intra + y_inter).reshape(b, s, nh, hd)[:, :s0]
    return y.to(x.dtype), S.transpose(2, 3)


def _check_cuda(x, dt, A, B, C, chunk, init_state):
    check_cuda_bf16(x.device, x=x, B=B, C=C)
    if x.dim() != 4 or B.dim() != 4 or B.shape != C.shape:
        raise ValueError(f"expected x (b, s, nh, P) and B, C (b, s, g, N); "
                         f"got {tuple(x.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    b, s, nh, P = x.shape
    g, N = B.shape[2], B.shape[3]
    if B.shape[:2] != (b, s) or nh % g:
        raise ValueError(f"x {tuple(x.shape)} does not match B/C "
                         f"{tuple(B.shape)}")
    if (P, N) not in SHAPES:
        raise ValueError(f"(P, N) = {(P, N)} not in {SHAPES}")
    if chunk % 8 or not 8 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk}: the kernel takes a multiple of 8 "
                         f"up to {MAX_CHUNK}")
    if s < 1 or b * nh >= 2 ** 31:
        raise ValueError(f"unsupported sizes: s={s} b*nh={b * nh}")
    for name, t, shape in (("dt", dt, (b, s, nh)), ("A", A, (nh,))):
        if t.device != x.device or t.dtype != torch.float32 \
                or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a float32 {shape} tensor on "
                             f"{x.device}")
    if not A.is_contiguous():
        raise ValueError("A must be contiguous")
    if init_state is not None and (
            init_state.device != x.device
            or init_state.dtype != torch.float32
            or tuple(init_state.shape) != (b, nh, P, N)):
        raise ValueError(f"init_state must be a float32 {(b, nh, P, N)} "
                         f"tensor on {x.device}")
    for name, t in (("x", x), ("B", B), ("C", C)):
        check_rows(name, t)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int,
             init_state: Optional[torch.Tensor] = None) \
        -> Tuple[torch.Tensor, torch.Tensor]:
    """x (b, s, nh, P); dt (b, s, nh); A (nh,); B, C (b, s, g, N);
    init_state (b, nh, P, N) or None -> (y (b, s, nh, P), final state
    (b, nh, P, N) fp32)."""
    if x.device.type == "meta" and cost.evaluating():
        check_no_grad("ssd_scan", x=x, dt=dt, A=A, B=B, C=C,
                      init_state=init_state)
        b, s, nh, P = x.shape
        g, N = B.shape[2], B.shape[3]
        cost.charge("ssd_scan", cost.ssd_flops(b, s, nh, P, N, chunk),
                    cost.ssd_bytes(b, s, nh, P, g, N, init_state is not None))
        return (torch.empty((b, s, nh, P), dtype=x.dtype, device=x.device),
                torch.empty((b, nh, P, N), dtype=torch.float32,
                            device=x.device))
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk, init_state)
    check_no_grad("ssd_scan", x=x, dt=dt, A=A, B=B, C=C,
                  init_state=init_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on CUDA or the CPU, not {x.device}")
    _check_cuda(x, dt, A, B, C, chunk, init_state)
    b, s, nh, P = x.shape
    g, N = B.shape[2], B.shape[3]
    if init_state is not None:
        init_state = init_state.contiguous()
    y = torch.empty((b, s, nh, P), dtype=x.dtype, device=x.device)
    state = torch.empty((b, nh, P, N), dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device)
    rc = _lib().repro_ssd_scan_bf16(
        x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), None if init_state is None else init_state.data_ptr(),
        y.data_ptr(), state.data_ptr(), b, s, nh, g, chunk, P, N,
        x.stride(0), x.stride(1), x.stride(2),
        dt.stride(0), dt.stride(1), dt.stride(2),
        B.stride(0), B.stride(1), B.stride(2),
        C.stride(0), C.stride(1), C.stride(2),
        x.device.index, stream.cuda_stream)
    if rc:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {rc}")
    launch_count.launched("ssd_scan", stream)
    return y, state
