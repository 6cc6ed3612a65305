"""Mamba-2 one-token state step (S1): the hand-written CUDA kernel, its
wrapper, and its plain PyTorch version.

Replaces no TPU kernel: the JAX package's decode step
(``repro.models.ssm.mamba2_decode_step``) is plain jnp, and the port ran
it as an eager chain, which ``ssm_state_step_plain`` keeps. In model
layout: the state (b, nh, P, N) fp32, updated in place
(a cache slice, read through its (b, head) strides); x (b, nh, P) and B, C
(b, g, N) in the conv output's dtype, read through their strides (column
slices of the conv output, not copied); dt (b, nh) fp32 after the
softplus; A_log and D (nh,) fp32 -> the read-out y (b, nh, P) fp32. Head
``h`` reads group ``h // (nh / g)``: B and C are not repeated to every
head. The kernel (``csrc/ssm_state_step.cu``) passes over the state once.

``ssm_state_step`` launches the kernel for CUDA tensors (x/B/C bf16, (P, N)
in ``SHAPES``) and raises on anything it does not take; for CPU tensors it
computes ``ssm_state_step_plain``; on meta tensors under
``cost.evaluating()`` (the dry run) it charges the kernel's cost and
returns an empty y. It allocates only y, launches on the
current stream and does not synchronise, so a CUDA graph captures it.
``launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import torch

from repro_torch.kernels import _build, cost, launch_count
from repro_torch.kernels._checks import check_no_grad, check_rows

#: (head dim P, state size N) pairs the kernel is instantiated for
SHAPES = ((16, 8), (64, 64), (64, 128))
#: kernel launches made by ssm_state_step() (the CUDA route only), counted
#: through ``launch_count``, which keeps them exact under CUDA graphs
launches = 0
_launches_lock = threading.Lock()

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def _lib() -> ctypes.CDLL:
    lib = _build.load("ssm_state_step")
    fn = lib.repro_ssm_state_step
    fn.argtypes = [_P] * 8 + [_I] * 5 + [_L] * 10 + [_I, _P]
    fn.restype = _I
    occ = lib.repro_ssm_state_step_occupancy
    occ.argtypes = [_I, _I, _I] + [ctypes.POINTER(_I)] * 3
    occ.restype = _I
    return lib


class Occupancy(NamedTuple):
    """How the (P, N) instantiation runs on one card."""
    blocks: int         # resident blocks of 256 threads per SM
    registers: int      # registers a thread
    local_bytes: int    # local memory a thread (register spills)


def occupancy(P: int, N: int, device: torch.device) -> Occupancy:
    """The kernel's occupancy at (P, N) on a CUDA ``device``."""
    vals = [_I() for _ in range(3)]
    rc = _lib().repro_ssm_state_step_occupancy(
        P, N, device.index or 0, *(ctypes.byref(v) for v in vals))
    if rc:
        raise RuntimeError(f"ssm_state_step occupancy query failed: CUDA "
                           f"error {rc}")
    return Occupancy(*(v.value for v in vals))


def ssm_state_step_plain(state: torch.Tensor, x: torch.Tensor,
                         dt: torch.Tensor, A_log: torch.Tensor,
                         B: torch.Tensor, C: torch.Tensor,
                         D: torch.Tensor) -> torch.Tensor:
    """The same step in plain PyTorch, the eager chain the port ran before
    the kernel: x, B and C cast to fp32, B and C repeated to every head.
    Updates ``state`` in place; returns y."""
    rep = x.shape[1] // B.shape[1]
    xf = x.float()
    Bh = B.float().repeat_interleave(rep, dim=1)
    Ch = C.float().repeat_interleave(rep, dim=1)
    dA = torch.exp(dt * -torch.exp(A_log))
    state.mul_(dA[..., None, None]).add_(
        (xf * dt[..., None])[..., :, None] * Bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return y + D[:, None] * xf


def _check(state, x, dt, A_log, B, C, D):
    dev = state.device
    for name, t in (("x", x), ("B", B), ("C", C)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name}: the CUDA kernel takes bfloat16, got "
                            f"{t.dtype}")
    if state.dim() != 4 or x.dim() != 3 or B.dim() != 3 \
            or B.shape != C.shape:
        raise ValueError(f"expected state (b, nh, P, N), x (b, nh, P) and "
                         f"B, C (b, g, N); got {tuple(state.shape)}, "
                         f"{tuple(x.shape)}, {tuple(B.shape)}, "
                         f"{tuple(C.shape)}")
    b, nh, P, N = state.shape
    g = B.shape[1]
    if tuple(x.shape) != (b, nh, P) or B.shape[0] != b or B.shape[2] != N \
            or nh % g:
        raise ValueError(f"state {tuple(state.shape)} does not match x "
                         f"{tuple(x.shape)} and B/C {tuple(B.shape)}")
    if (P, N) not in SHAPES:
        raise ValueError(f"(P, N) = {(P, N)} not in {SHAPES}")
    if b * nh >= 2 ** 31:
        raise ValueError(f"unsupported sizes: b*nh={b * nh}")
    if state.dtype != torch.float32 or state.stride(3) != 1 \
            or state.stride(2) != N or state.stride(0) % 4 \
            or state.stride(1) % 4 or state.data_ptr() % 16:
        raise ValueError(f"state: needs float32 with a contiguous (P, N) "
                         f"tile, (b, head) strides that are multiples of 4 "
                         f"and a 16-byte aligned start; got {state.dtype}, "
                         f"strides {tuple(state.stride())}")
    for name, t, shape in (("dt", dt, (b, nh)), ("A_log", A_log, (nh,)),
                           ("D", D, (nh,))):
        if t.device != dev or t.dtype != torch.float32 \
                or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be a float32 {shape} tensor on "
                             f"{dev}")
    if not (A_log.is_contiguous() and D.is_contiguous()):
        raise ValueError("A_log and D must be contiguous")
    for name, t in (("x", x), ("B", B), ("C", C)):
        check_rows(name, t)


def ssm_state_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                   A_log: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                   D: torch.Tensor) -> torch.Tensor:
    """state (b, nh, P, N) fp32, updated in place; x (b, nh, P); dt (b, nh)
    fp32; A_log, D (nh,) fp32; B, C (b, g, N) -> y (b, nh, P) fp32."""
    if state.device.type == "meta" and cost.evaluating():
        check_no_grad("ssm_state_step", state=state, x=x, dt=dt,
                      A_log=A_log, B=B, C=C, D=D)
        b, nh, P, N = state.shape
        cost.charge("ssm_state_step", cost.ssm_state_step_flops(b, nh, P, N),
                    cost.ssm_state_step_bytes(b, nh, P, B.shape[1], N))
        return torch.empty((b, nh, P), dtype=torch.float32,
                           device=state.device)
    if state.device.type == "cpu":
        return ssm_state_step_plain(state, x, dt, A_log, B, C, D)
    check_no_grad("ssm_state_step", state=state, x=x, dt=dt, A_log=A_log,
                  B=B, C=C, D=D)
    _check(state, x, dt, A_log, B, C, D)
    if state.device.type != "cuda":
        raise ValueError(f"ssm_state_step runs on CUDA or the CPU, not "
                         f"{state.device}")
    b, nh, P, N = state.shape
    g = B.shape[1]
    y = torch.empty((b, nh, P), dtype=torch.float32, device=state.device)
    stream = torch.cuda.current_stream(state.device)
    rc = _lib().repro_ssm_state_step(
        state.data_ptr(), x.data_ptr(), dt.data_ptr(), A_log.data_ptr(),
        B.data_ptr(), C.data_ptr(), D.data_ptr(), y.data_ptr(), b, nh, g, P,
        N, state.stride(0), state.stride(1), x.stride(0), x.stride(1),
        dt.stride(0), dt.stride(1), B.stride(0), B.stride(1), C.stride(0),
        C.stride(1), state.device.index, stream.cuda_stream)
    if rc:
        raise RuntimeError(f"ssm_state_step kernel launch failed: CUDA "
                           f"error {rc}")
    launch_count.launched("ssm_state_step", stream)
    return y
