"""The trainer's AdamW step (B8): the hand-written CUDA kernel that combines
the chunks' gradients, clips them by the global norm and applies AdamW, its
wrapper, and its plain PyTorch version.

Replaces no TPU kernel: the JAX package's optimizer
(``repro.train.optimizer.adamw_update``) is plain JAX. The port ran it, after
the trainer's combine of its chunks' gradients, as some twenty eager fp32
passes a leaf; ``grad_norm_plain`` and ``adamw_step_plain`` keep them.

The gradients come as ``grads[i]``: leaf ``i``'s gradient from each of the
K chunks, in the parameter's dtype (bf16 or fp32), and ``counts``: each
chunk's example count n_c. The combined gradient of a leaf is
``(g_0 n_0 + ... + g_K-1 n_K-1) / N``, N = sum n_c, in fp32. Two passes
over every leaf (``csrc/adamw_step.cu``), each one launch over all of them:

1. ``grad_norm``: the combined gradient's global norm and the clip scale
   ``min(clip / max(norm, 1e-9), 1)``, both kept on the device
   (``GradNorm``); each block sums its squares into a partial, and a second
   launch sums those in a fixed order, so the norm repeats its bits;
2. ``adamw_step``: the combined gradient again, times the scale, then
   AdamW into m, v and the fp32 master weights in place, and the master
   weights into the parameter in its dtype.

The combined gradient is never stored. At stablelm-1.6b (1.645e9 bf16
parameters) and K = 4 the passes move 2K + (2K + 26) = 42 bytes a
parameter: 69.1 GB, 20.6 ms at 3.35 TB/s (``cost.adamw_*_bytes``).

For CUDA tensors the wrappers launch the kernels (each leaf contiguous and
16-byte aligned, gradients and parameter of one dtype, bf16 or fp32) and
raise on anything else; for CPU and meta tensors they compute the plain
versions. Under ``cost.evaluating()`` (the dry run) they charge the
passes' bytes on meta tensors: the plain versions give the outputs' shapes
and, on the dry run's sharded DTensors, the collectives that the update
needs (the gradients reduced to the shards of the state, the norm's sum
over the shards). On the card they launch on the current stream, never
synchronise, and allocate only a pass's table and the norm's scratch.
``launches`` counts kernel launches: two for ``grad_norm``, one for
``adamw_step``.
"""
from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build, cost, launch_count

#: kernel launches made by grad_norm() and adamw_step() (the CUDA route
#: only), counted through ``launch_count``
launches = 0
_launches_lock = threading.Lock()
#: the kernels' tile: 256 threads of 8 elements
TILE = 2048
#: the leaf dtypes the kernels take (the gradients' and the parameter's)
DTYPES = (torch.bfloat16, torch.float32)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_grids: Dict[Tuple[str, int], int] = {}


def _lib() -> ctypes.CDLL:
    lib = _build.load("adamw_step")
    norm = lib.repro_adamw_norm
    norm.argtypes = [_P, _I, _I, _F, _I, _P, _F, _P, _I, _P]
    norm.restype = _I
    upd = lib.repro_adamw_update
    upd.argtypes = [_P, _P, _I, _I, _F, _P] + [_F] * 9 + [_I, _I, _P]
    upd.restype = _I
    occ = lib.repro_adamw_occupancy
    occ.argtypes = [_I, _I] + [ctypes.POINTER(_I)] * 3
    occ.restype = _I
    return lib


class Occupancy(NamedTuple):
    """How a pass's kernel runs on one card."""
    blocks: int         # resident blocks of 256 threads per SM
    registers: int      # registers a thread
    local_bytes: int    # local memory a thread (register spills)


def occupancy(which: str, device: torch.device) -> Occupancy:
    """The ``"norm"`` or ``"update"`` pass's kernel on a CUDA ``device``."""
    vals = [_I() for _ in range(3)]
    rc = _lib().repro_adamw_occupancy(
        ("norm", "update").index(which), device.index or 0,
        *(ctypes.byref(v) for v in vals))
    if rc:
        raise RuntimeError(f"adamw_step occupancy query failed: CUDA error "
                           f"{rc}")
    return Occupancy(*(v.value for v in vals))


def _grid(which: str, device: torch.device) -> int:
    """A pass's persistent grid: the SMs times its kernel's blocks resident
    on each; the same on every call, so the norm's partials are summed
    alike."""
    key = (which, device.index or 0)
    if key not in _grids:
        sms = torch.cuda.get_device_properties(key[1]).multi_processor_count
        _grids[key] = sms * occupancy(which, device).blocks
    return _grids[key]


class GradNorm(NamedTuple):
    """The norm pass's result: the global norm of the combined gradient
    and the clip scale, 0-d fp32 tensors on the gradients' device; and
    what the update pass reads again: the plain version's combined fp32
    leaves, or the kernel's table of the leaves on the card."""
    norm: torch.Tensor
    scale: torch.Tensor
    combined: Optional[List[torch.Tensor]] = None
    table: Optional[torch.Tensor] = None


class Hyper(NamedTuple):
    """AdamW's step as host floats: the learning rate, the betas, eps, the
    weight decay and the bias corrections 1 - beta ** step."""
    lr: float
    beta1: float
    beta2: float
    eps: float
    weight_decay: float
    bc1: float
    bc2: float


def _f32_reciprocal(x: float) -> float:
    """1 / x in fp32, as PyTorch on the card divides by a host scalar."""
    one = torch.ones((), dtype=torch.float32)
    return float(one / torch.tensor(x, dtype=torch.float32))


# ---------------------------------------------------------------------------
# the plain versions
# ---------------------------------------------------------------------------

def combine_plain(grads: Sequence[Sequence[torch.Tensor]],
                  counts: Sequence[float]) -> List[torch.Tensor]:
    """Each leaf's combined fp32 gradient, summed in chunk order, as the
    trainer combined them before the kernel."""
    total = sum(counts)
    out = []
    for leaves in grads:
        acc = None
        for g, n in zip(leaves, counts):
            term = g.float() * n
            acc = term if acc is None else acc.add_(term)
        out.append(acc.div_(total))
    return out


def global_norm_plain(leaves: Sequence[torch.Tensor]) -> torch.Tensor:
    """The leaves' global norm in fp32 (``train.optimizer.global_norm`` of
    a tree)."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves))


def grad_norm_plain(grads: Sequence[Sequence[torch.Tensor]],
                    counts: Sequence[float], clip: float) -> GradNorm:
    """The norm pass in plain PyTorch: the combined leaves, their global
    norm and the clip scale."""
    combined = combine_plain(grads, counts)
    norm = global_norm_plain(combined)
    scale = torch.clamp(clip / torch.clamp(norm, min=1e-9), max=1.0)
    return GradNorm(norm, scale, combined)


def adamw_step_plain(grads: Sequence[Sequence[torch.Tensor]],
                     counts: Sequence[float], gn: GradNorm,
                     m: Sequence[torch.Tensor], v: Sequence[torch.Tensor],
                     master: Sequence[torch.Tensor],
                     params: Sequence[torch.Tensor], hp: Hyper) -> None:
    """The update pass in plain PyTorch, the eager chain the port ran
    before the kernel, on ``gn``'s combined leaves (combined again from
    ``grads`` where ``gn`` holds none) and scale. Updates m, v, master and
    params in place."""
    combined = gn.combined if gn.combined is not None \
        else combine_plain(grads, counts)
    b1, b2 = hp.beta1, hp.beta2
    for g, m_, v_, w, p in zip(combined, m, v, master, params):
        g = g.float() * gn.scale
        m_.mul_(b1).add_(g * (1 - b1))
        v_.mul_(b2).add_(torch.square(g) * (1 - b2))
        update = (m_ / hp.bc1) / (torch.sqrt(v_ / hp.bc2) + hp.eps) \
            + hp.weight_decay * w
        w.sub_(hp.lr * update)
        p.copy_(w)


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------

def _local_numel(t: torch.Tensor) -> int:
    """Elements on this device: a DTensor's shard (the dry run's)."""
    return t.to_local().numel() if hasattr(t, "to_local") else t.numel()


def _charge(grads, k: int, update: bool) -> None:
    flops = cost.adamw_update_flops if update else cost.adamw_norm_flops
    nbytes = cost.adamw_update_bytes if update else cost.adamw_norm_bytes
    sizes = [(_local_numel(g[0]), g[0].dtype.itemsize) for g in grads]
    cost.charge("adamw_step", sum(flops(n, k) for n, _ in sizes),
                sum(nbytes(n, size, k) for n, size in sizes))


def _checked(t: torch.Tensor, name: str, dev: torch.device, dtype) \
        -> None:
    if t.device != dev:
        raise ValueError(f"{name} is on {t.device}, expected {dev}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs a contiguous, 16-byte "
                         f"aligned tensor")


def _table(grads, counts, dev: torch.device) -> torch.Tensor:
    """The norm pass's table on the card (``csrc/adamw_step.cu``): each
    leaf's first tile, size, dtype and chunks' addresses, and the counts.
    Each gradient is marked as used on the current stream, which reads it
    after the stream it was made on: its memory is not reused before the
    passes are done."""
    stream = torch.cuda.current_stream(dev)
    tiles, sizes, kinds, ptrs, t = [], [], [], [], 0
    for i, leaves in enumerate(grads):
        dtype, n = leaves[0].dtype, leaves[0].numel()
        if dtype not in DTYPES:
            raise TypeError(f"leaf {i}: the kernel takes {DTYPES}, got "
                            f"{dtype}")
        for c, g in enumerate(leaves):
            if g.numel() != n:
                raise ValueError(f"leaf {i}: chunk {c} has {g.numel()} "
                                 f"elements, chunk 0 {n}")
            _checked(g, f"leaf {i}, chunk {c}", dev, dtype)
            g.record_stream(stream)
            ptrs.append(g.data_ptr())
        tiles.append(t)
        sizes.append(n)
        kinds.append(int(dtype == torch.float32))
        t += -(-n // TILE)
    bits = torch.tensor(counts, dtype=torch.float64).view(torch.int64)
    host = torch.tensor(tiles + [t] + sizes + kinds + ptrs + bits.tolist(),
                        dtype=torch.int64).pin_memory()
    return host.to(dev, non_blocking=True)


def grad_norm(grads: Sequence[Sequence[torch.Tensor]],
              counts: Sequence[float], clip: float) -> GradNorm:
    """The norm pass: ``grads[i]`` holds leaf i's gradient from each
    chunk, ``counts`` each chunk's example count; the combined gradient's
    global norm and ``min(clip / max(norm, 1e-9), 1)``."""
    if not grads or not counts or any(len(g) != len(counts) for g in grads):
        raise ValueError(f"expected every leaf's gradient from each of "
                         f"{len(counts)} chunks")
    dev = grads[0][0].device
    if dev.type == "meta" and cost.evaluating():
        _charge(grads, len(counts), update=False)
    if dev.type in ("cpu", "meta"):
        return grad_norm_plain(grads, counts, clip)
    if dev.type != "cuda":
        raise ValueError(f"grad_norm runs on CUDA or the CPU, not {dev}")
    grads = [g for g in grads if g[0].numel()]
    table = _table(grads, counts, dev)
    n_tiles = sum(-(-g[0].numel() // TILE) for g in grads)
    grid = min(_grid("norm", dev), max(n_tiles, 1))
    partial = torch.empty(grid, dtype=torch.float64, device=dev)
    out = torch.empty(2, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev)
    rc = _lib().repro_adamw_norm(
        table.data_ptr(), len(grads), len(counts),
        _f32_reciprocal(sum(counts)), grid, partial.data_ptr(), clip,
        out.data_ptr(), dev.index or 0, stream.cuda_stream)
    if rc:
        raise RuntimeError(f"adamw_step norm launch failed: CUDA error {rc}")
    for _ in range(2):
        launch_count.launched("adamw_step", stream)
    return GradNorm(out[0], out[1], table=table)


def adamw_step(grads: Sequence[Sequence[torch.Tensor]],
               counts: Sequence[float], gn: GradNorm,
               m: Sequence[torch.Tensor], v: Sequence[torch.Tensor],
               master: Sequence[torch.Tensor],
               params: Sequence[torch.Tensor], hp: Hyper) -> None:
    """The update pass, after ``grad_norm`` of the same ``grads`` and
    ``counts``: m, v and master (fp32) and params, leaf by leaf as
    ``grads``, updated in place."""
    if not (len(grads) == len(m) == len(v) == len(master) == len(params)):
        raise ValueError("grads, m, v, master and params differ in leaves")
    dev = params[0].device if params else grads[0][0].device
    if dev.type == "meta" and cost.evaluating():
        _charge(grads, len(counts), update=True)
    if dev.type in ("cpu", "meta"):
        return adamw_step_plain(grads, counts, gn, m, v, master, params, hp)
    if dev.type != "cuda":
        raise ValueError(f"adamw_step runs on CUDA or the CPU, not {dev}")
    if gn.table is None:
        raise ValueError("adamw_step on the card takes grad_norm's result "
                         "for the same gradients")
    ptrs: List[List[int]] = [[], [], [], []]
    for i, leaves in enumerate(grads):
        if not leaves[0].numel():
            continue
        for j, (name, t, dtype) in enumerate((
                ("m", m[i], torch.float32), ("v", v[i], torch.float32),
                ("master", master[i], torch.float32),
                ("param", params[i], leaves[0].dtype))):
            if t.numel() != leaves[0].numel():
                raise ValueError(f"leaf {i}: {name} has {t.numel()} "
                                 f"elements, its gradient "
                                 f"{leaves[0].numel()}")
            _checked(t, f"leaf {i} {name}", dev, dtype)
            ptrs[j].append(t.data_ptr())
    state = torch.tensor(sum(ptrs, []), dtype=torch.int64) \
        .pin_memory().to(dev, non_blocking=True)
    n_leaves = len(ptrs[0])
    n_tiles = sum(-(-g[0].numel() // TILE) for g in grads)
    stream = torch.cuda.current_stream(dev)
    rc = _lib().repro_adamw_update(
        gn.table.data_ptr(), state.data_ptr(), n_leaves, len(counts),
        _f32_reciprocal(sum(counts)), gn.scale.data_ptr(), hp.lr, hp.beta1,
        1 - hp.beta1, hp.beta2, 1 - hp.beta2, _f32_reciprocal(hp.bc1),
        _f32_reciprocal(hp.bc2), hp.eps, hp.weight_decay,
        min(_grid("update", dev), max(n_tiles, 1)), dev.index or 0,
        stream.cuda_stream)
    if rc:
        raise RuntimeError(f"adamw_step update launch failed: CUDA error "
                           f"{rc}")
    launch_count.launched("adamw_step", stream)
