"""Production mesh construction, and the card's constants (torch
counterpart of ``repro.launch.mesh``).

Meshes are ``DeviceMesh``es over the default process group, built by
FUNCTIONS (never module constants), so importing this module touches no
process group. The dry run builds them over a fake group of 256 or 512
ranks (``launch.dryrun``); ``make_group_meshes`` splits a real group into
disjoint submeshes, one per device group.

The constants are the roofline denominators of one NVIDIA H100 80GB HBM3
(SXM) at its 700.00 W power limit, as ``nvidia-smi --query-gpu=name,
power.limit --format=csv,noheader`` prints it on the card; ``chip_smoke.py``
and the dry run read them from here.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

# NVIDIA H100 80GB HBM3 (SXM) constants (per card) -- roofline denominators.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, dense bf16 tensor-core peak
HBM_BW = 3.35e12                # B/s, NVIDIA's data sheet
NVLINK_BW = 450e9               # B/s a direction: 18 NVLink 4 links x 25 GB/s
CHIP_ACTIVE_W = 700.0           # W, the card's power limit (nvidia-smi)
# W, idle draw: the median of 10 nvidia-smi power.draw samples over 2 s with
# nothing running (chip_smoke.py phase 16a, which prints it every run)
CHIP_IDLE_W = 127.7


def _dist():
    import torch.distributed as dist
    if not dist.is_initialized():
        raise RuntimeError("no default process group: initialise one "
                           "(the dry run's fake group, or a real one) first")
    return dist


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cpu"):
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod",
    "data", "model"), over the default process group."""
    from torch.distributed.device_mesh import init_device_mesh
    _dist()
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_mesh_from(ranks: Sequence[int], shape: Tuple[int, ...],
                   axes: Tuple[str, ...], device_type: str = "cpu"):
    """Mesh over an explicit subset of the default group's ranks
    (heterogeneous device groups)."""
    from torch.distributed.device_mesh import DeviceMesh
    _dist()
    grid = torch.tensor(list(ranks), dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, grid, mesh_dim_names=axes)


def make_group_meshes(group_sizes: Sequence[int], model_axis: int = 1,
                      device_type: str = "cpu") -> List:
    """Split the default group's ranks into disjoint submeshes, the
    big.LITTLE analogue: group ``i`` is a (data, model) mesh over the next
    ``group_sizes[i]`` ranks."""
    world = _dist().get_world_size()
    if sum(group_sizes) > world:
        raise ValueError(f"groups {list(group_sizes)} need more than the "
                         f"{world} ranks of the default group")
    meshes, off = [], 0
    for n in group_sizes:
        data = n // model_axis
        meshes.append(make_mesh_from(range(off, off + n), (data, model_axis),
                                     ("data", "model"), device_type))
        off += n
    return meshes
