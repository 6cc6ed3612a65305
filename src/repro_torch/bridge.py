"""Bring the JAX package's parameters over to the port.

``params_from_jax(cfg, tree, device)`` takes the JAX parameter pytree as
numpy arrays (``jax.tree.map(np.asarray, params)``) and returns the port's
parameter dict: the same nesting and keys, each leaf a tensor on
``device``. bfloat16 leaves arrive as numpy arrays of the ml_dtypes
``bfloat16`` type; their bits are reinterpreted through ``uint16`` (as the
JAX package's checkpointer stores them), so ml_dtypes is never imported.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.configs.base import LMConfig
from repro_torch.models.model import param_defs


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, copy=True, order="C")    # writable, owned
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def params_from_jax(cfg: LMConfig, tree: Dict[str, Any], device) -> Dict:
    """JAX parameter tree (numpy leaves) -> port parameters on ``device``.
    Raises if the tree's keys or shapes differ from ``param_defs(cfg)``."""
    def walk(defs, node, path):
        if isinstance(defs, dict):
            if not isinstance(node, dict) or set(node) != set(defs):
                raise ValueError(f"{path or 'params'}: keys "
                                 f"{sorted(node) if isinstance(node, dict) else type(node)}"
                                 f" != {sorted(defs)}")
            return {k: walk(defs[k], node[k], f"{path}/{k}") for k in defs}
        a = np.asarray(node)
        if tuple(a.shape) != tuple(defs.shape):
            raise ValueError(f"{path}: shape {a.shape} != {defs.shape}")
        return tensor_from_numpy(a, device)

    return walk(param_defs(cfg), tree, "")
