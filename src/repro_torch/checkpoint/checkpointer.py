"""Atomic checkpointing (the restart half of fault tolerance); the torch
counterpart of ``repro.checkpoint.checkpointer``, writing and reading the
same files.

Layout: <dir>/step_<n>/ {meta.json, arrays.npz}; writes go to a tmp dir that
is os.rename()'d into place (atomic on POSIX), so a crash mid-save never
corrupts the latest checkpoint. Optional async save on a background thread
(training continues while the previous step serializes). keep_n garbage
collection. Trees are flattened with '/'-joined key paths.

Leaves are torch tensors (or anything ``np.asarray`` takes). numpy has no
bfloat16 or float8, and ml_dtypes is not used: such a tensor is stored as
its bits in an unsigned integer array, with its dtype's name in
``meta.json``'s ``_dtypes`` sidecar, as the JAX package stores it, so a
checkpoint written by either package restores in the other. ``restore``
returns CPU tensors.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

# numpy cannot natively serialize these; store the bits + a dtype sidecar:
# name -> (torch dtype, numpy carrier, the same-width signed integer types
# of torch and numpy through which the bits pass)
_EXOTIC_DTYPES = {
    "bfloat16": (torch.bfloat16, np.uint16, torch.int16, np.int16),
    "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8, torch.int8, np.int8),
    "float8_e5m2": (torch.float8_e5m2, np.uint8, torch.int8, np.int8),
}


def _to_numpy(v) -> Tuple[np.ndarray, Optional[str]]:
    """A leaf as a numpy array, and its exotic dtype's name or None."""
    if not isinstance(v, torch.Tensor):
        return np.asarray(v), None
    t = v.detach().cpu()
    for name, (dt, carrier, t_int, _) in _EXOTIC_DTYPES.items():
        if t.dtype == dt:
            return t.view(t_int).numpy().view(carrier), name
    return t.numpy(), None


def _from_numpy(a: np.ndarray, name: Optional[str]) -> torch.Tensor:
    if name is None:
        return torch.from_numpy(np.array(a))
    dt, carrier, _, np_int = _EXOTIC_DTYPES[name]
    return torch.from_numpy(np.array(a, dtype=carrier).view(np_int)).view(dt)


def _flatten(tree, prefix="") -> Dict[str, Any]:
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _unflatten(flat: Dict[str, Any]):
    root: Dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v

    def fix(node):
        if isinstance(node, dict) and node and \
                all(k.isdigit() for k in node):
            return tuple(fix(node[str(i)]) for i in range(len(node)))
        if isinstance(node, dict):
            return {k: fix(v) for k, v in node.items()}
        return node

    return fix(root)


class Checkpointer:
    def __init__(self, directory: str, keep_n: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep_n = keep_n
        self._async_thread: Optional[threading.Thread] = None

    # ------------------------------------------------------------------
    def save(self, step: int, tree: Dict, meta: Optional[Dict] = None):
        flat = _flatten(tree)
        arrays = {}
        dtype_sidecar = {}
        for k, v in flat.items():
            a, name = _to_numpy(v)
            if name is not None:
                dtype_sidecar[k] = name
            arrays[k] = a
        tmp = self.dir / f".tmp_step_{step}_{os.getpid()}_{time.time_ns()}"
        tmp.mkdir(parents=True)
        try:
            np.savez(tmp / "arrays.npz", **arrays)
            (tmp / "meta.json").write_text(json.dumps(
                {"step": step, "time": time.time(),
                 "_dtypes": dtype_sidecar, **(meta or {})}))
            final = self.dir / f"step_{step}"
            if final.exists():
                shutil.rmtree(final)
            os.rename(tmp, final)
        finally:
            if tmp.exists():
                shutil.rmtree(tmp, ignore_errors=True)
        self._gc()
        return self.dir / f"step_{step}"

    def save_async(self, step: int, tree: Dict,
                   meta: Optional[Dict] = None) -> threading.Thread:
        self.wait()
        # copy to the host BEFORE backgrounding: the next step updates the
        # device tensors in place
        flat = {k: v.detach().cpu().clone() if isinstance(v, torch.Tensor)
                else np.asarray(v) for k, v in _flatten(tree).items()}
        th = threading.Thread(
            target=lambda: self.save(step, flat, meta), daemon=True)
        self._async_thread = th
        th.start()
        return th

    def wait(self):
        if self._async_thread is not None:
            self._async_thread.join()
            self._async_thread = None

    # ------------------------------------------------------------------
    def steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            try:
                out.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, step: Optional[int] = None) -> Tuple[Dict, Dict]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self.dir / f"step_{step}"
        meta = json.loads((d / "meta.json").read_text())
        sidecar = meta.get("_dtypes", {})
        with np.load(d / "arrays.npz") as z:
            flat = {k: _from_numpy(z[k], sidecar.get(k)) for k in z.files}
        return _unflatten(flat), meta

    def _gc(self):
        steps = self.steps()
        for s in steps[:-self.keep_n]:
            shutil.rmtree(self.dir / f"step_{s}", ignore_errors=True)
