"""Multi-pod dry run: trace every (architecture x input shape x mesh) cell
on the production mesh with nothing allocated, and record per-device
memory, FLOPs and collectives (torch counterpart of
``repro.launch.dryrun``).

The reference fakes 512 host devices and lowers and compiles each cell
with XLA. Here a ``fake`` process group of 256 or 512 ranks stands in for
the devices, this process plays rank 0, and the step runs once, eagerly,
on DTensors whose local tensors lie on the meta device: every argument
is A12a's meta tree (``models.model.abstract_params``, ``input_specs``)
placed by the sharding rules, every activation is placed by the model's
``lshard`` annotations, and the kernels' meta branches return their
outputs' shapes and charge their work (``kernels.cost``). What a cell
records, under the reference's keys where they have a counterpart:

* ``memory.argument_bytes``: rank 0's local argument bytes; ``output_bytes``
  its local output bytes, less the arguments the step updates in place
  (``alias_bytes``: decode's cache, training's parameters and optimizer
  state); ``temp_bytes``: the peak of live local bytes during the step
  less the arguments, as seen between operations (a buffer that lives
  only inside one DTensor operation, such as an all-gathered weight, is
  not seen);
* ``collective_op_counts``: ``CommDebugMode``'s counts under the
  reference's five names;
* ``flops_per_device``: the FLOPs of rank 0's local products (those
  ``torch.utils.flop_counter`` counts) and of the kernels' meta branches.
  Every step of a scan counts; the reference's ``flops_per_device_loopbody``
  counts each ``lax.scan`` body once, so the two are not comparable;
* ``trace_s``, the seconds of the traced step, replaces ``lower_s`` and
  ``compile_s``, which have no counterpart; ``total_s`` includes building
  the cell;
* beside the JSON, unless ``--no-hlo``, the counterpart of the
  reference's ``.hlo.gz``: ``CommDebugMode``'s JSON dump of the step,
  gzipped (``.comms.json.gz``).

Constants made inside the step (positions, masks) are replicated, as
GSPMD replicates them.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b --shape train_4k --mesh single
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both --skip-existing
"""
from __future__ import annotations

import argparse
import gzip
import json
import math
import time
import traceback
import weakref
from collections import Counter
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Optional

import torch

from repro_torch.configs.base import SHAPES_BY_NAME, ShapeSuite, \
    shape_applicable
from repro_torch.configs.registry import dryrun_cells, get_config
from repro_torch.kernels import cost
from repro_torch.models import model as M
from repro_torch.sharding.partition import abstract_dtensor, use_mesh_rules
from repro_torch.sharding.rules import ShardingRules, tree_map_axes
from repro_torch.train.optimizer import OptConfig, abstract_opt_state, \
    opt_state_axes
from repro_torch.train.train_step import train_step

RESULTS_DIR = Path(__file__).resolve().parents[3] / "results" / "dryrun_torch"

#: mesh kind -> (shape, dim names); "unit" is one device, for checking the
#: dry run against a trainer on one card
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model")),
          "unit": ((1, 1), ("data", "model"))}

#: functional collectives (what DTensor issues) -> the reference's HLO names
COLLECTIVES = {"all_gather_into_tensor": "all-gather",
               "all_reduce": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_to_all_single": "all-to-all"}


@contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0:
    collectives do nothing and return their outputs' shapes."""
    import torch.distributed as dist
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:
        raise RuntimeError("the dry run needs torch's fake process group "
                           "(torch.testing._internal.distributed.fake_pg)") \
            from e
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialised")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def build_cell(cfg, shape, oc: OptConfig):
    """Returns (step_fn, abstract_args, logical_axes_trees)."""
    specs = M.input_specs(cfg, shape)
    in_axes = M.input_axes(cfg, shape)
    p_abs = M.abstract_params(cfg)
    if shape.kind == "train":
        o_abs = abstract_opt_state(p_abs)

        def step(params, opt, batch):
            return train_step(cfg, oc, params, opt, batch)

        return step, (p_abs, o_abs, specs), \
            (M.param_axes(cfg), opt_state_axes(M.param_axes(cfg)), in_axes)
    if shape.kind == "prefill":
        def step(params, batch):
            return M.prefill(cfg, params, batch["tokens"],
                             batch.get("prefix_emb"))

        return step, (p_abs, specs), (M.param_axes(cfg), in_axes)

    # decode / long_decode: the cache is updated in place
    def step(params, batch):
        return M.decode_step(cfg, params, batch["cache"], batch["tokens"])

    return step, (p_abs, specs), (M.param_axes(cfg), in_axes)


def shardings_for(mesh, rules, abstract_args, axes_trees):
    """Each argument tree's (mesh, placements) tree."""
    return tuple(tree_map_axes(
        lambda t, ax: rules.sharding(mesh, ax, t.shape), args, axes)
        for args, axes in zip(abstract_args, axes_trees))


def summarize_collectives(comm_counts) -> Dict[str, int]:
    """``CommDebugMode.get_comm_counts()`` under the reference's names."""
    ops: Counter = Counter()
    for op, n in comm_counts.items():
        name = str(getattr(op, "__name__", op)).split(".")[-1]
        ops[COLLECTIVES.get(name, name)] += n
    return dict(ops)


def _local(t):
    return getattr(t, "_local_tensor", t)


def _nbytes(tree) -> int:
    seen, total = set(), 0
    for t in _tensors(tree):
        st = _local(t).untyped_storage()
        if id(st) not in seen:
            seen.add(id(st))
            total += st.nbytes()
    return total


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


class DeviceCost:
    """A dispatch mode counting rank 0's local FLOPs and live local bytes.

    An operation on DTensors is seen with its global shapes: its FLOPs
    (``torch.utils.flop_counter``'s formulas) are scaled by the share of
    the output rank 0 holds, and divided by the size of each mesh dim over
    which the output is a partial sum (the contraction is split there).
    Inside a ``local_map`` region the operations are on local tensors and
    count as they are. Live bytes: every storage an operation returns,
    until it is freed."""

    def __init__(self):
        from torch.utils._python_dispatch import TorchDispatchMode
        from torch.utils.flop_counter import flop_registry
        registry, owner = flop_registry, self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                out = func(*args, **kwargs)
                fn = registry.get(func._overloadpacket)
                if fn is not None:
                    owner.flops += fn(*args, **kwargs, out_val=out) \
                        * owner._local_share(out)
                for t in _tensors(out):
                    owner._track(t)
                return out

        self.mode = _Mode()
        self.flops = 0.0
        self.live = self.peak = 0
        self._storages: Dict[int, list] = {}

    @staticmethod
    def _local_share(out) -> float:
        from torch.distributed.tensor import DTensor, Partial
        t = next(iter(_tensors(out)), None)
        if not isinstance(t, DTensor) or t.numel() == 0:
            return 1.0
        share = t._local_tensor.numel() / t.numel()
        for i, p in enumerate(t.placements):
            if isinstance(p, Partial):
                share /= t.device_mesh.size(i)
        return share

    def _track(self, t: torch.Tensor) -> None:
        # a storage is live while any tensor returned on it is: keyed by
        # the storage itself, not its Python object, which torch need not
        # keep (views share the storage)
        local = _local(t)
        st = local.untyped_storage()
        key = st._cdata
        if key not in self._storages:
            self._storages[key] = [0, st.nbytes()]
            self.live += st.nbytes()
            self.peak = max(self.peak, self.live)
        self._storages[key][0] += 1
        weakref.finalize(local, self._drop, key)

    def _drop(self, key) -> None:
        entry = self._storages[key]
        entry[0] -= 1
        if entry[0] == 0:
            del self._storages[key]
            self.live -= entry[1]

    def __enter__(self):
        self.mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self.mode.__exit__(*exc)


def _mesh(mesh_kind: str):
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.launch.mesh import make_production_mesh
    if mesh_kind == "unit":
        return init_device_mesh("cpu", MESHES["unit"][0],
                                mesh_dim_names=MESHES["unit"][1])
    return make_production_mesh(multi_pod=mesh_kind == "multi")


def run_cell(arch_id: str, shape_name: str, mesh_kind: str,
             block_skip: bool = False, save_hlo: bool = True,
             overrides=None, uneven_heads: bool = False,
             shape: Optional[ShapeSuite] = None) -> dict:
    """One cell. ``shape`` replaces the named input shape (a cell of the
    caller's own, such as one chunk of a trainer's batch)."""
    cfg = get_config(arch_id)
    if block_skip:
        cfg = cfg.replace(causal_block_skip=True)
    if overrides:
        cfg = cfg.replace(**overrides)
    shape = shape or SHAPES_BY_NAME[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
                "status": "skipped", "reason": reason}
    mesh_shape, _ = MESHES[mesh_kind]
    rules = ShardingRules().for_shape_kind(shape.kind)
    if uneven_heads:
        rules = rules.with_uneven("heads", "kv_heads", "act_heads",
                                  "act_kv_heads")
    oc = OptConfig()
    res = {"arch": arch_id, "shape": shape_name, "mesh": mesh_kind,
           "mesh_shape": list(mesh_shape), "block_skip": block_skip,
           "uneven_heads": uneven_heads, "status": "error"}
    t0 = time.time()
    try:
        with fake_group(math.prod(mesh_shape)):
            res.update(_trace(cfg, shape, mesh_kind, rules, oc, save_hlo,
                              cell_path(arch_id, shape_name, mesh_kind,
                                        block_skip, overrides)))
    except Exception as e:  # noqa: BLE001 -- record the failure, keep the matrix running
        res["error"] = f"{type(e).__name__}: {e}"
        res["traceback"] = traceback.format_exc(limit=10)
    res["total_s"] = round(time.time() - t0, 2)
    return res


def _trace(cfg, shape, mesh_kind, rules, oc, save_hlo, path) -> dict:
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    mesh = _mesh(mesh_kind)
    step, abstract_args, axes_trees = build_cell(cfg, shape, oc)
    placed = tuple(tree_map_axes(
        lambda t, ax: abstract_dtensor(t, mesh, rules.placements(
            mesh, ax, t.shape)), args, axes)
        for args, axes in zip(abstract_args, axes_trees))
    arg_bytes = _nbytes(placed)
    alias = _nbytes(placed[-1]["cache"]) if shape.is_decode else 0
    counter = DeviceCost()
    for t in _tensors(placed):
        counter._track(t)
    comm = CommDebugMode()
    t0 = time.time()
    # constants made inside the step (positions, masks, zeros) are
    # replicated on every device, as GSPMD replicates them
    with use_mesh_rules(mesh, rules), implicit_replication(), \
            cost.recording() as kernels, comm, counter:
        out = step(*placed)
    trace_s = time.time() - t0
    out_bytes = _nbytes(out) - (alias if shape.is_decode else 0)
    if shape.kind == "train":
        # the step updates the parameters and the optimizer state in place
        out_bytes = _nbytes(out[2])
        alias = _nbytes(out[:2])
    res = {
        "status": "ok",
        "trace_s": round(trace_s, 2),
        "memory": {"argument_bytes": arg_bytes,
                   "output_bytes": out_bytes,
                   "temp_bytes": counter.peak - arg_bytes,
                   "alias_bytes": alias},
        "flops_per_device": counter.flops + cost.total_flops(kernels),
        "kernel_cost": {k: dict(v) for k, v in kernels.items()},
        "collective_op_counts": summarize_collectives(
            comm.get_comm_counts()),
        "n_devices": mesh.size(),
    }
    if save_hlo:
        path.parent.mkdir(parents=True, exist_ok=True)
        dump = Path(str(path) + ".comms.json")
        comm.generate_json_dump(str(dump), noise_level=1)
        with open(dump, "rb") as f, gzip.open(str(path) + ".comms.json.gz",
                                              "wb") as g:
            g.write(f.read())
        dump.unlink()
    return res


def cell_path(arch, shape, mesh_kind, block_skip=False, overrides=None) -> Path:
    sfx = "__bs" if block_skip else ""
    if overrides:
        sfx += "__" + "_".join(f"{k}-{v}" for k, v in sorted(overrides.items()))
    return RESULTS_DIR / mesh_kind / f"{arch}__{shape}{sfx}.json"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--block-skip", action="store_true",
                    help="triangular causal schedule (perf variant)")
    ap.add_argument("--no-hlo", action="store_true",
                    help="write no communication dump beside the JSON")
    args = ap.parse_args(argv)

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        cells = [(c.arch_id, s.name) for c, s, ok, _ in dryrun_cells()
                 if ok]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]

    n_ok = n_fail = 0
    t0 = time.time()
    for mesh_kind in meshes:
        for arch, shape in cells:
            path = cell_path(arch, shape, mesh_kind, args.block_skip)
            if args.skip_existing and path.exists():
                print(f"[skip] {mesh_kind} {arch} {shape}")
                continue
            res = run_cell(arch, shape, mesh_kind, args.block_skip,
                           save_hlo=not args.no_hlo)
            path.parent.mkdir(parents=True, exist_ok=True)
            path.write_text(json.dumps(res, indent=2))
            tag = res["status"].upper()
            n_ok += res["status"] == "ok"
            n_fail += res["status"] == "error"
            print(f"[{tag}] {mesh_kind} {arch} {shape} "
                  f"({res.get('total_s')}s) "
                  f"{res.get('error', '')}", flush=True)
    print(f"done: {n_ok} ok, {n_fail} failed ({time.time() - t0:.1f} s)")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
