"""The port's sharding rules, placements and ``lshard`` against the JAX
package's.

* ``ShardingRules.spec`` equals the reference's ``PartitionSpec`` entry by
  entry on every leaf of the parameter, optimizer-state, input and cache
  axes trees of every dry-run cell, on the 16 x 16 and 2 x 16 x 16 meshes,
  with the long-context overrides and with uneven heads; the reference's
  five rules cases (``tests/test_infra.py``) run again on the port.
* Under a fake process group of 256 / 512 ranks, rank 0's local shape of
  every leaf (placed by DTensor itself) is ceil(dim / the product of the
  spec's mesh sizes); a multi-name entry out of the mesh's order raises.
* ``lshard`` is the identity without a mesh, places a DTensor under one,
  and refuses a plain tensor; a drift guard holds the axis tuples the
  model modules pass to it equal to the reference's.
* One uneven cell (phi3-medium-14b train_4k, 40 heads over 16) traced.

No test leaves a process group behind for the next file on its worker.
"""
import ast
import math
from collections import Counter
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.sharding.rules import ShardingRules as JaxRules
from repro_torch.configs.registry import dryrun_cells, get_config
from repro_torch.launch import dryrun
from repro_torch.models import model as M
from repro_torch.sharding import (DEFAULT_RULES, LONG_CONTEXT_OVERRIDES,
                                  ShardingRules, active_mesh, active_rules,
                                  lshard, use_mesh_rules)
from repro_torch.sharding.rules import local_shape
from repro_torch.train.optimizer import abstract_opt_state, opt_state_axes

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}
UNEVEN = ("heads", "kv_heads", "act_heads", "act_kv_heads")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)
    assert not dist.is_initialized()


class FakeMesh:
    """The reference's duck-typed mesh (tests/test_infra.py)."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = np.zeros(shape)


class PortMesh:
    """The port's: ``mesh_dim_names`` and ``shape``, as a DeviceMesh."""

    def __init__(self, shape, names):
        self.mesh_dim_names = names
        self.shape = shape


def _leaves(values, axes, prefix=()):
    if isinstance(values, dict):
        for k, v in values.items():
            yield from _leaves(v, axes[k], prefix + (k,))
    else:
        yield prefix, tuple(values.shape), axes


def _cell_trees(cfg, shape):
    """(name, meta tree, axes tree) of a cell's arguments."""
    p = M.abstract_params(cfg)
    out = [("params", p, M.param_axes(cfg))]
    if shape.kind == "train":
        out.append(("opt", abstract_opt_state(p),
                    opt_state_axes(M.param_axes(cfg))))
    out.append(("inputs", M.input_specs(cfg, shape),
                M.input_axes(cfg, shape)))
    return out


def _variants(kind):
    base = ShardingRules().for_shape_kind(kind)
    ref = JaxRules().for_shape_kind(kind)
    return [("default", base, ref),
            ("uneven", base.with_uneven(*UNEVEN), ref.with_uneven(*UNEVEN))]


CELLS = [(c.arch_id, s.name) for c, s, _, _ in dryrun_cells()]


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
@pytest.mark.parametrize("arch,shape", CELLS)
def test_spec_equals_the_reference_on_every_leaf(arch, shape, mesh_kind):
    cfg = get_config(arch)
    cell = next(s for c, s, _, _ in dryrun_cells()
                if c.arch_id == arch and s.name == shape)
    dims, names = MESHES[mesh_kind]
    ref_mesh, mesh = FakeMesh(dims, names), PortMesh(dims, names)
    n = 0
    for variant, rules, ref in _variants(cell.kind):
        for tree, values, axes in _cell_trees(cfg, cell):
            for path, shp, ax in _leaves(values, axes):
                want = tuple(ref.spec(ref_mesh, ax, shp))
                got = rules.spec(mesh, ax, shp)
                assert got == want, (variant, tree, path, shp, ax, got, want)
                n += 1
    assert n > 20


# the reference's rules cases (tests/test_infra.py), on the port
@pytest.mark.parametrize("mesh,rules,axes,shape,want", [
    (((16, 16), ("data", "model")), ShardingRules(), ("vocab", "embed"),
     (64000, 4096), ("model", "data")),
    # 40 heads % 16 != 0 -> head axis replicated
    (((16, 16), ("data", "model")), ShardingRules(),
     ("embed", "heads", "head_dim"), (5120, 40, 128), ("data",)),
    # batch 32 divisible by pod·data=32 -> both axes used; 2 -> prefix; 1
    (((2, 16, 16), ("pod", "data", "model")), ShardingRules(),
     ("act_batch", None), (32, 7), (("pod", "data"),)),
    (((2, 16, 16), ("pod", "data", "model")), ShardingRules(),
     ("act_batch", None), (2, 7), ("pod",)),
    (((2, 16, 16), ("pod", "data", "model")), ShardingRules(),
     ("act_batch", None), (1, 7), ()),
    # both dims map to model -> second falls back (no double use)
    (((16, 16), ("data", "model")), ShardingRules(), ("vocab", "mlp"),
     (1600, 1600), ("model",)),
    (((2, 16, 16), ("pod", "data", "model")),
     ShardingRules().for_shape_kind("long_decode"),
     ("cache_batch", "cache_seq", "cache_kv_heads", None),
     (1, 524288, 32, 64), (None, ("pod", "data"), "model")),
], ids=["basic", "divisibility", "multi_axis", "prefix", "replicated",
        "no_reuse", "long_context"])
def test_reference_rules_cases(mesh, rules, axes, shape, want):
    assert rules.spec(PortMesh(*mesh), axes, shape) == want


def test_tables_are_the_references():
    from repro.sharding.rules import DEFAULT_RULES as JD
    from repro.sharding.rules import LONG_CONTEXT_OVERRIDES as JL
    assert DEFAULT_RULES == JD and LONG_CONTEXT_OVERRIDES == JL


def test_spec_rejects_mismatched_axes():
    with pytest.raises(ValueError, match="do not match"):
        ShardingRules().spec(PortMesh((16, 16), ("data", "model")),
                             ("embed",), (4, 4))


# ---------------------------------------------------------------------------
# placements under a fake process group
# ---------------------------------------------------------------------------

def _want_local(spec, shape, sizes):
    out = []
    for i, n in enumerate(shape):
        entry = spec[i] if i < len(spec) else None
        entry = (entry,) if isinstance(entry, str) else tuple(entry or ())
        out.append(-(-n // math.prod(sizes[a] for a in entry)))
    return tuple(out)


@pytest.mark.parametrize("mesh_kind", sorted(MESHES))
def test_rank0_local_shapes(mesh_kind):
    """Every leaf of one cell per family, placed by DTensor itself
    (``distribute_tensor`` of a meta tensor): rank 0 holds ceil(dim / the
    product of the spec's mesh sizes), as ``rules.local_shape`` says."""
    from torch.distributed.tensor import distribute_tensor
    dims, names = MESHES[mesh_kind]
    sizes = dict(zip(names, dims))
    cells = {}
    for c, s, _, _ in dryrun_cells():
        cells.setdefault(c.family, (c, s))
    with dryrun.fake_group(math.prod(dims)):
        mesh = dryrun._mesh(mesh_kind)
        n = 0
        for cfg, shape in cells.values():
            for rules in (ShardingRules().for_shape_kind(shape.kind),
                          ShardingRules().with_uneven(*UNEVEN)):
                for _, values, axes in _cell_trees(cfg, shape):
                    for path, shp, ax in _leaves(values, axes):
                        pl = rules.placements(mesh, ax, shp)
                        got = distribute_tensor(
                            torch.empty(shp, device="meta"), mesh,
                            pl).to_local().shape
                        want = _want_local(rules.spec(mesh, ax, shp), shp,
                                           sizes)
                        assert tuple(got) == want, (cfg.arch_id, path)
                        assert local_shape(shp, mesh, pl) == want
                        n += 1
        assert n > 100
    assert not dist.is_initialized()


def test_entry_out_of_mesh_order_raises():
    rules = ShardingRules().with_overrides(act_batch=("data", "pod"))
    mesh = PortMesh((2, 16, 16), ("pod", "data", "model"))
    assert rules.spec(mesh, ("act_batch",), (64,)) == (("data", "pod"),)
    with pytest.raises(ValueError, match="does not follow the mesh's order"):
        rules.placements(mesh, ("act_batch",), (64,))
    from torch.distributed.tensor import Replicate, Shard
    assert ShardingRules().placements(mesh, ("act_batch",), (64,)) \
        == (Shard(0), Shard(0), Replicate())


def test_tree_shardings():
    from repro_torch.sharding import tree_shardings
    from torch.distributed.tensor import Replicate, Shard
    mesh = PortMesh((16, 16), ("data", "model"))
    tree = {"a": torch.empty(64, 32, device="meta"),
            "b": {"c": torch.empty(3, device="meta")}}
    axes = {"a": ("embed", "mlp"), "b": {"c": ("embed",)}}
    got = tree_shardings(mesh, tree, axes)
    assert got["a"] == (mesh, (Shard(0), Shard(1)))
    assert got["b"]["c"] == (mesh, (Replicate(), Replicate()))


# ---------------------------------------------------------------------------
# lshard
# ---------------------------------------------------------------------------

def test_lshard_without_a_mesh_is_the_identity():
    x = torch.randn(4, 8, 16)
    assert active_mesh() is None and active_rules() is None
    assert lshard(x, "act_batch", "act_seq", "act_embed") is x


def test_lshard_places_a_dtensor_under_a_mesh():
    from torch.distributed.tensor import Replicate, Shard
    with dryrun.fake_group(256):
        mesh = dryrun._mesh("single")
        rules = ShardingRules()
        x = dryrun.abstract_dtensor(torch.empty(32, 4096, 2048,
                                                dtype=torch.bfloat16,
                                                device="meta"),
                                    mesh, (Shard(0), Replicate()))
        with use_mesh_rules(mesh, rules):
            assert active_mesh() is mesh and active_rules() is rules
            y = lshard(x, "act_batch", "act_res_seq", "act_embed")
            assert y.placements == rules.placements(
                mesh, ("act_batch", "act_res_seq", "act_embed"), x.shape)
            assert y.placements == (Shard(0), Shard(1))
            assert tuple(y.to_local().shape) == (2, 256, 2048)
            with pytest.raises(TypeError, match="plain Tensor"):
                lshard(torch.empty(4, 4, device="meta"), "act_batch", None)
        assert active_mesh() is None
    assert not dist.is_initialized()


MODEL_MODULES = ("transformer", "moe", "ssm", "hybrid", "layers")


def _lshard_axes(path: Path) -> Counter:
    """The multiset of axis tuples passed to ``lshard`` in a source file."""
    found = Counter()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) == "lshard":
            found[tuple(a.value for a in node.args[1:])] += 1
    return found


@pytest.mark.parametrize("module", MODEL_MODULES)
def test_lshard_annotations_follow_the_reference(module):
    ref = _lshard_axes(ROOT / "src" / "repro" / "models" / f"{module}.py")
    port = _lshard_axes(ROOT / "src" / "repro_torch" / "models"
                        / f"{module}.py")
    assert ref, module
    assert port == ref


# ---------------------------------------------------------------------------
# one uneven cell
# ---------------------------------------------------------------------------

def test_uneven_heads_cell():
    """phi3-medium-14b train_4k with its 40 heads and 10 kv heads sharded
    unevenly over 16: the training step, backward included, traces
    (DTensor cannot view unevenly sharded heads; the regions give their
    outputs' global shapes)."""
    res = dryrun.run_cell("phi3-medium-14b", "train_4k", "single",
                          save_hlo=False, uneven_heads=True)
    assert res["status"] == "ok", res.get("traceback")
    assert res["flops_per_device"] > 0
    assert not dist.is_initialized()
