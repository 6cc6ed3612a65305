"""Logical-axis sharding rules (divisibility-aware), on DTensor.

Torch counterpart of ``repro.sharding.rules``. Parameters and activations
are annotated with *logical* axis names; a :class:`ShardingRules` table
maps those to the names of a ``DeviceMesh``'s dims. A mapping is applied
to a tensor dim only when the dim's size is divisible by the product of
the mapped mesh-dim sizes, otherwise the rule falls back to a prefix of
the mapped names, and finally to replication (this is what lets
phi3-medium's 40 heads coexist with TP=16).

``spec`` is the twin of the reference's ``PartitionSpec``: a tuple with
one entry per tensor dim (``None``, a mesh-dim name or a tuple of names),
trailing ``None``s dropped. ``placements`` turns it into DTensor
placements, one per mesh dim: ``Shard(d)`` where the mesh dim's name
stands at tensor dim ``d``, else ``Replicate()``.

Two differences from GSPMD, both kept visible:

* a multi-name entry such as ``("pod", "data")`` on one tensor dim is two
  ``Shard(d)`` placements, which DTensor nests in mesh-dim order; the
  ``PartitionSpec`` nests them in the tuple's order. The two agree when
  the tuple follows the mesh's order, as every entry of ``DEFAULT_RULES``
  does; ``placements`` raises on one that does not.
* under ``allow_uneven`` GSPMD pads the last shard; DTensor splits as
  ``torch.chunk`` does, the first ranks holding ceil(dim / n). Rank 0 thus
  holds the per-device size that the reference's memory analysis counts.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union


AxisMap = Union[None, str, Tuple[str, ...]]
Spec = Tuple[AxisMap, ...]


def _as_tuple(v: AxisMap) -> Tuple[str, ...]:
    if v is None:
        return ()
    if isinstance(v, str):
        return (v,)
    return tuple(v)


def mesh_sizes(mesh) -> Dict[str, int]:
    """{mesh-dim name: size} of a ``DeviceMesh`` (or anything with
    ``mesh_dim_names`` and ``shape``)."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


# Default production rules: FSDP over `data`, TP/EP over `model`, DP over `pod`.
DEFAULT_RULES: Dict[str, AxisMap] = {
    # ---- parameters -------------------------------------------------
    "vocab": "model",
    "embed": "data",            # FSDP axis (weights gathered per layer)
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",
    "layers": None,             # scan axis
    "ssm_inner": "model",
    "ssm_state": None,
    "ssm_heads": "model",
    "conv_dim": "model",
    "norm": None,
    "pos": None,
    # ---- activations ------------------------------------------------
    "act_batch": ("pod", "data"),
    "act_seq": None,
    # residual stream between blocks: sequence-parallel over `model`
    # (Megatron-SP)
    "act_res_seq": "model",
    "act_embed": None,
    "act_heads": "model",
    "act_kv_heads": "model",
    "act_mlp": "model",
    "act_vocab": "model",
    "act_experts": "model",
    "act_expert_cap": "data",
    "act_expert_group": ("pod", "data"),
    "act_ssm_inner": "model",
    # ---- decode caches ----------------------------------------------
    "cache_batch": ("pod", "data"),
    "cache_seq": None,
    "cache_kv_heads": "model",
}

# long_500k (global_batch=1): the batch axis cannot be sharded; shard the KV
# cache (and decode activations) along the sequence instead.
LONG_CONTEXT_OVERRIDES: Dict[str, AxisMap] = {
    "act_batch": None,
    "cache_batch": None,
    "cache_seq": ("pod", "data"),
}


@dataclass(frozen=True)
class ShardingRules:
    table: Dict[str, AxisMap] = field(default_factory=lambda: dict(DEFAULT_RULES))
    # logical axes that may shard UNEVENLY (phi3-medium: 40 heads over
    # TP=16 -> 3 a device instead of 40 replicated)
    allow_uneven: Tuple[str, ...] = ()

    def with_overrides(self, **overrides: AxisMap) -> "ShardingRules":
        t = dict(self.table)
        t.update(overrides)
        return ShardingRules(t, self.allow_uneven)

    def with_uneven(self, *axes: str) -> "ShardingRules":
        return ShardingRules(dict(self.table), tuple(axes))

    def for_shape_kind(self, kind: str) -> "ShardingRules":
        if kind == "long_decode":
            return self.with_overrides(**LONG_CONTEXT_OVERRIDES)
        return self

    # ------------------------------------------------------------------
    def spec(self, mesh, axes: Sequence[Optional[str]],
             shape: Sequence[int]) -> Spec:
        """The PartitionSpec twin for a tensor with the given logical axes
        and shape."""
        if len(axes) != len(shape):
            raise ValueError(f"axes {axes} do not match shape {shape}")
        sizes = mesh_sizes(mesh)
        used: set = set()
        out: List[AxisMap] = []
        for dim, name in zip(shape, axes):
            entry: AxisMap = self.table.get(name) if name else None
            cand = tuple(a for a in _as_tuple(entry)
                         if a in sizes and a not in used)
            uneven_ok = name in self.allow_uneven
            # longest prefix that divides the dimension (or, for axes opted
            # into uneven sharding, merely fits)
            while cand:
                prod = math.prod(sizes[a] for a in cand)
                if dim % prod == 0 or (uneven_ok and dim >= prod):
                    break
                cand = cand[:-1]
            if cand:
                used.update(cand)
                out.append(cand if len(cand) > 1 else cand[0])
            else:
                out.append(None)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)

    def placements(self, mesh, axes: Sequence[Optional[str]],
                   shape: Sequence[int]) -> tuple:
        """DTensor placements, one per mesh dim, for ``spec``."""
        # imported here: torch.distributed.tensor takes about a second to
        # import, and the model modules import this package
        from torch.distributed.tensor import Replicate, Shard
        names = tuple(mesh.mesh_dim_names)
        where: Dict[str, int] = {}
        for d, entry in enumerate(self.spec(mesh, axes, shape)):
            entry = _as_tuple(entry)
            order = [names.index(a) for a in entry]
            if order != sorted(order):
                raise ValueError(
                    f"spec entry {entry} at dim {d} does not follow the "
                    f"mesh's order {names}: DTensor would nest its shards "
                    f"otherwise than the PartitionSpec does")
            where.update((a, d) for a in entry)
        return tuple(Shard(where[n]) if n in where else Replicate()
                     for n in names)

    def sharding(self, mesh, axes: Sequence[Optional[str]],
                 shape: Sequence[int]):
        """The NamedSharding twin: (mesh, placements)."""
        return mesh, self.placements(mesh, axes, shape)


def local_box(shape: Sequence[int], mesh, placements):
    """(offset, size) of this rank's block of a tensor of ``shape`` under
    ``placements``, dim by dim: each ``Shard(d)`` in mesh-dim order cuts
    the block's dim ``d`` as ``torch.chunk`` does, the first ranks holding
    ceil(size / n)."""
    off, size = [0] * len(shape), list(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if not p.is_shard():
            continue
        d, n = p.dim, mesh.size(i)
        chunk = -(-size[d] // n)
        start = min(size[d], coord[i] * chunk)
        off[d] += start
        size[d] = min(chunk, size[d] - start)
    return tuple(off), tuple(size)


def local_shape(shape: Sequence[int], mesh, placements) -> Tuple[int, ...]:
    """This rank's local shape (``local_box``'s size)."""
    return local_box(shape, mesh, placements)[1]


def is_axes_leaf(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(e, (str, type(None)))
                                        for e in x)


def tree_map_axes(fn, values, axes):
    """``fn(value, axes)`` over a tree of tensors (nested dicts) and its
    tree of logical axes, in the values' shape."""
    if isinstance(values, dict):
        return {k: tree_map_axes(fn, v, axes[k]) for k, v in values.items()}
    if not is_axes_leaf(axes):
        raise ValueError(f"no axes leaf for a tensor: {axes!r}")
    return fn(values, axes)


def tree_shardings(mesh, shapes_tree, axes_tree,
                   rules: Optional[ShardingRules] = None):
    """Map (tree of tensors, tree of logical axes) -> tree of
    (mesh, placements)."""
    rules = rules or ShardingRules()
    return tree_map_axes(lambda t, ax: rules.sharding(mesh, ax, t.shape),
                         shapes_tree, axes_tree)
