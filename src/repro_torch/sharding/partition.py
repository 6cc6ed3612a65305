"""Activation placement helpers (torch counterpart of
``repro.sharding.partition``).

Model code calls :func:`lshard` with *logical* axis names. When a mesh is
active (set by the dry run with :func:`use_mesh_rules`), it redistributes
the ``DTensor`` to the placements the rules give, the counterpart of
``jax.lax.with_sharding_constraint``; otherwise it returns its input, so
the same model code runs un-meshed on the card and in the tests. Under a
mesh a plain tensor is an error: a region of the model lost its
placements.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional

import torch

from repro_torch.sharding.rules import ShardingRules

_state = threading.local()


def _ctx():
    return getattr(_state, "ctx", None)


@contextmanager
def use_mesh_rules(mesh, rules: Optional[ShardingRules] = None):
    prev = _ctx()
    _state.ctx = (mesh, rules or ShardingRules())
    try:
        yield
    finally:
        _state.ctx = prev


def active_mesh():
    c = _ctx()
    return c[0] if c else None


def active_rules() -> Optional[ShardingRules]:
    c = _ctx()
    return c[1] if c else None


def place(make, axes_tree):
    """``make()``, a tree of tensors made inside a step (the cache that
    prefill allocates), placed as its logical axes say under the active
    mesh; without a mesh, ``make()`` as it is. Under a mesh ``make()``
    runs with the dispatch modes off (its global meta tensors are
    stand-ins, not memory), meta tensors become DTensors over empty local
    tensors, and others are distributed."""
    c = _ctx()
    if c is None:
        return make()
    from torch.distributed.tensor import distribute_tensor
    from torch.utils._python_dispatch import _disable_current_modes
    from repro_torch.sharding.rules import tree_map_axes
    mesh, rules = c
    with _disable_current_modes():
        tree = make()

    def one(t, axes):
        pl = rules.placements(mesh, axes, t.shape)
        if t.device.type != "meta":
            return distribute_tensor(t, mesh, pl)
        return abstract_dtensor(t, mesh, pl)

    return tree_map_axes(one, tree, axes_tree)


def abstract_dtensor(t: torch.Tensor, mesh, placements):
    """A DTensor of ``t``'s shape and dtype whose rank-local tensor is an
    empty meta tensor of the local shape ``placements`` give this rank."""
    from torch.distributed.tensor import DTensor
    from repro_torch.sharding.rules import local_shape
    local = torch.empty(local_shape(t.shape, mesh, placements),
                        dtype=t.dtype, device="meta")
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def _replicated(x: torch.Tensor, which) -> torch.Tensor:
    """The DTensor ``x`` with the placements ``which(i, p)`` picks (mesh
    dim i, placement p) gathered into ``Replicate()``; ``x`` itself when
    it picks none."""
    from torch.distributed.tensor import Replicate
    pl = [Replicate() if which(i, p) else p
          for i, p in enumerate(x.placements)]
    if pl == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, pl)


def split_last(x: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """x (..., n * k) viewed as (..., n, k). Under a mesh a shard of the
    last dim that does not fall on whole groups of k is gathered first:
    DTensor cannot view it (a product DTensor sharded its columns)."""
    last = x.dim() - 1
    if _ctx() is not None and any(
            p.is_shard(last) and n % x.device_mesh.size(i)
            for i, p in enumerate(x.placements)):
        x = _replicated(x, lambda i, p: p.is_shard(last))
    return x.view(*x.shape[:-1], n, k)


def pin(x: torch.Tensor) -> torch.Tensor:
    """``x``; under a mesh, with its gradient brought back to ``x``'s
    placements before it flows on: a product's backward may shard a
    gradient where the view that made ``x`` cannot follow."""
    if _ctx() is None:
        return x
    return x.redistribute(x.device_mesh, x.placements)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w``; under a mesh, x's dims between its first and last (the
    residual stream's sequence) gathered first, as GSPMD's
    sequence-parallel boundary does, and the product's gradient brought
    back to the product's placements before its backward runs: ``matmul``
    flattens the leading dims of both, which DTensor cannot do with the
    second sharded (torch 2.11 refuses; torch 2.13 makes strided shards
    whose redistributions it plans slowly)."""
    if _ctx() is None:
        return x @ w
    x = _replicated(x, lambda i, p: p.is_shard() and 0 < p.dim < x.dim() - 1)
    return pin(x @ w)


def settle(x: torch.Tensor) -> torch.Tensor:
    """``x``; under a mesh, with its partial sums reduced (a lookup in a
    vocab-sharded table is one: DTensor's mask for it cannot be split
    again on the meta device)."""
    if _ctx() is None:
        return x
    return _replicated(x, lambda i, p: p.is_partial())


def unmeshed(fn):
    """``fn`` run with no mesh active: the body of a region run per device
    (``run_local``) works on local tensors, where the model's annotations
    have nothing to place."""
    def run(*args, **kwargs):
        prev = _ctx()
        _state.ctx = None
        try:
            return fn(*args, **kwargs)
        finally:
            _state.ctx = prev
    return run


def run_local(fn, args, in_pl, grad_pl, out_pl, out_shapes):
    """``fn`` run by every device on its own shards, the counterpart of
    GSPMD partitioning a region DTensor has no sharding strategy for (as
    ``torch.distributed.tensor.experimental.local_map``, which cannot put
    unevenly sharded outputs together). Each DTensor of ``args`` is
    redistributed to its entry of ``in_pl`` (``None`` for a non-tensor),
    its gradient taken as placed by ``grad_pl`` (a plain tensor, a constant
    made inside the step, counts as replicated); ``fn`` runs with no mesh
    active on the local tensors; each output becomes a DTensor of
    ``out_pl``'s placements and ``out_shapes``' global shape (a callable of
    the local outputs)."""
    from torch.distributed.tensor import DTensor, Replicate
    mesh = _ctx()[0]

    def replicated(a):
        # a plain tensor here is a constant made inside the step: the same
        # on every device
        if isinstance(a, DTensor):
            return a
        return DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)

    local = [a if pl is None else
             replicated(a).redistribute(mesh, pl).to_local(
                 grad_placements=gpl)
             for a, pl, gpl in zip(args, in_pl, grad_pl)]
    outs = unmeshed(fn)(*local)
    single = isinstance(outs, torch.Tensor)
    outs = (outs,) if single else tuple(outs)
    res = []
    for o, pl, shape in zip(outs, out_pl, out_shapes(outs)):
        res.append(DTensor.from_local(o, mesh, pl, run_check=False,
                                      shape=torch.Size(shape),
                                      stride=_contiguous_strides(shape)))
    return res[0] if single else tuple(res)


def elementwise(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)`` for an elementwise ``fn``; under a mesh per device on
    ``x``'s own shards (its partial sums reduced first), where DTensor has
    no strategy for ``fn`` or its backward."""
    if _ctx() is None:
        return fn(x)
    x = settle(x)
    return run_local(fn, (x,), (x.placements,), (x.placements,),
                     [x.placements], lambda outs: [x.shape])


def _contiguous_strides(shape) -> tuple:
    strides, n = [], 1
    for size in reversed(tuple(shape)):
        strides.append(n)
        n *= size
    return tuple(reversed(strides))


def on_shards(fn, args, in_axes, out_axes, partial=()):
    """``fn(*args)``; under a mesh, run by every device on its own shards
    (``run_local``): each tensor of ``args`` placed as its logical axes in
    ``in_axes`` say (``None`` for a non-tensor), each output as its axes
    in ``out_axes`` say, an output dim sharded as the input dims of the
    same logical name are, and a partial sum over the mesh dims of the
    logical names in ``partial`` (a contraction split there). An argument
    replicated on a mesh dim that another is sharded on gets a partial
    gradient there: each device adds its shard's part."""
    c = _ctx()
    if c is None:
        return fn(*args)
    from torch.distributed.tensor import Partial, Replicate, Shard
    mesh, rules = c
    names = tuple(mesh.mesh_dim_names)
    in_pl, where, size = [], {}, {}
    for a, axes in zip(args, in_axes):
        if not isinstance(a, torch.Tensor):
            in_pl.append(None)
            continue
        spec = rules.spec(mesh, axes, a.shape) + (None,) * len(axes)
        for name, entry, n in zip(axes, spec, a.shape):
            entry = (entry,) if isinstance(entry, str) else tuple(entry or ())
            if name is not None and where.setdefault(name, entry) != entry:
                raise ValueError(f"logical axis {name!r} resolves to both "
                                 f"{where[name]} and {entry} in one region")
            if name is not None:
                size[name] = n
        in_pl.append(rules.placements(mesh, axes, a.shape))
    sharded = {i for pl in in_pl if pl for i, p in enumerate(pl)
               if p.is_shard()}
    grad_pl = [None if pl is None else tuple(
        p if p.is_shard() else Partial() if i in sharded else Replicate()
        for i, p in enumerate(pl)) for pl in in_pl]
    summed = {n for name in partial for n in where.get(name, ())}

    def placements(axes):
        dims = {n: d for d, name in enumerate(axes) if name is not None
                for n in where.get(name, ())}
        return tuple(Shard(dims[n]) if n in dims else
                     Partial() if n in summed else Replicate()
                     for n in names)

    def shapes(outs):
        return [tuple(size[name] if name is not None and where.get(name)
                      else n for name, n in zip(axes, o.shape))
                for axes, o in zip(out_axes, outs)]

    return run_local(fn, args, in_pl, grad_pl,
                     [placements(a) for a in out_axes], shapes)


def lshard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Place ``x`` as its logical ``axes`` say under the active mesh, or
    return it unchanged when no mesh is active."""
    c = _ctx()
    if c is None:
        return x
    from torch.distributed.tensor import DTensor
    mesh, rules = c
    if not isinstance(x, DTensor):
        raise TypeError(f"lshard{axes}: a plain {type(x).__name__} of shape "
                        f"{tuple(x.shape)} under an active mesh")
    return x.redistribute(mesh, rules.placements(mesh, axes, x.shape))
