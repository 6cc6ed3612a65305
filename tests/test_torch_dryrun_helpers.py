"""The model-level dry-run helpers of the port against the JAX package.

For every architecture at full width, and every applicable shape of
``configs.registry.dryrun_cells()``: the port's abstract trees (tensors on
the meta device: nothing allocated) have the leaf paths, shapes and
dtypes of the JAX package's ``ShapeDtypeStruct`` trees, and its logical
axes trees are equal to the JAX package's. Then the abstract trees
against the trees the port materialises on a reduced config, and
``make_train_step`` against ``train_step``.
"""
import copy

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import dryrun_cells as jax_cells
from repro.configs.registry import get_config as jax_config
from repro.models import model as JM
from repro.train import optimizer as JO
from repro_torch.configs.registry import dryrun_cells, get_config, \
    get_reduced_config, list_archs
from repro_torch.models import model as TM
from repro_torch.train import optimizer as TO
from repro_torch.train.train_step import make_train_step, train_step

ARCHS = list_archs()
CELLS = [(cfg.arch_id, shape.name) for cfg, shape, _, _ in dryrun_cells()]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _jax_leaves(tree):
    """path -> (shape, dtype name) of a ShapeDtypeStruct tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {tuple(k.key for k in path): (tuple(leaf.shape),
                                         np.dtype(leaf.dtype).name)
            for path, leaf in flat}


def _port_leaves(tree, prefix=()):
    """path -> (shape, dtype name) of a nested dict of meta tensors."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_port_leaves(v, prefix + (k,)))
        return out
    assert tree.device.type == "meta", prefix
    return {prefix: (tuple(tree.shape),
                     str(tree.dtype).removeprefix("torch."))}


def _cfgs(arch):
    return jax_config(arch), get_config(arch)


def _shape(arch, name):
    (shape,) = [s for c, s, _, _ in dryrun_cells()
                if c.arch_id == arch and s.name == name]
    (jshape,) = [s for c, s, _, _ in jax_cells()
                 if c.arch_id == arch and s.name == name]
    return jshape, shape


def test_the_cells_are_the_reference_cells():
    assert CELLS == [(c.arch_id, s.name) for c, s, _, _ in jax_cells()]
    assert len(ARCHS) == 10


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_match_the_reference(arch):
    jc, tc = _cfgs(arch)
    ref = _jax_leaves(JM.abstract_params(jc))
    assert _port_leaves(TM.abstract_params(tc)) == ref
    assert TM.param_axes(tc) == JM.param_axes(jc)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_opt_state_matches_the_reference(arch):
    jc, tc = _cfgs(arch)
    ref = _jax_leaves(JO.abstract_opt_state(JM.abstract_params(jc)))
    got = _port_leaves(TO.abstract_opt_state(TM.abstract_params(tc)))
    assert got == ref
    assert TO.opt_state_axes(TM.param_axes(tc)) \
        == JO.opt_state_axes(JM.param_axes(jc))


@pytest.mark.parametrize("arch,shape", CELLS, ids="/".join)
def test_input_specs_match_the_reference(arch, shape):
    """Inputs and, for the decode shapes, the abstract cache."""
    jc, tc = _cfgs(arch)
    jshape, tshape = _shape(arch, shape)
    assert TM.text_len(tc, tshape) == JM.text_len(jc, jshape)
    got = _port_leaves(TM.input_specs(tc, tshape))
    assert got == _jax_leaves(JM.input_specs(jc, jshape))
    assert TM.input_axes(tc, tshape) == JM.input_axes(jc, jshape)
    if tshape.is_decode:
        assert TM.cache_axes(tc) == JM.cache_axes(jc)
        assert set(TM.cache_axes(tc)) == {k[1] for k in got
                                          if k[0] == "cache"}


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_trees_describe_what_the_port_materialises(arch):
    """On the reduced config: the meta parameters and cache have the
    paths, shapes and dtypes of ``init_params`` and ``init_cache``."""
    cfg = get_reduced_config(arch)
    gen = torch.Generator().manual_seed(0)
    real = TM.init_params(cfg, gen, "cpu")
    meta = TM.abstract_params(cfg)

    def described(tree):
        return _port_leaves(TO.tree_map(lambda t: t.to("meta"), tree))

    assert _port_leaves(meta) == described(real)
    cache = TM.init_cache(cfg, 3, 32, "cpu")
    assert _port_leaves(TM.init_cache(cfg, 3, 32, torch.device("meta"))) \
        == described(cache)
    assert _port_leaves(TO.abstract_opt_state(meta)) \
        == described(TO.init_opt_state(real))


def test_make_train_step_is_train_step():
    """Reduced stablelm-1.6b in fp32: two steps through
    ``make_train_step`` give the bits of two ``train_step`` calls."""
    cfg = get_reduced_config("stablelm-1.6b").replace(dtype="float32")
    oc = TO.OptConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    opt = TO.init_opt_state(params)
    p2, o2 = copy.deepcopy(params), copy.deepcopy(opt)
    gen = torch.Generator().manual_seed(1)
    step = make_train_step(cfg, oc)
    for _ in range(2):
        tokens = torch.randint(0, cfg.vocab, (2, 16), generator=gen,
                               dtype=torch.int32)
        batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
        params, opt, m1 = step(params, opt, batch)
        p2, o2, m2 = train_step(cfg, oc, p2, o2, batch)
        assert float(m1["loss"].detach()) == float(m2["loss"].detach())
    for a, b in zip(TO.tree_leaves(params), TO.tree_leaves(p2)):
        assert torch.equal(a, b)
    assert int(opt["step"]) == int(o2["step"]) == 2
