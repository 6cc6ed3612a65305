"""The port's xLSTM path against the JAX package's, on the CPU.

The mLSTM chunkwise form (whole chunks and a padded last chunk, with and
without a seeded state), the sLSTM time scan, both block forwards with
their states, each cell's decode steps from the prefill state, and a
state whose stabiliser is -inf throughout; then reduced xlstm-350m
(weights from the JAX package through ``repro_torch.bridge``): prefill
and 3 decode steps, and every cache entry. Inputs come from a numpy seed
and go to both frameworks as numpy; fp32. Each test states its tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced_config as jax_reduced
from repro.models import model as JM
from repro.models import ssm as jssm
from repro_torch.bridge import params_from_jax
from repro_torch.configs.registry import get_reduced_config
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm

#: tests/test_kernels.py's fp32 tolerance
TOL = dict(rtol=2e-5, atol=2e-5)
ARCH = "xlstm-350m"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def cfgs():
    """(JAX, port) reduced xlstm-350m in fp32: d_model 64, 4 heads (mLSTM
    heads of 32, sLSTM heads of 16), chunk 16, 4 layers (2 pairs)."""
    return (jax_reduced(ARCH).replace(dtype="float32"),
            get_reduced_config(ARCH).replace(dtype="float32"))


@pytest.fixture(scope="module")
def params(cfgs):
    """The JAX package's random weights, and the same on the port's side."""
    cfg_j, cfg_t = cfgs
    jp = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    return jp, params_from_jax(cfg_t, jax.tree.map(np.asarray, jp), "cpu")


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, exp, rel):
    """max |got - exp| <= rel * max |exp| (the mLSTM's C grows with the
    prompt, so its scale is set by its largest entries)."""
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    assert got.shape == exp.shape
    err, scale = np.abs(got - exp).max(), np.abs(exp).max()
    assert err <= rel * scale, f"max |diff| {err} > {rel} * {scale}"


def _first(tree, *index):
    """The first block's parameters: JAX (a pytree of jax arrays) or port."""
    if isinstance(tree, dict):
        return {k: _first(v, *index) for k, v in tree.items()}
    return tree[index]


def _mlstm_inputs(rng, b, s, nh, dh):
    q, k, v = (rng.standard_normal((b, s, nh, dh)).astype(np.float32)
               for _ in range(3))
    li = rng.standard_normal((b, s, nh)).astype(np.float32)
    lf = np.log(1 / (1 + np.exp(-(rng.standard_normal((b, s, nh)) + 3.0)))) \
        .astype(np.float32)
    return q, k, v, li, lf


def _mlstm_state(rng, b, nh, dh, m=None):
    C = rng.standard_normal((b, nh, dh, dh)).astype(np.float32)
    n = rng.standard_normal((b, nh, dh)).astype(np.float32)
    if m is None:
        m = rng.standard_normal((b, nh)).astype(np.float32)
    return C, n, m


# ---------------------------------------------------------------------------
# the cells
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,with_init", [(32, False), (37, False),
                                         (32, True), (37, True), (9, True)])
def test_mlstm_chunkwise_matches_jax(s, with_init):
    """Chunk 16: two whole chunks (32), a padded third chunk (37), shorter
    than one chunk (9); outputs and the final (C, n, m). Outputs within
    TOL; C and n within 2e-5 of their largest entry."""
    rng = np.random.default_rng(0)
    b, nh, dh = 2, 3, 8
    q, k, v, li, lf = _mlstm_inputs(rng, b, s, nh, dh)
    init = _mlstm_state(rng, b, nh, dh) if with_init else None
    jh, (jC, jn, jm) = jssm.mlstm_chunkwise(
        *(jnp.asarray(a) for a in (q, k, v, li, lf)), 16,
        None if init is None else tuple(jnp.asarray(a) for a in init))
    th, (tC, tn, tm) = tssm.mlstm_chunkwise(
        *(_t(a) for a in (q, k, v, li, lf)), 16,
        None if init is None else tuple(_t(a) for a in init))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)
    _close(tC.numpy(), jC, 2e-5)
    _close(tn.numpy(), jn, 2e-5)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), **TOL)


@pytest.mark.parametrize("with_init", [False, True])
def test_slstm_cell_scan_matches_jax(cfgs, params, with_init):
    """The reduced config's first sLSTM block over 13 steps, from the
    zero state (stabiliser -inf) or a random one; outputs and the final
    (c, n, h, m) within TOL."""
    cfg_j, cfg_t = cfgs
    jp, tp = params
    rng = np.random.default_rng(1)
    b, s, d, nh = 2, 13, cfg_t.d_model, cfg_t.n_heads
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    init = None
    if with_init:
        init = tuple(rng.standard_normal((b, nh, d // nh)).astype(np.float32)
                     for _ in range(4))
        init = (init[0], np.abs(init[1]) + 0.5, init[2], init[3])
    jy, jst = jssm.slstm_cell_scan(
        cfg_j, _first(jp["s"], 0), jnp.asarray(x),
        None if init is None else tuple(jnp.asarray(a) for a in init))
    ty, tst = tssm.slstm_cell_scan(
        cfg_t, _first(tp["s"], 0), _t(x),
        None if init is None else tuple(_t(a) for a in init))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    for got, exp in zip(tst, jst):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL)


def _block_parity(cfgs, params, kind, s):
    """The first block of ``kind`` ("m" or "s") with ``return_state`` over
    an s-token input, then 4 decode steps of it from that state; returns
    nothing, asserts as it goes."""
    cfg_j, cfg_t = cfgs
    jp, tp = params
    index = (0, 0) if kind == "m" else (0,)
    jbp, tbp = _first(jp[kind], *index), _first(tp[kind], *index)
    if kind == "m":
        jfwd, tfwd = jssm.mlstm_block_fwd, tssm.mlstm_block_fwd
        jdec, tdec = jssm.mlstm_decode_step, tssm.mlstm_decode_step
    else:
        jfwd, tfwd = jssm.slstm_block_fwd, tssm.slstm_block_fwd
        jdec, tdec = jssm.slstm_decode_step, tssm.slstm_decode_step
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, s, cfg_t.d_model)).astype(np.float32)
    jo, jst = jfwd(cfg_j, jbp, jnp.asarray(x), return_state=True)
    with torch.no_grad():
        to, tst = tfwd(cfg_t, tbp, _t(x), return_state=True)
    _close(to.numpy(), jo, 2e-5)
    for got, exp in zip(tst, jst):
        _close(got.numpy(), exp, 2e-5)
    for step in range(4):
        xt = rng.standard_normal((2, 1, cfg_t.d_model)).astype(np.float32)
        jo, jst = jdec(cfg_j, jbp, jnp.asarray(xt), jst)
        with torch.no_grad():
            to, tst = tdec(cfg_t, tbp, _t(xt), tst)
        _close(to.numpy(), jo, 2e-5)
        for got, exp in zip(tst, jst):
            _close(got.numpy(), exp, 2e-5)


@pytest.mark.parametrize("kind,s", [("m", 37), ("s", 21)])
def test_blocks_and_their_decode_steps_match_jax(cfgs, params, kind, s):
    """Each block forward with ``return_state`` (the mLSTM over a padded
    last chunk), then 4 decode steps from the state it returned: outputs
    and states within 2e-5 of their largest entry (the random block
    weights make outputs of ~10-400, where fp32 summation order moves the
    last digits by ~1e-4)."""
    _block_parity(cfgs, params, kind, s)


def test_minus_inf_stabiliser_gives_finite_outputs(cfgs, params):
    """A state whose running max ``m`` is -inf throughout (the cache as
    allocated) with a nonzero C and n: exp(m + F - m_new) must be 0, not
    NaN, in the chunkwise form and in both decode steps; the outputs
    equal the JAX package's (the cell's within TOL, the blocks' within
    2e-5 of their largest entry)."""
    cfg_j, cfg_t = cfgs
    jp, tp = params
    rng = np.random.default_rng(3)
    b, nh, dh = 2, 3, 8
    q, k, v, li, lf = _mlstm_inputs(rng, b, 20, nh, dh)
    init = _mlstm_state(rng, b, nh, dh, np.full((b, nh), -np.inf, np.float32))
    th, st = tssm.mlstm_chunkwise(*(_t(a) for a in (q, k, v, li, lf)), 16,
                                  tuple(_t(a) for a in init))
    jh, _ = jssm.mlstm_chunkwise(*(jnp.asarray(a) for a in (q, k, v, li, lf)),
                                 16, tuple(jnp.asarray(a) for a in init))
    assert torch.isfinite(th).all() and all(torch.isfinite(t).all()
                                            for t in st)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), **TOL)

    x = rng.standard_normal((b, 1, cfg_t.d_model)).astype(np.float32)
    _, _, dh_m = tssm.xlstm_dims(cfg_t)
    minit = _mlstm_state(rng, b, cfg_t.n_heads, dh_m,
                         np.full((b, cfg_t.n_heads), -np.inf, np.float32))
    dh_s = cfg_t.d_model // cfg_t.n_heads
    sinit = tuple(rng.standard_normal((b, cfg_t.n_heads, dh_s))
                  .astype(np.float32) for _ in range(3)) \
        + (np.full((b, cfg_t.n_heads, dh_s), -np.inf, np.float32),)
    for kind, index, init, tfn, jfn in [
            ("m", (0, 0), minit, tssm.mlstm_decode_step,
             jssm.mlstm_decode_step),
            ("s", (0,), sinit, tssm.slstm_decode_step,
             jssm.slstm_decode_step)]:
        with torch.no_grad():
            to, tst = tfn(cfg_t, _first(tp[kind], *index), _t(x),
                          tuple(_t(a) for a in init))
        jo, _ = jfn(cfg_j, _first(jp[kind], *index), jnp.asarray(x),
                    tuple(jnp.asarray(a) for a in init))
        assert torch.isfinite(to).all() and all(torch.isfinite(t).all()
                                                for t in tst)
        _close(to.numpy(), jo, 2e-5)


# ---------------------------------------------------------------------------
# the whole reduced model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [16, 21])
def test_reduced_xlstm_prefill_and_decode_match_jax(cfgs, params, s):
    """Reduced xlstm-350m (2 pairs of one mLSTM and one sLSTM block): the
    prefill logits (a whole chunk, and a padded one), then 3 decode steps
    fed JAX's greedy tokens; logits within 1e-4 (four blocks of fp32
    summation-order differences), every cache entry within 1e-4 of its
    largest entry, ``pos`` exactly. The decode steps update the cache in
    place: each entry keeps its storage."""
    cfg_j, cfg_t = cfgs
    jp, tp = params
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, cfg_t.vocab, (3, s)).astype(np.int32)
    jl, jc = JM.prefill(cfg_j, jp, jnp.asarray(tokens), max_len=32)
    with torch.no_grad():
        tl, tc = TM.prefill(cfg_t, tp, _t(tokens), max_len=32)
    tol = dict(rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    addresses = {k: v.data_ptr() for k, v in tc.items()}
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        jl, jc = JM.decode_step(cfg_j, jp, jc, jnp.asarray(nxt))
        with torch.no_grad():
            tl, tc = TM.decode_step(cfg_t, tp, tc, _t(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    assert set(tc) == set(jc)
    assert {k: v.data_ptr() for k, v in tc.items()} == addresses
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for key in ("mC", "mn", "mm", "sc", "sn", "sh", "sm"):
        assert tc[key].shape == jc[key].shape, key
        _close(tc[key].numpy(), jc[key], 1e-4)


def test_init_cache_matches_jax(cfgs):
    """Keys, shapes and dtypes of the xLSTM cache, the stabilisers at -inf
    and everything else at zero, as the JAX package's ``init_cache``."""
    cfg_j, cfg_t = cfgs
    jc = JM.init_cache(cfg_j, 3, 32)
    tc = TM.init_cache(cfg_t, 3, 32, "cpu")
    assert set(tc) == set(jc)
    for key, t in tc.items():
        assert tuple(t.shape) == jc[key].shape, key
        assert str(t.dtype).split(".")[-1] == str(jc[key].dtype), key
        np.testing.assert_array_equal(t.numpy(), np.asarray(jc[key]))
