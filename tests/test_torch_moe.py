"""The port's MoE FFN against the JAX package's, on the CPU.

``repro_torch.models.moe.moe_fwd`` against ``repro.models.moe.moe_fwd``
with capacity drops (one and two dispatch groups), against both packages'
dense oracles ``moe_fwd_reference`` when the capacity drops nothing, and
with fewer than 8 tokens, where ``expert_capacity`` clamps. Reduced
granite-moe and phi3.5-moe in fp32, also at their full configs' ratio of
picked to all experts (8 of 32 and 2 of 16, kept as 4 of 16 and 2 of 16).
Inputs come from a numpy seed and go to both frameworks as numpy.

``torch.topk`` and ``jax.lax.top_k`` break ties differently. The tokens
that fill an expert's capacity past those routed to it all have priority
0 and a zero gate, so the tests compare outputs and the aux loss, not the
picked indices. A priority at the capacity cut that differs from the next
one by no more than fp32 noise could drop another token in each package,
so before comparing the tests check that no cut is that close.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced_config as jax_reduced
from repro.models import moe as jmoe
from repro_torch.configs.registry import get_reduced_config
from repro_torch.models import moe as tmoe

#: fp32; the outputs sum up to 8 expert outputs in another order than the
#: JAX scatter does
TOL = dict(rtol=2e-5, atol=2e-5)
#: the least gap between an expert's Cg-th and (Cg+1)-th priority for which
#: no fp32 difference between the packages can drop another token
CUT_MARGIN = 1e-5
#: the same for a token's k-th and (k+1)-th router probability (fp32 router
#: logits of the two packages differ by ~1e-7 here)
ROUTE_MARGIN = 1e-6

ARCHS = ["granite-moe-1b-a400m", "phi3.5-moe-42b-a6.6b"]
#: the reduced configs (4 experts, top-2) and the full configs' ratio of
#: picked experts
MOE_SHAPES = [dict(), dict(num_experts=16, top_k=4), dict(num_experts=16,
                                                          top_k=2)]
CASES = [(ARCHS[0], MOE_SHAPES[0]), (ARCHS[1], MOE_SHAPES[0]),
         (ARCHS[0], MOE_SHAPES[1]), (ARCHS[1], MOE_SHAPES[2])]
CASE_IDS = ["granite", "phi35", "granite-8of32-ratio", "phi35-2of16-ratio"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _cfgs(arch, **moe_kw):
    """(JAX, port) reduced configs in fp32 with ``moe_kw`` replaced."""
    out = []
    for get in (jax_reduced, get_reduced_config):
        cfg = get(arch).replace(dtype="float32")
        out.append(cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw)))
    return out


def _params(rng, cfg):
    d, ff, e = cfg.d_model, cfg.d_ff, cfg.moe.num_experts
    p = {"router": rng.standard_normal((d, e)) / np.sqrt(d),
         "wi": rng.standard_normal((e, d, ff)) / np.sqrt(d),
         "wo": rng.standard_normal((e, ff, d)) / np.sqrt(ff)}
    if cfg.gated_mlp:
        p["wg"] = rng.standard_normal((e, d, ff)) / np.sqrt(d)
    return {k: v.astype(np.float32) for k, v in p.items()}


def _run_both(cfg_j, cfg_t, p, x, jax_fn=jmoe.moe_fwd, torch_fn=None):
    jo, ja = jax_fn(cfg_j, {k: jnp.asarray(v) for k, v in p.items()},
                    jnp.asarray(x))
    with torch.no_grad():
        to, ta = (torch_fn or tmoe.moe_fwd)(
            cfg_t, {k: torch.from_numpy(v) for k, v in p.items()},
            torch.from_numpy(x))
    return (np.asarray(jo), float(ja)), (to.numpy(), float(ta))


def _priorities(cfg, p, x):
    """prio (T, E) as moe_fwd builds it, in float64 numpy."""
    xf = x.reshape(-1, x.shape[-1]).astype(np.float64)
    logits = xf @ p["router"].astype(np.float64)
    probs = np.exp(logits - logits.max(-1, keepdims=True))
    probs /= probs.sum(-1, keepdims=True)
    k = cfg.moe.top_k
    order = np.argsort(-probs, axis=-1)
    top = np.take_along_axis(probs, order[:, :k], -1)
    # the k-th and (k+1)-th router probabilities must not be a near-tie
    # either, or the packages could route a token to different experts
    nxt = np.take_along_axis(probs, order[:, k:k + 1], -1)[:, 0]
    assert (top[:, -1] - nxt).min() > ROUTE_MARGIN
    prio = np.zeros_like(probs)
    np.put_along_axis(prio, order[:, :k], top / top.sum(-1, keepdims=True),
                      -1)
    return prio


def _drops(cfg, p, x):
    """Count the routed (token, expert) picks past the capacity, after
    checking that no capacity cut is a near-tie."""
    prio = _priorities(cfg, p, x)
    T, E = prio.shape
    G = max(1, min(cfg.moe.dispatch_groups, T))
    Cg = max(1, tmoe.expert_capacity(cfg, T) // G)
    dropped = 0
    for g in range(G):
        part = np.sort(prio[g * (T // G):(g + 1) * (T // G)], axis=0)[::-1]
        if Cg < T // G:
            at, after = part[Cg - 1], part[Cg]
            assert ((at - after > CUT_MARGIN) | (at == 0)).all(), (at, after)
        dropped += int((part[Cg:] > 0).sum())
    return dropped


@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("arch,moe_kw", CASES, ids=CASE_IDS)
def test_moe_fwd_matches_jax_with_capacity_drops(arch, moe_kw, groups):
    """The default capacity factor 1.25 over 4 x 24 tokens that share a
    common direction, so that routing is skewed and experts overflow (the
    test checks that some picks are dropped)."""
    cfg_j, cfg_t = _cfgs(arch, dispatch_groups=groups, **moe_kw)
    rng = np.random.default_rng(0)
    p = _params(rng, cfg_t)
    d = cfg_t.d_model
    x = (rng.standard_normal((4, 24, d)) + 1.5 * rng.standard_normal(d)) \
        .astype(np.float32)
    assert _drops(cfg_t, p, x) > 0
    (jo, ja), (to, ta) = _run_both(cfg_j, cfg_t, p, x)
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_allclose(ta, ja, **TOL)


@pytest.mark.parametrize("arch,moe_kw", CASES, ids=CASE_IDS)
def test_moe_fwd_without_drops_matches_the_dense_oracles(arch, moe_kw):
    """A capacity factor that fits every pick: ``moe_fwd`` equals the JAX
    dense oracle and the port's own, and the port's oracle the JAX one."""
    cfg_j, cfg_t = _cfgs(arch, capacity_factor=100.0, **moe_kw)
    rng = np.random.default_rng(1)
    p = _params(rng, cfg_t)
    x = rng.standard_normal((3, 11, cfg_t.d_model)).astype(np.float32)
    assert _drops(cfg_t, p, x) == 0
    (jr, jra), (tr, tra) = _run_both(cfg_j, cfg_t, p, x,
                                     jmoe.moe_fwd_reference,
                                     tmoe.moe_fwd_reference)
    np.testing.assert_allclose(tr, jr, **TOL)
    np.testing.assert_allclose(tra, jra, **TOL)
    (jo, ja), (to, ta) = _run_both(cfg_j, cfg_t, p, x)
    np.testing.assert_allclose(to, jr, **TOL)
    np.testing.assert_allclose(to, tr, **TOL)
    np.testing.assert_allclose(ta, tra, rtol=1e-6, atol=0)


@pytest.mark.parametrize("n_tokens", [1, 5, 7, 8, 40, 4096])
def test_expert_capacity_matches_jax(n_tokens):
    """Clamped below at 8 and above at the token count, rounded up to 8,
    at granite's full config (decode: 8 tokens; prefill: 4096)."""
    from repro.configs.registry import get_config as jax_config
    from repro_torch.configs.registry import get_config
    for arch in ARCHS:
        assert tmoe.expert_capacity(get_config(arch), n_tokens) \
            == jmoe.expert_capacity(jax_config(arch), n_tokens)
    if n_tokens == 4096:
        assert tmoe.expert_capacity(get_config(ARCHS[0]), n_tokens) == 1280


@pytest.mark.parametrize("b,s", [(1, 1), (1, 5), (2, 3)])
def test_moe_fwd_with_fewer_than_eight_tokens(b, s):
    """T < 8: the capacity clamps to T, every expert may take every token,
    nothing is dropped; equal to the JAX ``moe_fwd`` and the dense oracle."""
    cfg_j, cfg_t = _cfgs(ARCHS[0])
    rng = np.random.default_rng(2)
    p = _params(rng, cfg_t)
    x = rng.standard_normal((b, s, cfg_t.d_model)).astype(np.float32)
    assert tmoe.expert_capacity(cfg_t, b * s) == b * s
    (jo, ja), (to, ta) = _run_both(cfg_j, cfg_t, p, x)
    np.testing.assert_allclose(to, jo, **TOL)
    np.testing.assert_allclose(ta, ja, **TOL)
    with torch.no_grad():
        ref, _ = tmoe.moe_fwd_reference(
            cfg_t, {k: torch.from_numpy(v) for k, v in p.items()},
            torch.from_numpy(x))
    np.testing.assert_allclose(to, ref.numpy(), **TOL)


def test_moe_fwd_combine_is_reproducible_and_drops_pad_rows_alone():
    """Two runs give the same bits, and all-equal rows (the engine pads a
    chunk with copies of token 0) change no real row's output: the real
    rows' outputs with and without pad rows appended agree whenever the
    real rows' own picks fit the capacity either way."""
    _, cfg = _cfgs(ARCHS[0], capacity_factor=100.0)
    rng = np.random.default_rng(3)
    p = {k: torch.from_numpy(v) for k, v in _params(rng, cfg).items()}
    x = torch.from_numpy(rng.standard_normal((3, 7, cfg.d_model))
                         .astype(np.float32))
    with torch.no_grad():
        a, _ = tmoe.moe_fwd(cfg, p, x)
        b, _ = tmoe.moe_fwd(cfg, p, x)
        padded = torch.cat([x, x[:1, :1].expand(1, 7, -1)])
        c, _ = tmoe.moe_fwd(cfg, p, padded)
    assert torch.equal(a, b)
    torch.testing.assert_close(c[:3], a, rtol=1e-6, atol=1e-6)
