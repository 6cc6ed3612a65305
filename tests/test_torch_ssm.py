"""The port's Mamba-2 and zamba2 path against the JAX package's, on the CPU.

The SSD scan (the port's wrapper, which computes its plain version for CPU
tensors) against the pure-JAX ``repro.models.ssm.ssd_scan``, the Pallas
kernel in interpret mode and the sequential oracles of both packages; the
conv, the Mamba-2 block and its decode step; and reduced zamba2 (weights
from the JAX package through ``repro_torch.bridge``): prefill, 4 decode
steps and every cache entry. Inputs come from a numpy seed and go to both
frameworks as numpy. fp32 unless a test says otherwise; each test states
its tolerance. The CUDA kernel itself runs only on a card:
tests/test_torch_gpu.py (marker ``gpu``) and chip_smoke.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced_config as jax_reduced
from repro.kernels import ref as jref
from repro.kernels.ops import ssd_bshn as jax_ssd_bshn
from repro.kernels.ssd_scan import ssd_scan_kernel as pallas_ssd
from repro.models import model as JM
from repro.models import ssm as jssm
from repro_torch.bridge import params_from_jax, tensor_from_numpy
from repro_torch.configs.registry import get_reduced_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.models import model as TM
from repro_torch.models import ssm as tssm

#: tests/test_kernels.py's fp32 tolerance
TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scan_inputs(rng, b, s, nh, P, g, N):
    """Scaled as tests/test_kernels.py::test_ssd_scan_sweep scales them."""
    x = rng.standard_normal((b, s, nh, P)).astype(np.float32) * 0.5
    dt = np.log1p(np.exp(rng.standard_normal((b, s, nh)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(nh) * 0.3).astype(np.float32)
    B = rng.standard_normal((b, s, g, N)).astype(np.float32) * 0.5
    C = rng.standard_normal((b, s, g, N)).astype(np.float32) * 0.5
    return x, dt, A, B, C


def _close_to_max(got, exp, rel):
    """max |got - exp| <= rel * max |exp|: for values whose scale is set by
    a few large entries (SSM states reach 1e3-1e4 here)."""
    got, exp = np.asarray(got, np.float64), np.asarray(exp, np.float64)
    assert got.shape == exp.shape
    err, scale = np.abs(got - exp).max(), np.abs(exp).max()
    assert err <= rel * scale, f"max |diff| {err} > {rel} * {scale}"


# ---------------------------------------------------------------------------
# the SSD scan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s,nh,g,chunk,with_init", [
    (13, 4, 1, 16, False),    # shorter than one chunk
    (37, 4, 1, 16, False),    # ragged last chunk
    (64, 4, 1, 16, False),    # whole chunks
    (37, 4, 2, 16, False),    # two B/C groups
    (37, 4, 1, 16, True),     # seeded state
])
def test_ssd_scan_matches_jax(s, nh, g, chunk, with_init):
    """y and the final state against repro.models.ssm.ssd_scan. fp32,
    rtol = atol = 2e-5: the two differ only in summation order."""
    rng = np.random.default_rng(20 + s + g)
    b, P, N = 2, 16, 8
    x, dt, A, B, C = _scan_inputs(rng, b, s, nh, P, g, N)
    init = rng.standard_normal((b, nh, P, N)).astype(np.float32) \
        if with_init else None
    jy, js = jssm.ssd_scan(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A),
                           jnp.asarray(B), jnp.asarray(C), chunk,
                           None if init is None else jnp.asarray(init))
    ty, ts = tssm.ssd_scan(_t(x), _t(dt), _t(A), _t(B), _t(C), chunk,
                           None if init is None else _t(init))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), **TOL)
    # the chunk changes only the order of summation, not the function
    ty8, ts8 = SSD.ssd_scan(_t(x), _t(dt), _t(A), _t(B), _t(C), 8,
                            None if init is None else _t(init))
    np.testing.assert_allclose(ty8.numpy(), ty.numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ts8.numpy(), ts.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("BH,S,P,N,Q", [
    (2, 128, 32, 16, 32),
    (4, 256, 64, 64, 128),
    (3, 96, 16, 8, 32),
])
def test_ssd_scan_matches_pallas_and_the_oracles(BH, S, P, N, Q):
    """In the Pallas kernel's layout (b = 1, one group per head, S % Q ==
    0): the port against ssd_scan_kernel(interpret=True), and the port's
    ref.ssd_scan_ref against the JAX one. Tolerance 2e-4, as
    tests/test_kernels.py::test_ssd_scan_sweep: the recurrence sums in
    another order than the chunked scan."""
    rng = np.random.default_rng(30 + S)
    x, dt, A, B, C = _scan_inputs(rng, 1, S, BH, P, BH, N)
    y, _ = SSD.ssd_scan(_t(x), _t(dt), _t(A), _t(B), _t(C), Q)
    y_bh = y.numpy()[0].transpose(1, 0, 2)                   # (BH, S, P)
    xb, dtb = x[0].transpose(1, 0, 2), dt[0].T
    Bb, Cb = B[0].transpose(1, 0, 2), C[0].transpose(1, 0, 2)
    pallas = pallas_ssd(jnp.asarray(xb), jnp.asarray(dtb), jnp.asarray(A),
                        jnp.asarray(Bb), jnp.asarray(Cb), chunk=Q,
                        interpret=True)
    np.testing.assert_allclose(y_bh, np.asarray(pallas), rtol=2e-4,
                               atol=2e-4)
    jax_oracle = jref.ssd_scan_ref(jnp.asarray(xb), jnp.asarray(dtb),
                                   jnp.asarray(A), jnp.asarray(Bb),
                                   jnp.asarray(Cb))
    np.testing.assert_allclose(y_bh, np.asarray(jax_oracle), rtol=2e-4,
                               atol=2e-4)
    torch_oracle = tref.ssd_scan_ref(_t(xb), _t(dtb), _t(A), _t(Bb), _t(Cb))
    np.testing.assert_allclose(torch_oracle.numpy(), np.asarray(jax_oracle),
                               rtol=2e-4, atol=2e-4)


def test_ops_ssd_bshn_matches_the_jax_wrapper():
    """Model layout with B/C groups shared by heads: the port reads group
    h // (nh / g) where the JAX wrapper repeats B/C to every head."""
    rng = np.random.default_rng(41)
    b, s, nh, P, g, N = 2, 64, 4, 16, 2, 8
    x, dt, A, B, C = _scan_inputs(rng, b, s, nh, P, g, N)
    y, _ = ops.ssd_bshn(_t(x), _t(dt), _t(A), _t(B), _t(C), chunk=32)
    exp = jax_ssd_bshn(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A),
                       jnp.asarray(B), jnp.asarray(C), chunk=32,
                       interpret=True)
    np.testing.assert_allclose(y.numpy(), np.asarray(exp), **TOL)
    with pytest.raises(ValueError, match="groups"):
        ops.ssd_bshn(_t(x), _t(dt), _t(A), _t(B[:, :, :1].repeat(3, 2)),
                     _t(C[:, :, :1].repeat(3, 2)))


def test_ssd_scan_takes_no_other_device():
    x = torch.zeros(1, 8, 2, 16, device="meta")
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        SSD.ssd_scan(x, x[..., 0], x[0, 0, :, 0], x[:, :, :1, :8],
                     x[:, :, :1, :8], 8)


# ---------------------------------------------------------------------------
# Mamba-2 block
# ---------------------------------------------------------------------------

def _mamba_cfgs(dtype="float32"):
    return (jax_reduced("zamba2-1.2b").replace(dtype=dtype),
            get_reduced_config("zamba2-1.2b").replace(dtype=dtype))


def _block_params(rng, cfg_j):
    """One Mamba-2 block's weights at JAX's init scales, with the
    per-head parameters drawn instead of left at zeros/ones."""
    defs = jssm.mamba2_defs(cfg_j)
    p = {}
    for k, d in defs.items():
        a = rng.standard_normal(d.shape).astype(np.float32)
        p[k] = a * d.scale / np.sqrt(d.shape[0]) if d.init == "normal" \
            else a * 0.3 + (1.0 if d.init == "ones" else 0.0)
    jp = {k: jnp.asarray(v).astype(jnp.dtype(defs[k].dtype))
          for k, v in p.items()}
    return jp, {k: tensor_from_numpy(np.asarray(v), "cpu")
                for k, v in jp.items()}


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(50)
    x = rng.standard_normal((2, 11, 24)).astype(np.float32)
    w = rng.standard_normal((4, 24)).astype(np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    out = tssm._causal_conv(_t(x), _t(w), _t(b))
    exp = jssm._causal_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


@pytest.mark.parametrize("s", [13, 37])
def test_mamba2_block_and_decode_steps_match_jax(s):
    """The full-sequence block with return_state, then 4 chained one-token
    steps from its state. fp32, rtol = atol = 2e-5 on the outputs; the
    states (|S| up to ~1e2 here) within 2e-5 of their max."""
    cfg_j, cfg_t = _mamba_cfgs()
    rng = np.random.default_rng(51 + s)
    jp, tp = _block_params(rng, cfg_j)
    x = rng.standard_normal((2, s, cfg_t.d_model)).astype(np.float32)
    jblock = jax.jit(functools.partial(jssm.mamba2_block_fwd, cfg_j,
                                       return_state=True))
    jstep = jax.jit(functools.partial(jssm.mamba2_decode_step, cfg_j))
    jo, (js, jc) = jblock(jp, jnp.asarray(x))
    with torch.no_grad():
        to, (ts, tc) = tssm.mamba2_block_fwd(cfg_t, tp, _t(x),
                                             return_state=True)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
    _close_to_max(ts.numpy(), js, 2e-5)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    ts, tc = ts.clone(), tc.clone()
    for step in range(4):
        xt = rng.standard_normal((2, 1, cfg_t.d_model)).astype(np.float32)
        jo, js, jc = jstep(jp, jnp.asarray(xt), js, jc)
        with torch.no_grad():
            to, ts2, tc2 = tssm.mamba2_decode_step(cfg_t, tp, _t(xt), ts, tc)
        assert ts2 is ts and tc2 is tc          # updated in place
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), **TOL)
        _close_to_max(ts.numpy(), js, 2e-5)
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)


def test_mamba2_block_hands_the_scan_the_kernels_layout(monkeypatch):
    """x, B and C reach the scan as column slices of one conv output with
    the channels contiguous, as the CUDA kernel's stride checks demand
    (kernels/_checks.py::check_rows); dt and A as its dtype checks do."""
    from repro_torch.kernels._checks import check_rows
    cfg_j, cfg_t = _mamba_cfgs("bfloat16")
    _, tp = _block_params(np.random.default_rng(61), cfg_j)
    seen = []

    def spy(x, dt, A, B, C, *, chunk, init_state):
        for name, t in (("x", x), ("B", B), ("C", C)):
            check_rows(name, t)
        assert B.data_ptr() == x.data_ptr() + x.shape[2] * x.shape[3] * 2
        assert dt.dtype == A.dtype == torch.float32
        seen.append(chunk)
        return SSD.ssd_scan_plain(x, dt, A, B, C, chunk, init_state)

    monkeypatch.setattr(ops, "ssd_bshn", spy)
    x = torch.randn(2, 37, cfg_t.d_model).to(torch.bfloat16)
    with torch.no_grad():
        tssm.mamba2_block_fwd(cfg_t, tp, x)
    assert seen == [cfg_t.ssm.chunk_size]


def test_mamba2_block_matches_jax_in_bf16():
    """bf16 weights and activations, where the JAX block rounds the scan's
    weights, state writes and exp(cum)·C to bf16 (ssm.py:111-134) and the
    plain version mirrors each rounding. Tolerance 2e-2 of max |out|
    (tests/test_kernels.py's bf16 tolerance): bf16 rounds in other places
    in the two frameworks' matmuls and conv."""
    cfg_j, cfg_t = _mamba_cfgs("bfloat16")
    rng = np.random.default_rng(60)
    jp, tp = _block_params(rng, cfg_j)
    x = rng.standard_normal((2, 37, cfg_t.d_model)).astype(np.float32)
    jo, (js, _) = jssm.mamba2_block_fwd(
        cfg_j, jp, jnp.asarray(x).astype(jnp.bfloat16), return_state=True)
    with torch.no_grad():
        to, (ts, _) = tssm.mamba2_block_fwd(
            cfg_t, tp, _t(x).to(torch.bfloat16), return_state=True)
    assert to.dtype == torch.bfloat16 and ts.dtype == torch.float32
    _close_to_max(to.float().numpy(), np.asarray(jo.astype(jnp.float32)),
                  2e-2)
    _close_to_max(ts.numpy(), js, 2e-2)


# ---------------------------------------------------------------------------
# reduced zamba2: prefill + decode against JAX
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def zamba2_jax():
    """JAX reduced zamba2 in fp32 at n_layers 4 (2 groups of 2 Mamba-2
    blocks + the shared block) and 5 (the same + 1 tail block): configs,
    weights and jitted prefill / decode."""
    out = {}
    for n_layers in (4, 5):
        cfg = jax_reduced("zamba2-1.2b").replace(n_layers=n_layers,
                                                 dtype="float32")
        params = JM.init_params(cfg, jax.random.PRNGKey(n_layers))
        out[n_layers] = (
            cfg, params,
            jax.jit(functools.partial(JM.prefill, cfg, max_len=64)),
            jax.jit(functools.partial(JM.decode_step, cfg)))
    return out


@pytest.mark.parametrize("n_layers", [4, 5])
@pytest.mark.parametrize("prompt", [13, 37])
def test_reduced_zamba2_prefill_and_decode_match_jax(zamba2_jax, n_layers,
                                                     prompt):
    """Prefill logits, 4 decode steps fed JAX's greedy tokens, and every
    cache entry after prefill and at the end. Tolerance: max |diff| <=
    2e-4 · max |ref| for the logits and each cache entry (pos exactly):
    the random weights drive dt to tens and the SSM states to ~1e4, and
    fp32 summation-order differences measured up to 7.5e-5 of the max
    through 5 layers."""
    cfg_j, jparams, jprefill, jdecode = zamba2_jax[n_layers]
    cfg_t = get_reduced_config("zamba2-1.2b").replace(n_layers=n_layers,
                                                      dtype="float32")
    tparams = params_from_jax(cfg_t, jax.tree.map(np.asarray, jparams),
                              "cpu")
    rng = np.random.default_rng(70 + prompt)
    tokens = rng.integers(0, cfg_t.vocab, (2, prompt)).astype(np.int32)

    def check_cache(tcache, jcache):
        assert set(tcache) == set(jcache)
        for key in jcache:
            if key == "pos":
                np.testing.assert_array_equal(tcache[key].numpy(),
                                              np.asarray(jcache[key]))
            else:
                _close_to_max(tcache[key].numpy(), jcache[key], 2e-4)

    jl, jcache = jprefill(jparams, jnp.asarray(tokens))
    with torch.no_grad():
        tl, tcache = TM.prefill(cfg_t, tparams, _t(tokens), max_len=64)
    _close_to_max(tl.numpy(), jl, 2e-4)
    check_cache(tcache, jcache)
    for _ in range(4):
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        jl, jcache = jdecode(jparams, jcache, jnp.asarray(nxt))
        with torch.no_grad():
            tl, tcache = TM.decode_step(cfg_t, tparams, tcache, _t(nxt))
        _close_to_max(tl.numpy(), jl, 2e-4)
    check_cache(tcache, jcache)
