"""The port's kernels against the JAX package's Pallas kernels.

On the CPU each kernel wrapper computes its plain PyTorch version; here that
plain version is held against the Pallas kernel in interpret mode (as
tests/test_kernels.py runs it), against the jnp oracles of
``repro.kernels.ref`` and against the port's own ``ref``. Inputs come from a
numpy seed and go to both frameworks as numpy. fp32 throughout, with the
tolerance of tests/test_kernels.py (rtol = atol = 2e-5): the two sides
differ only in summation order. The CUDA kernels themselves run only on a
card: tests/test_torch_gpu.py (marker ``gpu``) and chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention as pallas_fa
from repro.kernels.flash_decode import flash_decode as pallas_fd
from repro.models.attention import chunked_attention as jax_chunked
from repro.models.attention import group_query_heads as jax_group
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_attention_bwd as FB
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.kernels import ssm_state_step as S1
from repro_torch.kernels._checks import check_attention_sizes
from repro_torch.models import attention as tattn
from repro_torch.models import ssm as tssm

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _bh(x, b, heads):
    """Model layout (b, s, heads, d) -> the Pallas layout (b·heads, s, d)."""
    return x.transpose(0, 2, 1, 3).reshape(b * heads, x.shape[1], x.shape[3])


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,kvh,s,d", [
    (1, 4, 4, 128, 32),     # MHA
    (2, 8, 2, 128, 64),     # GQA 4:1
    (1, 8, 1, 256, 64),     # MQA
    (2, 4, 2, 64, 128),     # wide head
    (1, 4, 4, 128, 96),     # phi-3-vision's head dim
    (1, 40, 10, 128, 128),  # phi3-medium-14b's heads: GQA 4:1 of 40 at D 128
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_plain_matches_pallas(b, h, kvh, s, d, causal):
    rng = np.random.default_rng(3)
    q, k, v = (_randn(rng, b, s, n, d) for n in (h, kvh, kvh))
    out = FA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal)
    out_bh = _bh(out.numpy(), b, h)
    qb, kb, vb = _bh(q, b, h), _bh(k, b, kvh), _bh(v, b, kvh)
    pallas = pallas_fa(jnp.asarray(qb), jnp.asarray(kb), jnp.asarray(vb),
                       causal=causal, block_q=64, block_k=64, n_heads=h,
                       n_kv_heads=kvh, interpret=True)
    np.testing.assert_allclose(out_bh, np.asarray(pallas), **TOL)
    jax_oracle = jref.flash_attention_ref(
        jnp.asarray(qb), jnp.asarray(kb), jnp.asarray(vb), causal=causal,
        n_heads=h, n_kv_heads=kvh)
    np.testing.assert_allclose(out_bh, np.asarray(jax_oracle), **TOL)
    torch_oracle = tref.flash_attention_ref(
        torch.from_numpy(qb), torch.from_numpy(kb), torch.from_numpy(vb),
        causal=causal, n_heads=h, n_kv_heads=kvh)
    np.testing.assert_allclose(out_bh, torch_oracle.numpy(), **TOL)


@pytest.mark.parametrize("sq,skv,q_offset", [
    (100, 100, 0),          # ragged: no tile divides it
    (24, 64, 40),           # queries at the end of a longer history
    (5, 37, 0),             # q_offset 0 with Sq < Skv: top-left alignment
])
def test_flash_attention_plain_ragged_and_offset(sq, skv, q_offset):
    """Ragged lengths and q_offset, against the JAX chunked_attention (the
    Pallas kernel asserts divisible lengths and has no q_offset)."""
    rng = np.random.default_rng(5)
    b, h, kvh, d = 2, 4, 2, 16
    q = _randn(rng, b, sq, h, d)
    k, v = _randn(rng, b, skv, kvh, d), _randn(rng, b, skv, kvh, d)
    out = FA.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), q_offset=q_offset)
    exp = jax_chunked(jax_group(jnp.asarray(q), kvh), jnp.asarray(k),
                      jnp.asarray(v), causal=True, q_chunk=16, kv_chunk=16,
                      q_offset=q_offset)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(exp).reshape(b, sq, h, d), **TOL)


def test_ops_attention_bshd_matches_model_layout():
    from repro.kernels.ops import attention_bshd as jax_attention_bshd
    rng = np.random.default_rng(7)
    b, s, h, kvh, d = 2, 64, 4, 2, 32
    q = _randn(rng, b, s, h, d)
    k, v = _randn(rng, b, s, kvh, d), _randn(rng, b, s, kvh, d)
    out = ops.attention_bshd(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), n_heads=h, n_kv_heads=kvh)
    exp = jax_attention_bshd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             n_heads=h, n_kv_heads=kvh, block_q=32,
                             block_k=32, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)
    with pytest.raises(ValueError):
        ops.attention_bshd(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), n_heads=h, n_kv_heads=1)


# ---------------------------------------------------------------------------
# flash-attention backward
# ---------------------------------------------------------------------------

def _bwd_case(b, s, h, kvh, d, dtype, causal=True, seed=11):
    """q, k, v, the plain forward's o and L, and do, in ``dtype``."""
    gen = torch.Generator().manual_seed(seed)
    q, do = (torch.randn(b, s, h, d, generator=gen).to(dtype)
             for _ in range(2))
    k, v = (torch.randn(b, s, kvh, d, generator=gen).to(dtype)
            for _ in range(2))
    o, lse = FA.flash_attention_plain(q, k, v, causal=causal,
                                      return_lse=True)
    return q, k, v, o, lse, do


def _flash_bwd_model_layout(q, k, v, o, lse, do, causal, chunk):
    """``models.attention._flash_bwd`` (the CPU's backward, fp32) in the
    wrapper's layout."""
    b, s, h, d = q.shape
    g = k.shape[2]
    group = tattn.group_query_heads
    dq, dk, dv = tattn._flash_bwd(group(q, g), k, v, group(o, g),
                                  lse.view(b, g, h // g, s), group(do, g),
                                  causal, chunk, chunk)
    return dq.reshape(b, s, h, d), dk, dv


@pytest.mark.parametrize("dtype,tol", [
    # fp32: the roundings to the inputs' dtype are no-ops, so only the
    # order of the sums and where the scale is applied differ
    (torch.float32, 1e-5),
    # bf16: P and dS rounded to bf16 before their products (2^-9 each),
    # _flash_bwd keeps them in fp32; then bf16 outputs
    (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("h,kvh,causal", [(4, 4, True), (8, 2, True),
                                          (8, 2, False)])
def test_flash_attention_bwd_plain_matches_flash_bwd(dtype, tol, h, kvh,
                                                     causal):
    """The backward kernels' plain version against the CPU's blocked
    backward at GQA 1:1 and 4:1, a length no 64-row tile divides, causal
    and full: dq, dk, dv within ``tol`` of the blocked backward's largest
    magnitude."""
    args = _bwd_case(2, 100, h, kvh, 32, dtype, causal)
    got = FB.flash_attention_bwd_plain(*args, causal=causal)
    exp = _flash_bwd_model_layout(*args, causal=causal, chunk=48)
    for name, a, e in zip(("dq", "dk", "dv"), got, exp):
        assert a.dtype == dtype and a.shape == e.shape, name
        err = ((a.float() - e.float()).abs().max()
               / e.float().abs().max()).item()
        assert err <= tol, (name, err)


def test_flash_attention_bwd_on_the_cpu_is_the_plain_version():
    """For CPU tensors the wrapper computes the plain version and counts
    no launch."""
    args = _bwd_case(1, 40, 4, 2, 16, torch.float32)
    before = FB.launches
    got = FB.flash_attention_bwd(*args)
    exp = FB.flash_attention_bwd_plain(*args)
    assert FB.launches == before
    assert all(torch.equal(a, e) for a, e in zip(got, exp))


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("change,error,match", [
    ({"q": _meta(1, 64, 4, 64, dtype=torch.float32)}, TypeError,
     "takes bfloat16"),
    ({"do": _meta(1, 64, 4, 64, dtype=torch.float16)}, TypeError,
     "takes bfloat16"),
    ({"q": _meta(1, 64, 4, 48), "o": _meta(1, 64, 4, 48),
      "do": _meta(1, 64, 4, 48), "k": _meta(1, 64, 2, 48),
      "v": _meta(1, 64, 2, 48)}, ValueError, "head dim 48"),
    ({"k": _meta(1, 64, 3, 64), "v": _meta(1, 64, 3, 64)}, ValueError,
     "does not match"),
    ({"v": _meta(1, 32, 2, 64)}, ValueError, "expected q, o, do"),
    ({"o": _meta(1, 64, 4, 32)}, ValueError, "expected q, o, do"),
    ({"lse": _meta(1, 4, 64, dtype=torch.bfloat16)}, ValueError, "lse"),
    ({"lse": _meta(1, 64, 4, dtype=torch.float32)}, ValueError, "lse"),
    ({"lse": _meta(1, 64, 4, dtype=torch.float32).transpose(1, 2)},
     ValueError, "lse"),
    ({"q": _meta(1, 64, 4, 128)[..., ::2]}, ValueError, "contiguous head"),
    ({"k": _meta(1, 64, 2, 68)[..., :64]}, ValueError, "multiples of 8"),
    ({"lse": torch.empty(1, 4, 64)}, ValueError, "lse is on cpu"),
    ({}, ValueError, "runs on CUDA or the CPU"),
])
def test_flash_attention_bwd_refuses_what_the_kernels_do_not_take(
        change, error, match):
    """Off the CPU (meta tensors stand in for CUDA ones) the wrapper
    checks dtypes, shapes, head dims, L and strides before it looks for a
    card, and raises on each with its reason."""
    args = dict(q=_meta(1, 64, 4, 64), k=_meta(1, 64, 2, 64),
                v=_meta(1, 64, 2, 64), o=_meta(1, 64, 4, 64),
                lse=_meta(1, 4, 64, dtype=torch.float32),
                do=_meta(1, 64, 4, 64))
    args.update(change)
    with pytest.raises(error, match=match):
        FB.flash_attention_bwd(**args)


def test_flash_attention_bwd_kernel_names_escape_the_benchmarks_patterns():
    """Every ``__global__`` of the backward's source, as the profiler
    names it, matches none of the benchmark's kernel patterns (K1's launch
    count in ``k1_roofline.train`` reads them)."""
    import re
    from pathlib import Path

    from gpubench.cost import kernel_of
    src = (Path(FB.__file__).with_name("csrc")
           / "flash_attention_bwd.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?(\w+)", src)
    assert sorted(names) == ["flash_attention_bwd_dkdv_kernel",
                             "flash_attention_bwd_dq_kernel"]
    for name in names:
        for shown in (name, f"void (anonymous namespace)::{name}<64>("
                            f"__nv_bfloat16 const*, float*, int)"):
            assert kernel_of(shown) is None, shown


def test_flash_attention_fn_backward_routes_cuda_tensors_to_the_kernels(
        monkeypatch):
    """On a CUDA tensor (a stand-in for ``is_cuda`` here)
    ``FlashAttentionFn``'s backward hands the model layout to the
    backward kernels' wrapper (ungrouped heads, L as (b, h, s), a
    contiguous do) and never calls ``_flash_bwd``; fed the plain version
    there, its gradients are the CPU backward's."""
    seen = []

    def fake_bwd(q, k, v, o, lse, do, *, causal):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(lse.shape),
                     do.is_contiguous(), causal))
        return FB.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                            causal=causal)

    def refuse(*args, **kwargs):
        raise AssertionError("_flash_bwd called for a CUDA tensor")

    gen = torch.Generator().manual_seed(5)
    b, s, g, m, d = 2, 24, 2, 3, 16
    q = torch.randn(b, s, g, m, d, generator=gen)
    k, v = (torch.randn(b, s, g, d, generator=gen) for _ in range(2))
    qe, ke, ve = (t.clone().requires_grad_() for t in (q, k, v))
    exp = torch.autograd.grad(
        tattn.FlashAttentionFn.apply(qe, ke, ve, True, 8, 8).sum(),
        (qe, ke, ve))
    monkeypatch.setattr(tattn, "flash_attention_bwd", fake_bwd)
    monkeypatch.setattr(tattn, "_flash_bwd", refuse)
    qc, kc, vc = (t.clone().requires_grad_() for t in (q, k, v))
    o = tattn.FlashAttentionFn.apply(qc, kc, vc, True, 8, 8)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    got = torch.autograd.grad(o.sum(), (qc, kc, vc))
    monkeypatch.undo()
    assert seen == [((b, s, g * m, d), (b, s, g, d), (b, g * m, s), True,
                     True)]
    for a, e in zip(got, exp):
        assert a.shape == e.shape
        torch.testing.assert_close(a, e, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# flash decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,kvh,S,d", [
    (2, 4, 4, 256, 32),
    (2, 8, 2, 512, 64),
    (1, 4, 1, 128, 128),
    (2, 4, 4, 256, 96),     # phi-3-vision's head dim
    (2, 16, 2, 256, 128),   # yi-6b's GQA 8:1
])
def test_flash_decode_plain_matches_pallas(b, h, kvh, S, d):
    rng = np.random.default_rng(11)
    q = _randn(rng, b, 1, h, d)
    kc, vc = _randn(rng, b, S, kvh, d), _randn(rng, b, S, kvh, d)
    kv_len = rng.integers(1, S + 1, b).astype(np.int32)
    out = FD.flash_decode(torch.from_numpy(q), torch.from_numpy(kc),
                          torch.from_numpy(vc), torch.from_numpy(kv_len))
    out_bh = out.numpy().reshape(b * h, d)
    qb, kb, vb = q.reshape(b * h, d), _bh(kc, b, kvh), _bh(vc, b, kvh)
    pallas = pallas_fd(jnp.asarray(qb), jnp.asarray(kb), jnp.asarray(vb),
                       jnp.asarray(kv_len), block_k=64, n_heads=h,
                       n_kv_heads=kvh, interpret=True)
    np.testing.assert_allclose(out_bh, np.asarray(pallas), **TOL)
    jax_oracle = jref.flash_decode_ref(
        jnp.asarray(qb), jnp.asarray(kb), jnp.asarray(vb),
        jnp.asarray(kv_len), n_heads=h, n_kv_heads=kvh)
    np.testing.assert_allclose(out_bh, np.asarray(jax_oracle), **TOL)
    torch_oracle = tref.flash_decode_ref(
        torch.from_numpy(qb), torch.from_numpy(kb), torch.from_numpy(vb),
        torch.from_numpy(kv_len), n_heads=h, n_kv_heads=kvh)
    np.testing.assert_allclose(out_bh, torch_oracle.numpy(), **TOL)


def test_flash_decode_reads_a_strided_cache_slice():
    """A layer's slice of the stacked (layers, b, S, kvh, d) cache goes in
    as it is (strided) and gives what a contiguous copy gives."""
    rng = np.random.default_rng(13)
    L, b, S, h, kvh, d = 3, 2, 64, 4, 2, 16
    cache = torch.from_numpy(_randn(rng, L, b, S, kvh, d))
    q = torch.from_numpy(_randn(rng, b, 1, h, d))
    kv_len = torch.tensor([5, 64], dtype=torch.int32)
    out = ops.decode_attention_bshd(q, cache[1], cache[2], kv_len,
                                    n_heads=h, n_kv_heads=kvh)
    exp = FD.flash_decode(q, cache[1].contiguous(), cache[2].contiguous(),
                          kv_len)
    np.testing.assert_array_equal(out.numpy(), exp.numpy())


@pytest.mark.parametrize("n_split", [1, 3, 8])
@pytest.mark.parametrize("lens", ["one", "boundary", "full"])
def test_flash_decode_split_plain_matches_plain(n_split, lens):
    """The split-and-merge form the kernel computes against the one-pass
    plain version: kv_len = 1 (every split but the first empty), kv_len on
    a split boundary (3 splits of 32 rows), kv_len = S, and a mixed batch
    with a ragged last tile; GQA 4:1 at head dim 96. fp32, TOL (only the
    summation order differs)."""
    rng = np.random.default_rng(17)
    b, S, h, kvh, d = 3, 96, 8, 2, 96
    q = torch.from_numpy(_randn(rng, b, 1, h, d))
    kc, vc = (torch.from_numpy(_randn(rng, b, S, kvh, d)) for _ in range(2))
    kv_len = torch.tensor({"one": [1, 1, 1], "boundary": [32, 64, 37],
                           "full": [S, S, 50]}[lens], dtype=torch.int32)
    out = FD.flash_decode_split_plain(q, kc, vc, kv_len, n_split)
    np.testing.assert_allclose(
        out.numpy(), FD.flash_decode_plain(q, kc, vc, kv_len).numpy(), **TOL)


@pytest.mark.parametrize("b,kvh,S", [
    (8, 32, 1024),    # the serving decode (stablelm, phi-3-vision)
    (8, 4, 1024),     # yi-6b
    (1, 32, 1024),    # batch 1
    (1, 4, 1024),     # batch 1, GQA 8:1
    (1, 1, 100),      # a short cache: one split
    (64, 32, 4096),   # already more blocks than two per SM
])
def test_split_count_keeps_a_tile_per_split(b, kvh, S):
    """At least MIN_SPLIT_ROWS rows of the padded cache (whole 16-row
    tiles) per split, never more than MAX_SPLIT, and more than b*kvh
    blocks whenever b*kvh blocks leave the 132 SMs of an H100 short of
    two each and the cache has room for two splits."""
    n = FD.split_count(b, kvh, S, 132)
    assert 1 <= n <= FD.MAX_SPLIT
    assert FD.MIN_SPLIT_ROWS % FD.TILE_ROWS == 0
    assert n == 1 or S // n >= FD.MIN_SPLIT_ROWS
    if b * kvh < 132 and S >= 2 * FD.MIN_SPLIT_ROWS:
        assert n > 1
    if b * kvh >= 2 * 132:
        assert n == 1


def test_flash_decode_plain_needs_kv_len_at_least_one():
    q = torch.zeros(2, 1, 2, 16)
    kc = torch.zeros(2, 8, 2, 16)
    with pytest.raises(ValueError, match="kv_len"):
        FD.flash_decode(q, kc, kc, torch.tensor([3, 0], dtype=torch.int32))


@pytest.mark.parametrize("b,sq,skv,h,q_offset,ok", [
    (8, 512, 512, 32, 0, True),             # the serving prefill
    (1, 1, 64, 4, 63, True),                # one query continuing a cache
    (2 ** 16, 1, 1, 2 ** 15 - 1, 0, True),  # b*h just under 2^31
    (2 ** 16, 1, 1, 2 ** 15, 0, False),     # b*h = 2^31 blocks
    (1, 65535 * 64, 1, 1, 0, True),         # the most q tiles of 64 rows
    (1, 65535 * 64 + 1, 1, 1, 0, False),
    (1, 0, 8, 1, 0, False), (1, 8, 0, 1, 0, False), (1, 8, 8, 1, -1, False),
])
def test_flash_attention_grid_limits(b, sq, skv, h, q_offset, ok):
    """The wrapper's size check admits exactly what the kernels' grid
    (b*h, q tiles) can launch; it needs no device."""
    if ok:
        check_attention_sizes(b, sq, skv, h, q_offset)
    else:
        with pytest.raises(ValueError, match="unsupported sizes"):
            check_attention_sizes(b, sq, skv, h, q_offset)


# ---------------------------------------------------------------------------
# the Mamba-2 decode state step (S1)
# ---------------------------------------------------------------------------

def _state_step_inputs(b, nh, P, N, g, seed=17):
    """A step's inputs as the model makes them: x, B and C column slices
    of one bf16 conv output, dt after the softplus."""
    gen = torch.Generator().manual_seed(seed)
    conv = torch.randn(b, nh * P + 2 * g * N, generator=gen) \
        .to(torch.bfloat16)
    x = conv[:, :nh * P].unflatten(-1, (nh, P))
    B = conv[:, nh * P:nh * P + g * N].unflatten(-1, (g, N))
    C = conv[:, nh * P + g * N:].unflatten(-1, (g, N))
    dt = torch.nn.functional.softplus(torch.randn(b, nh, generator=gen))
    A_log = torch.randn(nh, generator=gen) * 0.5
    D = torch.randn(nh, generator=gen)
    state = torch.randn(b, nh, P, N, generator=gen)
    return state, x, dt, A_log, B, C, D


def _ssm_recurrence(state, xf, dt, A_log, Bh, Ch, D):
    """The eager chain ``mamba2_decode_step`` ran before the kernel, as it
    stood in ``models.ssm``: ``state`` updated in place, the read-out y."""
    dA = torch.exp(dt * -torch.exp(A_log))
    state.mul_(dA[..., None, None]).add_(
        (xf * dt[..., None])[..., :, None] * Bh[:, :, None, :])
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return y + D[:, None] * xf


@pytest.mark.parametrize("P,N", [(64, 64), (64, 128)])
@pytest.mark.parametrize("g", [1, 2])
def test_ssm_state_step_plain_matches_ssm_recurrence(P, N, g):
    """The kernel's plain version, on x, B and C as the conv output's bf16
    views, is the eager chain it replaced on their fp32 copies with B and
    C repeated to every head, bit for bit: state and read-out. On CPU
    tensors the wrapper computes it and counts no launch."""
    state, x, dt, A_log, B, C, D = _state_step_inputs(3, 4, P, N, g)
    rep = 4 // g
    want_state = state.clone()
    want = _ssm_recurrence(
        want_state, x.float(), dt, A_log,
        B.float().repeat_interleave(rep, dim=1),
        C.float().repeat_interleave(rep, dim=1), D)
    got_state = state.clone()
    got = S1.ssm_state_step_plain(got_state, x, dt, A_log, B, C, D)
    assert torch.equal(got, want) and torch.equal(got_state, want_state)
    assert not torch.equal(got_state, state)
    before = S1.launches
    again_state = state.clone()
    again = ops.ssm_step_bhpn(again_state, x, dt, A_log, B, C, D)
    assert S1.launches == before
    assert torch.equal(again, want) and torch.equal(again_state, want_state)


def test_mamba2_decode_step_routes_cuda_tensors_to_the_kernel(monkeypatch):
    """On every device the decode step hands the state step
    (``ops.ssm_step_bhpn``, which launches the kernel for CUDA tensors)
    the conv output's bf16 views (x (b, nh, P), B and C (b, g, N), not
    repeated, each row contiguous) and the cache's state itself, and
    takes its read-out as the step's: the output, state and conv window
    of the unpatched step."""
    from repro_torch.configs.registry import get_reduced_config
    from repro_torch.models import model as TM
    from repro_torch.models import transformer as tfm
    from repro_torch.models.granite_hybrid import layout
    cfg = get_reduced_config("granite-4.0-h-micro")
    params = TM.init_params(cfg, torch.Generator().manual_seed(3),
                            torch.device("cpu"))
    kind, i = next((k, i) for k, i in layout(cfg) if k == "mamba")
    p = tfm.layer_params(params[kind], i)["mixer"]
    di, nh, conv_dim = tssm.mamba2_dims(cfg)
    s = cfg.ssm
    gen = torch.Generator().manual_seed(4)
    x = torch.randn(2, 1, cfg.d_model, generator=gen).to(torch.bfloat16)
    state = torch.randn(2, nh, s.head_dim, s.d_state, generator=gen)
    conv = torch.randn(2, s.d_conv - 1, conv_dim, generator=gen) \
        .to(torch.bfloat16)
    want_state, want_conv = state.clone(), conv.clone()
    want, _, _ = tssm.mamba2_decode_step(cfg, p, x, want_state, want_conv)
    seen = []

    def fake_step(st, xh, dt, A_log, B, C, D):
        seen.append((st.data_ptr(), xh.dtype, tuple(xh.shape),
                     tuple(B.shape), tuple(C.shape), xh.is_contiguous(),
                     (xh.stride(-1), B.stride(-1), C.stride(-1))))
        return S1.ssm_state_step_plain(st, xh, dt, A_log, B, C, D)

    monkeypatch.setattr(tssm.ops, "ssm_step_bhpn", fake_step)
    got_state, got_conv = state.clone(), conv.clone()
    got, st, cb = tssm.mamba2_decode_step(cfg, p, x, got_state, got_conv)
    monkeypatch.undo()
    assert seen == [(got_state.data_ptr(), torch.bfloat16,
                     (2, nh, s.head_dim), (2, s.n_groups, s.d_state),
                     (2, s.n_groups, s.d_state), False, (1, 1, 1))]
    assert st is got_state and cb is got_conv
    assert torch.equal(got, want) and torch.equal(got_state, want_state) \
        and torch.equal(got_conv, want_conv)


def _meta32(*shape):
    return torch.empty(*shape, dtype=torch.float32, device="meta")


@pytest.mark.parametrize("change,error,match", [
    ({"state": _meta32(2, 4, 64, 32), "B": _meta(2, 1, 32),
      "C": _meta(2, 1, 32)}, ValueError, r"\(P, N\) = \(64, 32\)"),
    ({"state": _meta32(2, 4, 32, 128), "x": _meta(2, 4, 32)}, ValueError,
     r"\(P, N\) = \(32, 128\)"),
    ({"x": _meta32(2, 4, 64)}, TypeError, "takes bfloat16"),
    ({"B": _meta(2, 1, 128, dtype=torch.float16)}, TypeError,
     "takes bfloat16"),
    ({"state": _meta(2, 4, 64, 128)}, ValueError, "state: needs float32"),
    ({"state": _meta32(2, 4, 128, 64).transpose(2, 3)}, ValueError,
     "contiguous \\(P, N\\) tile"),
    ({"state": _meta32(2, 6, 64, 128)}, ValueError, "does not match"),
    ({"state": _meta32(2, 4, 64, 128).as_strided((2, 4, 64, 128),
                                                 (32770, 8192, 128, 1))},
     ValueError, "multiples of 4"),
    ({"state": _meta32(2, 4, 64, 130)[..., :128]}, ValueError,
     "contiguous \\(P, N\\) tile"),
    ({"x": _meta(2, 4, 128)[..., ::2]}, ValueError, "contiguous head"),
    ({"B": _meta(2, 1, 132)[..., :128]}, ValueError, "multiples of 8"),
    ({"B": _meta(2, 3, 128), "C": _meta(2, 3, 128)}, ValueError,
     "does not match"),
    ({"C": _meta(2, 1, 64)}, ValueError, "expected state"),
    ({"dt": _meta32(2, 4, 1)}, ValueError, "dt must be"),
    ({"dt": _meta(2, 4)}, ValueError, "dt must be"),
    ({"A_log": _meta32(8)}, ValueError, "A_log must be"),
    ({"D": _meta32(4, 2)[:, 0]}, ValueError, "contiguous"),
    ({"dt": torch.empty(2, 4)}, ValueError, "dt must be"),
    ({}, ValueError, "runs on CUDA or the CPU"),
])
def test_ssm_state_step_refuses_what_the_kernel_does_not_take(
        change, error, match):
    """Off the CPU (meta tensors stand in for CUDA ones) the wrapper
    checks (P, N), dtypes, shapes and strides before it looks for a card,
    and raises on each with its reason: nothing falls back."""
    args = dict(state=_meta32(2, 4, 64, 128), x=_meta(2, 4, 64),
                dt=_meta32(2, 4), A_log=_meta32(4), B=_meta(2, 1, 128),
                C=_meta(2, 1, 128), D=_meta32(4))
    args.update(change)
    with pytest.raises(error, match=match):
        S1.ssm_state_step(**args)


def test_ssm_state_step_kernel_name_escapes_the_benchmarks_patterns():
    """The kernel's ``__global__``, as the profiler names it, matches none
    of the benchmark's kernel patterns (the K1, K2 and K3 rooflines count
    launches by them)."""
    import re
    from pathlib import Path

    from gpubench.cost import kernel_of
    src = (Path(S1.__file__).with_name("csrc")
           / "ssm_state_step.cu").read_text()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                       r"\s+)?(\w+)", src)
    assert names == ["ssm_state_step_kernel"]
    for shown in (names[0], f"void (anonymous namespace)::{names[0]}<64, "
                            f"128>(float*, __nv_bfloat16 const*, float "
                            f"const*, float const*, __nv_bfloat16 const*, "
                            f"__nv_bfloat16 const*, float const*, float*, "
                            f"long long, int, int)"):
        assert kernel_of(shown) is None, shown


# ---------------------------------------------------------------------------
# launch counts and the card
# ---------------------------------------------------------------------------

def test_cpu_tensors_never_count_a_launch():
    fa0, fd0, ssd0, s10 = FA.launches, FD.launches, SSD.launches, \
        S1.launches
    q = torch.zeros(1, 8, 2, 16)
    FA.flash_attention(q, q, q)
    FD.flash_decode(q[:, :1], q, q, torch.tensor([8], dtype=torch.int32))
    SSD.ssd_scan(q, q[..., 0], -torch.ones(2), q[:, :, :1, :8],
                 q[:, :, :1, :8], 8)
    S1.ssm_state_step(torch.zeros(1, 2, 16, 8), q[:, 0], q[:, 0, :, 0],
                      torch.zeros(2), q[:, :1, 0, :8], q[:, :1, 0, :8],
                      torch.ones(2))
    assert (FA.launches, FD.launches, SSD.launches, S1.launches) \
        == (fa0, fd0, ssd0, s10)
