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
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref

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
# flash decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,kvh,S,d", [
    (2, 4, 4, 256, 32),
    (2, 8, 2, 512, 64),
    (1, 4, 1, 128, 128),
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


def test_flash_decode_plain_needs_kv_len_at_least_one():
    q = torch.zeros(2, 1, 2, 16)
    kc = torch.zeros(2, 8, 2, 16)
    with pytest.raises(ValueError, match="kv_len"):
        FD.flash_decode(q, kc, kc, torch.tensor([3, 0], dtype=torch.int32))


# ---------------------------------------------------------------------------
# launch counts and the card
# ---------------------------------------------------------------------------

def test_cpu_tensors_never_count_a_launch():
    fa0, fd0 = FA.launches, FD.launches
    q = torch.zeros(1, 8, 2, 16)
    FA.flash_attention(q, q, q)
    FD.flash_decode(q[:, :1], q, q, torch.tensor([8], dtype=torch.int32))
    assert (FA.launches, FD.launches) == (fa0, fd0)
