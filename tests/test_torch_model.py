"""The port's model path against the JAX package's, on the CPU.

Layers, the eager attention, and a reduced stablelm-1.6b (LayerNorm,
partial interleaved RoPE, GQA 2:1) in fp32 with 2 layers whose weights come
from the JAX package through ``repro_torch.bridge``: prefill logits plus 4
greedy decode steps. Inputs come from a numpy seed and go to both
frameworks as numpy. fp32, rtol = atol = 2e-5 (tests/test_kernels.py's
fp32 tolerance) unless a test says otherwise.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced_config as jax_reduced
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as JM
from repro_torch.bridge import params_from_jax, tensor_from_numpy
from repro_torch.configs.registry import get_config, get_reduced_config
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import model as TM

TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_norms_match_jax():
    rng = np.random.default_rng(0)
    x = _randn(rng, 3, 5, 64) * 3 + 1
    w, b = _randn(rng, 64), _randn(rng, 64)
    np.testing.assert_allclose(
        tlayers.layernorm(_t(x), _t(w), _t(b)).numpy(),
        np.asarray(jlayers.layernorm(jnp.asarray(x), jnp.asarray(w),
                                     jnp.asarray(b))), **TOL)
    np.testing.assert_allclose(
        tlayers.rmsnorm(_t(x), _t(w)).numpy(),
        np.asarray(jlayers.rmsnorm(jnp.asarray(x), jnp.asarray(w))), **TOL)


@pytest.mark.parametrize("fraction", [0.25, 1.0])
def test_partial_interleaved_rope_matches_jax(fraction):
    rng = np.random.default_rng(1)
    x = _randn(rng, 2, 7, 4, 64)
    pos = np.array([[3, 4, 5, 6, 7, 8, 9], [0, 1, 2, 3, 4, 5, 6]], np.int32)
    inv_t, rot = tlayers.rope_freqs(64, fraction, 10_000.0)
    inv_j, rot_j = jlayers.rope_freqs(64, fraction, 10_000.0)
    assert rot == rot_j == (16 if fraction == 0.25 else 64)
    np.testing.assert_array_equal(inv_t.numpy(), np.asarray(inv_j))
    out = tlayers.apply_rope(_t(x), _t(pos), inv_t, rot).numpy()
    exp = np.asarray(jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                        inv_j, rot_j))
    np.testing.assert_allclose(out, exp, **TOL)
    # only the first `rot` dims move
    np.testing.assert_array_equal(out[..., rot:], x[..., rot:])


@pytest.mark.parametrize("act,gated", [("silu", True), ("gelu", False)])
def test_mlp_matches_jax(act, gated):
    rng = np.random.default_rng(2)
    x = _randn(rng, 2, 5, 32)
    p = {"wi": _randn(rng, 32, 48) / 6, "wo": _randn(rng, 48, 32) / 7}
    if gated:
        p["wg"] = _randn(rng, 32, 48) / 6
    out = tlayers.mlp_fwd({k: _t(v) for k, v in p.items()}, _t(x), act, gated)
    exp = jlayers.mlp_fwd({k: jnp.asarray(v) for k, v in p.items()},
                          jnp.asarray(x), act, gated)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


# ---------------------------------------------------------------------------
# attention (eager CPU path)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sq,skv,q_offset,with_len,block_skip", [
    (32, 32, 0, False, False),
    (37, 37, 0, False, True),       # ragged, triangular schedule
    (8, 40, 32, False, False),      # decode-with-history offset
    (20, 48, 0, True, False),       # per-row kv_len mask
])
def test_chunked_attention_matches_jax(sq, skv, q_offset, with_len,
                                       block_skip):
    rng = np.random.default_rng(3)
    b, g, m, hd = 2, 2, 2, 16
    q = _randn(rng, b, sq, g, m, hd)
    k, v = _randn(rng, b, skv, g, hd), _randn(rng, b, skv, g, hd)
    kv_len = np.array([skv, skv - 9], np.int32) if with_len else None
    kw = dict(causal=True, q_chunk=16, kv_chunk=16, q_offset=q_offset,
              block_skip=block_skip)
    out = tattn.chunked_attention(
        _t(q), _t(k), _t(v),
        kv_len=None if kv_len is None else _t(kv_len), **kw)
    exp = jattn.chunked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        kv_len=None if kv_len is None else jnp.asarray(kv_len), **kw)
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)
    ref = tattn.reference_attention(
        _t(q), _t(k), _t(v), kv_len=None if kv_len is None else _t(kv_len),
        q_offset=q_offset)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), **TOL)


def test_decode_attention_matches_jax():
    rng = np.random.default_rng(4)
    b, S, g, m, hd = 3, 40, 2, 2, 16
    q = _randn(rng, b, 1, g, m, hd)
    kc, vc = _randn(rng, b, S, g, hd), _randn(rng, b, S, g, hd)
    kv_len = np.array([1, 17, 40], np.int32)
    out = tattn.decode_attention(_t(q), _t(kc), _t(vc), _t(kv_len))
    exp = jattn.decode_attention(jnp.asarray(q), jnp.asarray(kc),
                                 jnp.asarray(vc), jnp.asarray(kv_len))
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


# ---------------------------------------------------------------------------
# parameters, bridge, families
# ---------------------------------------------------------------------------

def test_init_params_follows_the_jax_param_defs():
    cfg = get_reduced_config("stablelm-1.6b")
    params = TM.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    abstract = JM.abstract_params(jax_reduced("stablelm-1.6b"))
    flat_t = dict(_flatten(params))
    flat_j = dict(_flatten(abstract))
    assert flat_t.keys() == flat_j.keys()
    for key, t in flat_t.items():
        assert tuple(t.shape) == tuple(flat_j[key].shape), key
        assert str(t.dtype).split(".")[-1] == str(flat_j[key].dtype), key
    blocks = params["blocks"]
    assert bool((blocks["attn_norm"]["scale"] == 1).all())
    assert bool((blocks["attn_norm"]["bias"] == 0).all())
    # normal with stddev scale / sqrt(fan_in), fan_in being the leading
    # dim: for stacked block weights that is the layer count, as in the
    # JAX package's init_from_defs
    wi = blocks["mlp"]["wi"].float()
    assert abs(wi.std().item() - 1 / np.sqrt(wi.shape[0])) < 0.02


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_bridge_carries_bf16_bits_without_ml_dtypes():
    x = jnp.asarray(np.linspace(-3, 3, 24, dtype=np.float32)
                    .reshape(4, 6)).astype(jnp.bfloat16)
    t = tensor_from_numpy(np.asarray(x), "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-350m",
                                  "granite-moe-1b-a400m"])
def test_unported_families_name_their_roadmap_item(arch):
    cfg = get_config(arch)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        TM.param_defs(cfg)


# ---------------------------------------------------------------------------
# the whole reduced model: prefill + decode against JAX
# ---------------------------------------------------------------------------

def _prefill_decode_parity(arch, tol):
    """Reduced ``arch`` in fp32 with 2 layers and JAX's weights: prefill
    logits, then 4 decode steps fed the same (JAX's greedy) tokens, and the
    cache at the end. Configs with a modality prefix get the same random
    prefix embeddings on both sides."""
    cfg_j = jax_reduced(arch).replace(n_layers=2, dtype="float32")
    cfg_t = get_reduced_config(arch).replace(n_layers=2, dtype="float32")
    jparams = JM.init_params(cfg_j, jax.random.PRNGKey(0))
    tparams = params_from_jax(cfg_t, jax.tree.map(np.asarray, jparams),
                              "cpu")
    rng = np.random.default_rng(5)
    b, s, max_len, steps = 3, 13, 32, 4
    tokens = rng.integers(0, cfg_t.vocab, (b, s)).astype(np.int32)
    prefix = None
    if cfg_t.prefix_len:
        prefix = _randn(rng, b, cfg_t.prefix_len, cfg_t.d_model) * 0.02

    jl, jcache = JM.prefill(cfg_j, jparams, jnp.asarray(tokens),
                            None if prefix is None else jnp.asarray(prefix),
                            max_len=max_len)
    with torch.no_grad():
        tl, tcache = TM.prefill(cfg_t, tparams, _t(tokens),
                                None if prefix is None else _t(prefix),
                                max_len=max_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    for _ in range(steps):
        nxt = np.asarray(jnp.argmax(jl[:, -1], -1))[:, None].astype(np.int32)
        jl, jcache = JM.decode_step(cfg_j, jparams, jcache, jnp.asarray(nxt))
        with torch.no_grad():
            tl, tcache = TM.decode_step(cfg_t, tparams, tcache, _t(nxt))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **tol)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    # the cache holds raw K projections (|k| up to ~13 here), where fp32
    # summation-order differences reach ~1e-4 absolute
    np.testing.assert_allclose(tcache["k"].numpy(), np.asarray(jcache["k"]),
                               rtol=1e-4, atol=1e-4)


def test_reduced_stablelm_prefill_and_decode_match_jax():
    """LayerNorm, partial interleaved RoPE (a quarter of head_dim), GQA 2:1."""
    _prefill_decode_parity("stablelm-1.6b", TOL)


@pytest.mark.parametrize("arch", [
    "yi-6b",                # RMSNorm, full RoPE
    "musicgen-large",       # plain GELU MLP, learned positions, prefix
    "phi-3-vision-4.2b",    # patch-embedding prefix
])
def test_reduced_attention_families_prefill_and_decode_match_jax(arch):
    """Tolerance 1e-4: the random weights make activations large (|k| up
    to ~20) and attention sharp, and on these inputs fp32 summation-order
    differences reach 5.5e-5 on logits of magnitude ~3 (measured; no trend
    from step to step)."""
    _prefill_decode_parity(arch, dict(rtol=1e-4, atol=1e-4))
