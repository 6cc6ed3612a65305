"""The port's training path against the JAX package's, on the CPU.

``FlashAttentionFn`` (o, L, dq, dk, dv) against ``jax.vjp`` through both of
the JAX package's training routes (``flash_attention_jax`` and autodiff of
``chunked_attention``); the two losses, value and gradient; the optimizer;
the training forward, one ``grad_step`` and one ``HeteroTrainer.train_step``
on reduced fp32 models (2 layers, seq 32) whose weights come from the JAX
package through ``repro_torch.bridge``; checkpoints across the packages;
the launcher; and the guard that keeps a CUDA kernel out of a graph it
would cut (ROADMAP C5). Inputs come from numpy seeds. Tolerances are fp32
ones, stated per test: TOL (rtol = atol = 2e-5, tests/test_kernels.py's
fp32 tolerance) unless a test says otherwise.
"""
import contextlib
import importlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JaxCheckpointer
from repro.configs.registry import get_reduced_config as jax_reduced
from repro.core.types import DeviceKind as JDeviceKind
from repro.models import attention as jattn
from repro.models import model as JM
from repro.train import loss as jloss
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.bridge import params_from_jax
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.registry import get_reduced_config
from repro_torch.core.types import DeviceKind
from repro_torch.data.pipeline import for_model
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import flash_decode as FD
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.launch import train as train_launcher
from repro_torch.models import attention as tattn
from repro_torch.models import model as TM
from repro_torch.train import loss as tloss
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import GroupDef, HeteroTrainer

# the packages' __init__ export the function train_step under the module's
# name, so the modules come from sys.modules
jstep = importlib.import_module("repro.train.train_step")
tstep = importlib.import_module("repro_torch.train.train_step")

TOL = dict(rtol=2e-5, atol=2e-5)
SEQ = 32


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


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    """{'/'-joined path: leaf} of a nested dict."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _model(arch):
    """(torch config, JAX config, JAX params as numpy, torch params) of the
    reduced fp32 ``arch``, the same weights in both."""
    jcfg = jax_reduced(arch).replace(dtype="float32")
    tcfg = get_reduced_config(arch).replace(dtype="float32")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return tcfg, jcfg, jparams, params_from_jax(tcfg, _np_tree(jparams),
                                                "cpu")


def _batch(cfg, n=4, seed=3):
    """A batch from the data pipeline (its last row padded away by the
    loss mask), as numpy."""
    batch = for_model(cfg, SEQ - cfg.prefix_len, seed).batch(0, n - 1,
                                                             pad_to=n)
    return batch


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# FlashAttentionFn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("route,g,m,seq", [
    ("flash_attention_jax", 4, 1, 32), ("flash_attention_jax", 2, 4, 32),
    ("chunked_attention", 4, 1, 32), ("chunked_attention", 2, 4, 32),
    ("chunked_attention", 2, 4, 40)])
def test_flash_attention_fn_matches_both_jax_routes(route, g, m, seq):
    """o, L, dq, dk, dv at GQA 1:1 and 4:1, causal, 16-row chunks; the
    40-row case ends in a short last block (the JAX custom VJP asserts
    whole chunks, so only chunked_attention takes it). TOL."""
    rng = np.random.default_rng(g * 10 + m + seq)
    b, hd = 2, 16
    q, do = _randn(rng, b, seq, g, m, hd), _randn(rng, b, seq, g, m, hd)
    k, v = _randn(rng, b, seq, g, hd), _randn(rng, b, seq, g, hd)
    if route == "flash_attention_jax":
        fn = lambda q, k, v: jattn.flash_attention_jax(q, k, v, True, 16, 16)
    else:
        fn = lambda q, k, v: jattn.chunked_attention(
            q, k, v, causal=True, q_chunk=16, kv_chunk=16)
    o_j, vjp = jax.vjp(fn, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    grads_j = vjp(jnp.asarray(do))
    tq, tk, tv = (_t(x).requires_grad_() for x in (q, k, v))
    o_t = tattn.FlashAttentionFn.apply(tq, tk, tv, True, 16, 16)
    grads_t = torch.autograd.grad(o_t, (tq, tk, tv), _t(do))
    np.testing.assert_allclose(o_t.detach().numpy(), np.asarray(o_j), **TOL)
    for name, got, exp in zip(("dq", "dk", "dv"), grads_t, grads_j):
        np.testing.assert_allclose(got.numpy(), np.asarray(exp), **TOL,
                                   err_msg=name)
    # L, as the forward computes it: the JAX package's (nq, b, g, m, qc)
    # statistics, as (b, g, m, sq)
    if seq % 16 == 0:
        _, L_j = jattn._flash_fwd_stats(jnp.asarray(q), jnp.asarray(k),
                                        jnp.asarray(v), True, 16, 16)
        L_j = np.moveaxis(np.asarray(L_j), 0, 3).reshape(b, g, m, seq)
        _, L_t = ops.attention_bshd(_t(q).reshape(b, seq, g * m, hd), _t(k),
                                    _t(v), n_heads=g * m, n_kv_heads=g,
                                    causal=True, return_lse=True)
        np.testing.assert_allclose(L_t.reshape(b, g, m, seq).numpy(), L_j,
                                   **TOL)


def test_kernel_plain_lse_is_the_rows_log_sum_exp():
    """The flash-attention kernel's plain version gives the same o and L,
    in its (b, h, sq) layout, as the JAX package's ``_flash_fwd_stats``
    (8-row chunks). TOL."""
    rng = np.random.default_rng(7)
    b, s, g, m, hd = 2, 24, 2, 2, 16
    q, k, v = _randn(rng, b, s, g, m, hd), _randn(rng, b, s, g, hd), \
        _randn(rng, b, s, g, hd)
    o, L = FA.flash_attention_plain(_t(q).reshape(b, s, g * m, hd), _t(k),
                                    _t(v), causal=True, return_lse=True)
    o_j, L_j = jattn._flash_fwd_stats(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), True, 8, 8)
    L_j = np.moveaxis(np.asarray(L_j), 0, 3).reshape(b, g * m, s)
    assert L.shape == (b, g * m, s) and L.dtype == torch.float32
    np.testing.assert_allclose(L.numpy(), L_j, **TOL)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_j)
                               .reshape(b, s, g * m, hd), **TOL)


# ---------------------------------------------------------------------------
# losses and optimizer
# ---------------------------------------------------------------------------

def test_cross_entropy_value_and_grad_match_jax():
    """A mask with zeros, value and d/dlogits. TOL."""
    rng = np.random.default_rng(11)
    logits = _randn(rng, 3, 7, 50) * 3
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) > 0.3).astype(np.float32)
    (l_j, m_j), g_j = jax.value_and_grad(
        lambda x: jloss.cross_entropy(x, jnp.asarray(labels),
                                      jnp.asarray(mask)), has_aux=True)(
        jnp.asarray(logits))
    x = _t(logits).requires_grad_()
    l_t, m_t = tloss.cross_entropy(x, _t(labels), _t(mask))
    (g_t,) = torch.autograd.grad(l_t, x)
    np.testing.assert_allclose(l_t.item(), float(l_j), **TOL)
    np.testing.assert_allclose(m_t["accuracy"].item(),
                               float(m_j["accuracy"]), **TOL)
    assert m_t["tokens"].item() == float(m_j["tokens"]) == mask.sum()
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_j), **TOL)


@pytest.mark.parametrize("s,chunk,masked", [(20, 8, True), (16, 8, False),
                                            (5, 1024, True)])
def test_chunked_cross_entropy_value_and_grads_match_jax(s, chunk, masked):
    """Padded (s = 20 in chunks of 8) and whole chunks, with and without a
    mask: the loss, accuracy, tokens and the gradients of x and w. TOL."""
    rng = np.random.default_rng(s)
    x, w = _randn(rng, 2, s, 16), _randn(rng, 16, 40) / 4
    labels = rng.integers(0, 40, (2, s)).astype(np.int32)
    mask = (rng.random((2, s)) > 0.25).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    (l_j, m_j), (gx_j, gw_j) = jax.value_and_grad(
        lambda x, w: jloss.chunked_cross_entropy(
            x, w, jnp.asarray(labels), jm, chunk=chunk),
        argnums=(0, 1), has_aux=True)(jnp.asarray(x), jnp.asarray(w))
    tx, tw = _t(x).requires_grad_(), _t(w).requires_grad_()
    l_t, m_t = tloss.chunked_cross_entropy(
        tx, tw, _t(labels), None if mask is None else _t(mask), chunk=chunk)
    gx_t, gw_t = torch.autograd.grad(l_t, (tx, tw))
    np.testing.assert_allclose(l_t.item(), float(l_j), **TOL)
    for key in ("accuracy", "tokens"):
        np.testing.assert_allclose(m_t[key].item(), float(m_j[key]), **TOL)
    np.testing.assert_allclose(gx_t.numpy(), np.asarray(gx_j), **TOL)
    np.testing.assert_allclose(gw_t.numpy(), np.asarray(gw_j), **TOL)


@pytest.mark.parametrize("step", [0, 1, 7, 20, 21, 500, 9_999, 10_000,
                                  20_000])
def test_lr_at_matches_jax(step):
    """Warmup, its end, the cosine and past its end; fp32 both. rtol 1e-6."""
    oc = jopt.OptConfig(warmup_steps=20, total_steps=10_000)
    got = topt.lr_at(topt.OptConfig(warmup_steps=20, total_steps=10_000),
                     step)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(jopt.lr_at(
        oc, jnp.asarray(step, jnp.int32))), rtol=1e-6)


def test_adamw_update_matches_jax():
    """One update from a state three steps old, clipping active: params,
    master, m, v, grad_norm and lr. TOL."""
    rng = np.random.default_rng(5)
    params = {"a": _randn(rng, 6, 5), "b": {"c": _randn(rng, 7)}}
    grads = {"a": _randn(rng, 6, 5) * 2, "b": {"c": _randn(rng, 7) * 2}}
    state = {"master": params,
             "m": jax.tree.map(lambda p: _randn(rng, *p.shape) * .1, params),
             "v": jax.tree.map(lambda p: np.abs(_randn(rng, *p.shape)) * .1,
                               params)}
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=1.0)
    jp, jo, jm = jopt.adamw_update(
        jopt.OptConfig(**kw), jax.tree.map(jnp.asarray, params),
        jax.tree.map(jnp.asarray, grads),
        {**jax.tree.map(jnp.asarray, state), "step": jnp.int32(3)})
    tp = jax.tree.map(_t, params)
    to = {**jax.tree.map(lambda a: _t(a.copy()), state),
          "step": torch.tensor(3, dtype=torch.int32)}
    tp, to, tm = topt.adamw_update(topt.OptConfig(**kw), tp,
                                   jax.tree.map(_t, grads), to)
    assert int(to["step"]) == 4
    assert float(jm["grad_norm"]) > 1.0           # the clip is active
    np.testing.assert_allclose(tm["grad_norm"].item(), float(jm["grad_norm"]),
                               **TOL)
    np.testing.assert_allclose(tm["lr"].item(), float(jm["lr"]), **TOL)
    for name, got, exp in (("params", tp, jp), ("master", to["master"],
                                                jo["master"]),
                           ("m", to["m"], jo["m"]), ("v", to["v"], jo["v"])):
        for key, leaf in _flat(got).items():
            np.testing.assert_allclose(
                leaf.numpy(), np.asarray(_flat(exp)[key]), **TOL,
                err_msg=f"{name}/{key}")


def _combine_then_update(oc, params, trees, counts, opt):
    """The trainer's combine and ``adamw_update`` as the port ran them
    before the update took the chunks' gradients itself: each leaf summed
    in fp32 in chunk order and divided by the examples, then the global
    norm, the clip and AdamW, leaf by leaf."""
    total_n = sum(counts)
    chunk_leaves = [topt.tree_leaves(t) for t in trees]
    grads = []
    for i in range(len(chunk_leaves[0])):
        acc = None
        for n, leaves in zip(counts, chunk_leaves):
            term = leaves[i].float() * n
            acc = term if acc is None else acc.add_(term)
        grads.append(acc.div_(total_n))
    step = opt["step"] + 1
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
    scale = torch.clamp(oc.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    stepf = step.to(torch.float32)
    bc1 = float(1 - torch.tensor(oc.beta1, dtype=torch.float32) ** stepf)
    bc2 = float(1 - torch.tensor(oc.beta2, dtype=torch.float32) ** stepf)
    lr = float(topt.lr_at(oc, step))
    b1, b2 = oc.beta1, oc.beta2
    for g, m, v, master, p in zip(grads, topt.tree_leaves(opt["m"]),
                                  topt.tree_leaves(opt["v"]),
                                  topt.tree_leaves(opt["master"]),
                                  topt.tree_leaves(params)):
        g = g.float() * scale
        m.mul_(b1).add_(g * (1 - b1))
        v.mul_(b2).add_(torch.square(g) * (1 - b2))
        update = (m / bc1) / (torch.sqrt(v / bc2) + oc.eps) \
            + oc.weight_decay * master
        master.sub_(lr * update)
        p.copy_(master)
    opt["step"] = step
    return gnorm


@pytest.mark.parametrize("clip", ["active", "inactive"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "fp32"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_adamw_update_of_chunk_grads_repeats_the_combine_then_update(
        k, dtype, clip):
    """``adamw_update`` on a ``ChunkGrads`` of k chunks with unequal
    example counts, on the CPU (the plain version of its two passes): the
    parameters, master, m, v and the norm bit for bit those of the
    trainer's combine then the update as they ran before, in bf16 and fp32
    leaves, with the clip at work or not."""
    torch.manual_seed(k)
    params = _tree_of({"a": (33, 7), "b": {"c": (5,), "d": (3, 4, 2)}},
                      dtype)
    counts = [3.0, 8.0, 1.0, 6.0][:k]
    trees = [topt.tree_map(lambda p: (torch.randn(p.shape) * 0.4).to(dtype),
                           params) for _ in range(k)]
    oc = topt.OptConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                        clip_norm=1.0 if clip == "active" else 1e6)
    opt = topt.init_opt_state(params)
    opt["m"] = topt.tree_map(lambda m: torch.randn(m.shape) * 0.1, opt["m"])
    opt["v"] = topt.tree_map(lambda v: torch.rand(v.shape) * 0.1, opt["v"])
    opt["step"] = torch.tensor(3, dtype=torch.int32)
    opts = [{k_: topt.tree_map(torch.clone, v) if k_ != "step" else v
             for k_, v in opt.items()} for _ in range(2)]
    got_p, want_p = (topt.tree_map(torch.clone, params) for _ in range(2))
    _, got_opt, metrics = topt.adamw_update(
        oc, got_p, topt.ChunkGrads(trees, counts), opts[0])
    want_norm = _combine_then_update(oc, want_p, trees, counts, opts[1])
    assert (float(want_norm) > oc.clip_norm) == (clip == "active")
    assert torch.equal(metrics["grad_norm"], want_norm)
    assert int(got_opt["step"]) == 4
    for got, want in ((got_p, want_p), (got_opt["master"], opts[1]["master"]),
                      (got_opt["m"], opts[1]["m"]),
                      (got_opt["v"], opts[1]["v"])):
        for a, b in zip(topt.tree_leaves(got), topt.tree_leaves(want)):
            assert a.dtype == b.dtype and torch.equal(a, b)


def _tree_of(shapes, dtype):
    if isinstance(shapes, dict):
        return {k: _tree_of(v, dtype) for k, v in shapes.items()}
    return torch.randn(shapes).to(dtype)


# ---------------------------------------------------------------------------
# the model's training forward, grad_step, the trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["stablelm-1.6b", "phi-3-vision-4.2b"])
def test_training_forward_matches_jax(arch):
    """Logits of the dense model and of the vlm one (its 4 prefix rows
    included), with remat, and the vlm's loss with its prefix dropped.
    Logits rtol = atol = 1e-4 (as test_torch_model's whole-model checks:
    two layers and a 256-wide unembedding sum in other orders); the loss
    rtol 1e-5."""
    tcfg, jcfg, jparams, tparams = _model(arch)
    batch = _batch(tcfg)
    prefix = batch.get("prefix_emb")
    lj, _ = JM.forward(jcfg, jparams, jnp.asarray(batch["tokens"]),
                       None if prefix is None else jnp.asarray(prefix),
                       remat=True)
    lt, aux = TM.forward(tcfg, tparams, _t(batch["tokens"]),
                         None if prefix is None else _t(prefix), remat=True)
    assert lt.shape == (4, SEQ, tcfg.vocab) and aux.item() == 0.0
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj),
                               rtol=1e-4, atol=1e-4)
    loss_j, _ = jstep.loss_fn(jcfg, jparams, _jb(batch))
    loss_t, _ = tstep.loss_fn(tcfg, tparams, _tb(batch))
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "phi-3-vision-4.2b",
                                  "musicgen-large"])
def test_grad_step_matches_jax_leaf_by_leaf(arch):
    """Every parameter's gradient of one grad_step (dense, vlm with its
    prefix, audio with learned positions), a padded row masked out, and
    the loss (TOL). Each leaf within 5e-4 of its largest |gradient|: the
    repo's random block weights have std 1/sqrt(n_layers) (ROADMAP C,
    "fan-in of stacked weights"), so attention is sharp and amplifies the
    fp32 rounding of the forward (the whole-model forward checks of
    test_torch_model need 1e-4 already); the two JAX routes, which share
    one forward, agree to ~1e-6, and FlashAttentionFn alone to TOL."""
    tcfg, jcfg, jparams, tparams = _model(arch)
    batch = _batch(tcfg)
    gj, mj = jstep.grad_step(jcfg, jparams, _jb(batch))
    gt, mt = tstep.grad_step(tcfg, tparams, _tb(batch))
    np.testing.assert_allclose(mt["loss"].item(), float(mj["loss"]), **TOL)
    flat_j, flat_t = _flat(_np_tree(gj)), _flat(gt)
    assert flat_j.keys() == flat_t.keys()
    for key, exp in flat_j.items():
        assert flat_t[key].shape == exp.shape, key
        err = np.abs(flat_t[key].numpy() - exp).max()
        assert err <= 5e-4 * np.abs(exp).max(), (key, err)


def test_hetero_trainer_step_matches_jax():
    """One HeteroTrainer.train_step with one group (chunks of 8, 2 in
    flight, a global batch of 22, so the last chunk holds 6 examples padded
    to 8) from the JAX trainer's own weights: the loss (TOL); the combined
    gradient, read as AdamW's first moment m = (1 - beta1) g after one step,
    each leaf within 5e-4 of its largest entry (the fp32 gradient tolerance
    of test_grad_step_matches_jax_leaf_by_leaf); and every parameter after
    the update (rtol = atol = 1e-5). AdamW's first step moves a weight by
    lr g / (|g| + eps): with the default eps 1e-8 a gradient near zero moves
    it by +-lr on its sign alone, which the fp32 noise of the gradients
    flips, so eps is 1e-2 here, where the update is a smooth function of
    the gradient."""
    jcfg = jax_reduced("stablelm-1.6b").replace(dtype="float32")
    tcfg = get_reduced_config("stablelm-1.6b").replace(dtype="float32")
    oc = dict(lr=1e-3, warmup_steps=1, eps=1e-2)
    jt = jtrainer.HeteroTrainer(
        jcfg, [jtrainer.GroupDef("accel", JDeviceKind.ACCEL, fixed_chunk=8,
                                 async_depth=2)],
        seq_len=SEQ, global_batch=22, oc=jopt.OptConfig(**oc), seed=2)
    tt = HeteroTrainer(
        tcfg, [GroupDef("accel", DeviceKind.ACCEL, device="cpu",
                        fixed_chunk=8, async_depth=2)],
        seq_len=SEQ, global_batch=22, oc=topt.OptConfig(**oc), seed=2,
        params=params_from_jax(tcfg, _np_tree(jt.params), "cpu"))
    rj, rt = jt.train_step(), tt.train_step()
    assert rt.examples == rj.examples == 22 and rt.step == 1
    np.testing.assert_allclose(rt.loss, rj.loss, **TOL)
    m_j = _flat(_np_tree(jt.opt["m"]))
    for key, leaf in _flat(tt.opt["m"]).items():
        err = np.abs(leaf.numpy() - m_j[key]).max()
        assert err <= 5e-4 * np.abs(m_j[key]).max(), (key, err)
    flat_j = _flat(_np_tree(jt.params))
    for key, leaf in _flat(tt.params).items():
        np.testing.assert_allclose(leaf.numpy(), flat_j[key], rtol=1e-5,
                                   atol=1e-5, err_msg=key)
    assert int(tt.opt["step"]) == int(jt.opt["step"]) == 1


def test_trainer_loss_decreases_and_conserves_work():
    """The torch twin of test_integration's trainer test: two groups on the
    CPU, one slowed 4x. The loss falls and every step covers the whole
    global batch; how the work splits is not asserted (ROADMAP C)."""
    cfg = get_reduced_config("stablelm-1.6b").replace(dtype="float32")
    groups = [GroupDef("accel", DeviceKind.ACCEL, device="cpu",
                       fixed_chunk=8, async_depth=2),
              GroupDef("cpu0", DeviceKind.BIG, device="cpu", slowdown=4.0)]
    tr = HeteroTrainer(cfg, groups, seq_len=SEQ, global_batch=32,
                       oc=topt.OptConfig(lr=1e-3, warmup_steps=1),
                       repeat_data=True)
    reps = tr.train(4)
    assert reps[-1].loss < reps[0].loss
    for r in reps:
        assert r.examples == 32 and sum(r.per_group_items.values()) == 32
        assert not r.failed_groups


def test_trainer_survives_a_group_failure():
    """A group that dies on its first chunk: its chunk is re-queued and the
    step still covers the whole batch."""
    cfg = get_reduced_config("stablelm-1.6b").replace(dtype="float32")
    groups = [GroupDef("accel", DeviceKind.ACCEL, device="cpu",
                       fixed_chunk=8),
              GroupDef("cpu0", DeviceKind.BIG, device="cpu",
                       fail_after_chunks=0)]
    tr = HeteroTrainer(cfg, groups, seq_len=SEQ, global_batch=32,
                       oc=topt.OptConfig(lr=1e-3, warmup_steps=1))
    rep = tr.train_step()
    assert "cpu0" in rep.failed_groups
    assert rep.examples == 32 and np.isfinite(rep.loss)


def test_tune_accel_chunk_picks_a_tried_chunk():
    cfg = get_reduced_config("stablelm-1.6b").replace(dtype="float32")
    tr = HeteroTrainer(cfg, [GroupDef("accel", DeviceKind.ACCEL,
                                      device="cpu")],
                       seq_len=SEQ, global_batch=16)
    g = tr.tune_accel_chunk(seed_chunk=4, multiples=2)
    assert g in (4, 8) and tr.groups[0].fixed_chunk == g


def test_cuda_trainer_refuses_float32_before_placing_weights():
    cfg = get_reduced_config("stablelm-1.6b").replace(dtype="float32")
    with pytest.raises(ValueError, match="bfloat16"):
        HeteroTrainer(cfg, [GroupDef("accel", DeviceKind.ACCEL,
                                     device="cuda:0")])


# ---------------------------------------------------------------------------
# checkpoints, launcher
# ---------------------------------------------------------------------------

def test_checkpoints_restore_across_the_packages(tmp_path):
    """A torch trainer's bf16 params and fp32 optimizer state restore in
    the JAX package bit for bit, and a JAX checkpoint restores here."""
    cfg = get_reduced_config("stablelm-1.6b")            # bfloat16
    tr = HeteroTrainer(cfg, [GroupDef("accel", DeviceKind.ACCEL,
                                      device="cpu", fixed_chunk=8)],
                       seq_len=SEQ, global_batch=8)
    tr.train_step()
    tree = {"params": tr.params, "opt": tr.opt}
    Checkpointer(tmp_path / "t").save(tr.step_idx, tree)
    restored, meta = JaxCheckpointer(tmp_path / "t").restore()
    assert meta["step"] == 1
    flat_t, flat_j = _flat(tree), _flat(restored)
    assert flat_t.keys() == flat_j.keys()
    for key, leaf in flat_t.items():
        got = np.asarray(flat_j[key])
        assert str(got.dtype) == str(leaf.dtype).replace("torch.", "")
        np.testing.assert_array_equal(got.astype(np.float64),
                                      leaf.double().numpy(), err_msg=key)
    # and back: a JAX trainer's checkpoint into the port's trainer
    jcfg = jax_reduced("stablelm-1.6b")
    jt = jtrainer.HeteroTrainer(
        jcfg, [jtrainer.GroupDef("accel", JDeviceKind.ACCEL, fixed_chunk=8)],
        seq_len=SEQ, global_batch=8)
    JaxCheckpointer(tmp_path / "j").save(
        0, {"params": jt.params, "opt": jt.opt})
    tree, meta = Checkpointer(tmp_path / "j").restore()
    tr.load_state(tree["params"], tree["opt"], meta["step"])
    flat_j = _flat(_np_tree({"params": jt.params, "opt": jt.opt}))
    for key, leaf in _flat({"params": tr.params, "opt": tr.opt}).items():
        assert leaf.dtype == {"bfloat16": torch.bfloat16,
                              "float32": torch.float32,
                              "int32": torch.int32}[str(flat_j[key].dtype)]
        np.testing.assert_array_equal(leaf.double().numpy(),
                                      flat_j[key].astype(np.float64),
                                      err_msg=key)
    assert tr.step_idx == 0 and np.isfinite(tr.train_step().loss)


def test_launcher_trains_on_the_cpu(tmp_path):
    """``--device cpu --reduced --steps 3``, a checkpoint at step 2 and a
    resume: the reference's final JSON keys."""
    argv = ["--arch", "stablelm-1.6b", "--reduced", "--steps", "3",
            "--device", "cpu", "--global-batch", "8", "--seq-len", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_launcher.main(argv)
    lines = out.getvalue().splitlines()
    assert sum(line.startswith("step ") for line in lines) == 3
    report = json.loads(lines[-1])
    assert set(report) == {"wall_s", "final_loss", "energy_model_j", "edp"}
    assert np.isfinite(report["final_loss"])
    assert Checkpointer(tmp_path).steps() == [2, 3]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_launcher.main(argv[:4] + ["4"] + argv[5:] + ["--resume"])
    lines = out.getvalue().splitlines()
    assert lines[0] == "resumed from step 3" and lines[1].startswith("step    4")


def test_launcher_refuses_a_missing_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    err = io.StringIO()
    with pytest.raises(SystemExit), contextlib.redirect_stderr(err):
        train_launcher.main(["--arch", "stablelm-1.6b", "--reduced"])
    assert "no CUDA GPU" in err.getvalue()


# ---------------------------------------------------------------------------
# ROADMAP C5: a kernel has no backward and must not cut a graph silently
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.bfloat16, grad=False):
    return torch.empty(*shape, dtype=dtype, device="meta",
                       requires_grad=grad)


@pytest.mark.parametrize("kernel", ["flash_attention", "flash_decode",
                                    "ssd_scan"])
def test_kernel_wrappers_refuse_inputs_that_require_grad(kernel):
    """Off the CPU (a meta tensor stands in for a CUDA one here), each
    wrapper raises when grad is enabled and an input requires grad, before
    anything else; under no_grad it goes on to its own checks."""
    calls = {
        "flash_attention": lambda grad: FA.flash_attention(
            _meta(1, 8, 2, 16, grad=grad), _meta(1, 8, 2, 16),
            _meta(1, 8, 2, 16)),
        "flash_decode": lambda grad: FD.flash_decode(
            _meta(1, 1, 2, 16), _meta(1, 8, 2, 16, grad=grad),
            _meta(1, 8, 2, 16), _meta(1, dtype=torch.int32)),
        "ssd_scan": lambda grad: SSD.ssd_scan(
            _meta(1, 8, 2, 16), _meta(1, 8, 2, dtype=torch.float32,
                                      grad=grad),
            _meta(2, dtype=torch.float32), _meta(1, 8, 1, 8),
            _meta(1, 8, 1, 8), 8),
    }
    with pytest.raises(RuntimeError, match=f"{kernel}: the CUDA kernel has "
                                           f"no backward"):
        calls[kernel](True)
    with torch.no_grad(), pytest.raises(ValueError, match="runs on CUDA"):
        calls[kernel](True)
    with pytest.raises(ValueError, match="runs on CUDA"):
        calls[kernel](False)


def test_flash_attention_fn_calls_the_kernel_wrapper_with_grad_off(
        monkeypatch):
    """Inside FlashAttentionFn the wrapper runs with grad disabled, so the
    guard lets the training forward through: a CUDA tensor's route, shown
    by a stand-in for the kernel's entry point."""
    seen = []

    def fake(q, k, v, *, n_heads, n_kv_heads, causal, return_lse):
        seen.append(torch.is_grad_enabled())
        return FA.flash_attention_plain(q, k, v, causal=causal,
                                        return_lse=return_lse)

    monkeypatch.setattr(tattn.ops, "attention_bshd", fake)
    monkeypatch.setattr(torch.Tensor, "is_cuda", property(lambda t: True))
    q = torch.randn(1, 8, 2, 1, 16, requires_grad=True)
    k, v = torch.randn(1, 8, 2, 16), torch.randn(1, 8, 2, 16)
    o = tattn.FlashAttentionFn.apply(q, k, v, True, 8, 8)
    monkeypatch.undo()
    (dq,) = torch.autograd.grad(o.sum(), (q,))
    assert seen == [False] and torch.isfinite(dq).all()
