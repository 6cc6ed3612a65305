"""Training the MoE, xLSTM and hybrid families: the port against the JAX
package, on the CPU.

On reduced fp32 models whose weights come from the JAX package through
``repro_torch.bridge``: the training forward's logits and aux loss, one ``grad_step`` leaf by leaf against
``jax.grad``, one ``HeteroTrainer`` step against the JAX trainer, and the
launcher training each family. Inputs come from numpy seeds. Each test
states its tolerance.

MoE routing is discrete: ``torch.topk`` and ``jax.lax.top_k`` break ties
differently and a near-tie flips on fp32 noise. So before an MoE model is
compared, every router call of the port's forward is recorded and checked
for near-ties at the top-k cut and at each expert's capacity cut.
"""
import contextlib
import dataclasses
import importlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced_config as jax_reduced
from repro.core.types import DeviceKind as JDeviceKind
from repro.models import model as JM
from repro.train import optimizer as jopt
from repro.train import trainer as jtrainer
from repro_torch.bridge import params_from_jax
from repro_torch.configs.registry import get_reduced_config
from repro_torch.core.types import DeviceKind
from repro_torch.data.pipeline import for_model
from repro_torch.launch import train as train_launcher
from repro_torch.models import model as TM
from repro_torch.models import moe as tmoe
from repro_torch.train import optimizer as topt
from repro_torch.train.trainer import GroupDef, HeteroTrainer

jstep = importlib.import_module("repro.train.train_step")
tstep = importlib.import_module("repro_torch.train.train_step")

#: fp32, tests/test_kernels.py's fp32 tolerance
TOL = dict(rtol=2e-5, atol=2e-5)
SEQ = 32
#: near-tie margins, relative: the repo's random routers are sharp (the
#: stacked fan-in, ROADMAP C), with probabilities down to 1e-9, where the
#: absolute margins of tests/test_torch_moe.py say nothing; the packages'
#: fp32 router outputs differ by ~1e-6 of a value at most. A token's k-th and
#: (k+1)-th router log-probabilities; the priorities within this share of an
#: expert's capacity cut
ROUTE_MARGIN, CUT_MARGIN = 1e-4, 1e-4

#: (id, arch, config changes, block matrices at fan-in scale, gradient
#: tolerance): reduced granite-moe at 4 experts top-2, at the full config's
#: ratio of picked experts (8 of 32, kept as 4 of 16), and at fan-in scale;
#: reduced xlstm (2 pairs of 1 mLSTM + 1 sLSTM) and one pair of 2 mLSTM +
#: 1 sLSTM (the mLSTM weights stacked twice over; at fan-in scale, since
#: at the repo's scale the JAX package's gradient is NaN on every row, ROADMAP
#: C8, which the port repairs); reduced zamba2 at 4
#: layers (two groups of 2 Mamba-2 blocks and the shared block) and 5 (a
#: tail block after them). The tolerance is each leaf's max |diff| over
#: its largest |gradient|: 5e-4, test_torch_train's fp32 gradient one (the
#: repo's random block weights have std 1/sqrt(n_layers), ROADMAP C, so
#: attention is sharp and amplifies fp32 rounding through the layers);
#: 1e-3 for granite at 4 experts, whose layer-0 attention leaves read
#: 5.9e-4 (and 1.1e-6 with the same weights at fan-in scale, the third
#: case, held to 2e-5: the amplification is the weights', not the MoE's)
MODELS = [
    ("granite", "granite-moe-1b-a400m", {}, False, 1e-3),
    ("granite-8of32-ratio", "granite-moe-1b-a400m",
     dict(moe=dict(num_experts=16, top_k=4)), False, 5e-4),
    ("granite-fan-in", "granite-moe-1b-a400m", {}, True, 2e-5),
    ("xlstm", "xlstm-350m", {}, False, 5e-4),
    ("xlstm-2m-fan-in", "xlstm-350m",
     dict(n_layers=3, xlstm=dict(slstm_every=3)), True, 5e-4),
    ("zamba2", "zamba2-1.2b", {}, False, 5e-4),
    ("zamba2-tail", "zamba2-1.2b", dict(n_layers=5), False, 5e-4),
]
MODEL_IDS = [m[0] for m in MODELS]
FAMILIES = ["granite-moe-1b-a400m", "xlstm-350m", "zamba2-1.2b"]


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _changed(cfg, changes):
    kw = {k: dataclasses.replace(getattr(cfg, k), **v)
          if isinstance(v, dict) else v for k, v in changes.items()}
    return cfg.replace(dtype="float32", **kw)


def _model(arch, changes=None, fan_in=False):
    """(torch config, JAX config, JAX params, torch params) of the reduced
    fp32 ``arch`` with ``changes``, the same weights in both; with
    ``fan_in`` the stacked block matrices scaled to stddev 1/sqrt(d_model),
    as chip_smoke.py's gradient checks scale them."""
    jcfg = _changed(jax_reduced(arch), changes or {})
    tcfg = _changed(get_reduced_config(arch), changes or {})
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    if fan_in:
        jparams = _fan_in(jcfg, jparams)
    return tcfg, jcfg, jparams, params_from_jax(tcfg, _np_tree(jparams),
                                                "cpu")


def _fan_in(cfg, params):
    """``params`` with every stacked block matrix (the leaves of three or
    more axes under blocks, m, s, groups and tail) scaled from the stacked
    fan-in's stddev 1/sqrt(n_layers) to 1/sqrt(d_model)."""
    f = np.sqrt(cfg.n_layers / cfg.d_model)
    return {k: jax.tree.map(lambda t: t * f if t.ndim >= 3 else t, v)
            if k in ("blocks", "m", "s", "groups", "tail") else v
            for k, v in params.items()}


def _batch(cfg, n=4, seed=3):
    """A batch from the data pipeline, its last row padded away by the
    loss mask, as numpy."""
    return for_model(cfg, SEQ, seed).batch(0, n - 1, pad_to=n)


def _check_no_near_ties(cfg, params, batch):
    """Run the port's forward on ``batch`` with every router call recorded
    and assert that no top-k cut and no capacity cut is a near-tie that
    could move the loss; returns the number of router calls. The padded
    rows (loss mask 0) hold token 0 throughout, so their tokens tie with
    one another at every cut up to fp32 rounding; which of them an expert
    keeps moves no gradient (their loss is masked, and a row attends to
    itself alone), so a cut that only such tokens straddle is no tie."""
    calls = []
    route = tmoe._route

    def recording(cfg_, p, xf):
        out = route(cfg_, p, xf)
        calls.append(out[0].double().numpy())
        return out

    tmoe._route = recording
    try:
        with torch.no_grad():
            TM.forward(cfg, params, _t(batch["tokens"]))
    finally:
        tmoe._route = route
    m = cfg.moe
    masked = (batch["loss_mask"] == 0).all(-1).repeat(SEQ)
    for probs in calls:
        T, E = probs.shape
        order = np.argsort(-probs, axis=-1)
        top = np.take_along_axis(probs, order[:, :m.top_k + 1], -1)
        assert (np.log(top[:, -2]) - np.log(top[:, -1])).min() \
            > ROUTE_MARGIN
        prio = np.zeros_like(probs)
        np.put_along_axis(prio, order[:, :m.top_k], top[:, :-1]
                          / top[:, :-1].sum(-1, keepdims=True), -1)
        G = max(1, min(m.dispatch_groups, T))
        n = T // G
        Cg = max(1, tmoe.expert_capacity(cfg, T) // G)
        for g in range(G):
            for e in range(E):
                col = prio[g * n:(g + 1) * n, e]
                ranked = np.argsort(-col, kind="stable")
                if Cg >= n or col[ranked[Cg - 1]] == 0:
                    continue
                cut = col[ranked[Cg - 1]]
                band = np.abs(col - cut) <= CUT_MARGIN * cut
                kept = np.zeros(n, bool)
                kept[ranked[:Cg]] = True
                if (band & kept).any() and (band & ~kept).any():
                    assert masked[g * n:(g + 1) * n][band].all(), (g, e)
    return len(calls)


# ---------------------------------------------------------------------------
# the training forward, grad_step, the trainer, the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILIES)
def test_training_forward_matches_jax(arch):
    """The logits and the aux loss of the training forward with remat:
    MoE's Switch aux summed over its 2 layers, 0 for the others. Logits
    rtol = atol = 1e-4 (the whole-model checks of test_torch_model), 2e-4
    for MoE, one of whose 32,768 logits lies 1.2e-4 off (the amplification
    of the gradient test's granite case); the aux rtol 1e-5; and the loss
    (loss_fn adds the aux), rtol 1e-5."""
    tcfg, jcfg, jparams, tparams = _model(arch)
    batch = _batch(tcfg)
    if tcfg.moe:
        assert _check_no_near_ties(tcfg, tparams, batch) == tcfg.n_layers
    lj, aux_j = JM.forward(jcfg, jparams, jnp.asarray(batch["tokens"]),
                           remat=True)
    lt, aux_t = TM.forward(tcfg, tparams, _t(batch["tokens"]), remat=True)
    assert lt.shape == (4, SEQ, tcfg.vocab)
    tol = 2e-4 if tcfg.moe else 1e-4
    np.testing.assert_allclose(lt.detach().numpy(), np.asarray(lj),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(aux_t.item(), float(aux_j), rtol=1e-5)
    assert (aux_t.item() > 0) == bool(tcfg.moe)
    loss_j, m_j = jstep.loss_fn(jcfg, jparams,
                                {k: jnp.asarray(v) for k, v in batch.items()})
    loss_t, m_t = tstep.loss_fn(tcfg, tparams,
                                {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    np.testing.assert_allclose(m_t["aux_loss"].item(),
                               float(m_j["aux_loss"]), rtol=1e-5)


@pytest.mark.parametrize("arch,changes,fan_in,tol", [m[1:] for m in MODELS],
                         ids=MODEL_IDS)
def test_grad_step_matches_jax_leaf_by_leaf(arch, changes, fan_in, tol):
    """Every parameter's gradient of one grad_step against ``jax.grad``
    (the MoE router's through the gates and the aux loss; the shared
    attention block's summed over its uses), a padded row masked out;
    every leaf finite; the loss TOL; each leaf within ``tol`` of its
    largest |gradient| (MODELS says why). MoE models are checked for
    near-ties first. The JAX package's xLSTM gradient is NaN on the padded
    row (ROADMAP C8, the next test), so for xLSTM it is taken on the real
    rows alone: the same loss, since a masked row adds nothing to it."""
    tcfg, jcfg, jparams, tparams = _model(arch, changes, fan_in)
    batch = _batch(tcfg)
    if tcfg.moe:
        _check_no_near_ties(tcfg, tparams, batch)
    jbatch = {k: v[:3] for k, v in batch.items()} \
        if tcfg.family == "ssm" else batch
    gj, mj = jstep.grad_step(jcfg, jparams,
                             {k: jnp.asarray(v) for k, v in jbatch.items()})
    gt, mt = tstep.grad_step(tcfg, tparams,
                             {k: _t(v) for k, v in batch.items()})
    np.testing.assert_allclose(mt["loss"].item(), float(mj["loss"]), **TOL)
    flat_j, flat_t = _flat(_np_tree(gj)), _flat(gt)
    assert flat_j.keys() == flat_t.keys()
    for key, exp in flat_j.items():
        got = flat_t[key].numpy()
        assert got.shape == exp.shape and np.isfinite(got).all(), key
        err = np.abs(got - exp).max()
        assert err <= tol * np.abs(exp).max(), (key, err)


def test_xlstm_gradient_stays_finite_where_the_reference_overflows():
    """ROADMAP C8. On the padded row (token 0 throughout) of reduced
    xlstm's batch, one head of the second mLSTM block has its log input
    gate near -100 at every position, so the stabiliser m stays below
    -88.7 and exp(-m), the
    normaliser's floor, overflows: h = num / inf = 0 forward, and the
    backward's 0 * inf is NaN, which the JAX package's gradient carries
    into every leaf before the final norm. The port caps -m at 88
    (``models.ssm._exp_floor``): its gradient is finite, and a masked
    row adds nothing, so it equals the JAX gradient on the real rows
    alone (the previous test) -- here checked against the port's own."""
    tcfg, jcfg, jparams, tparams = _model("xlstm-350m")
    batch = _batch(tcfg)
    gj, _ = jstep.grad_step(jcfg, jparams,
                            {k: jnp.asarray(v) for k, v in batch.items()})
    flat_j = _flat(_np_tree(gj))
    assert not np.isfinite(flat_j["m/wq"]).all()
    assert np.isfinite(flat_j["unembed"]).all()
    gt, _ = tstep.grad_step(tcfg, tparams,
                            {k: _t(v) for k, v in batch.items()})
    real, _ = tstep.grad_step(tcfg, tparams,
                              {k: _t(v[:3]) for k, v in batch.items()})
    for key, leaf in _flat(gt).items():
        assert torch.isfinite(leaf).all(), key
        exp = _flat(real)[key]
        assert (leaf - exp).abs().max() <= 1e-5 * exp.abs().max(), key


@pytest.mark.parametrize("arch", FAMILIES)
def test_hetero_trainer_step_matches_jax(arch):
    """One HeteroTrainer.train_step, one group (chunks of 8, 2 in flight,
    a global batch of 22: the last chunk holds 6 examples padded to 8),
    from the JAX trainer's own weights with the block matrices at fan-in
    scale (``_fan_in``: at the repo's scale the JAX package's xLSTM
    gradient is NaN, ROADMAP C8): the loss (TOL); the combined
    gradient, read as AdamW's first moment, each leaf within 5e-4 of its
    largest entry; every parameter after the update rtol = atol = 1e-5,
    with AdamW's eps at 1e-2 (test_torch_train's trainer test says why).
    MoE's three chunk batches are checked for near-ties first."""
    jcfg = jax_reduced(arch).replace(dtype="float32")
    tcfg = get_reduced_config(arch).replace(dtype="float32")
    oc = dict(lr=1e-3, warmup_steps=1, eps=1e-2)
    jt = jtrainer.HeteroTrainer(
        jcfg, [jtrainer.GroupDef("accel", JDeviceKind.ACCEL, fixed_chunk=8,
                                 async_depth=2)],
        seq_len=SEQ, global_batch=22, oc=jopt.OptConfig(**oc), seed=2)
    jt.params = _fan_in(jcfg, jt.params)
    jt.opt = jopt.init_opt_state(jt.params)
    tt = HeteroTrainer(
        tcfg, [GroupDef("accel", DeviceKind.ACCEL, device="cpu",
                        fixed_chunk=8, async_depth=2)],
        seq_len=SEQ, global_batch=22, oc=topt.OptConfig(**oc), seed=2,
        params=params_from_jax(tcfg, _np_tree(jt.params), "cpu"))
    if tcfg.moe:
        for begin, end in ((0, 8), (8, 16), (16, 22)):
            _check_no_near_ties(tcfg, tt.params,
                                tt.data.batch(begin, end, pad_to=8))
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


@pytest.mark.parametrize("eps,tol", [(1e-2, 2e-5), (1e-8, 1e-3)],
                         ids=["eps-1e-2", "eps-default"])
def test_moe_trainer_six_steps_match_jax(eps, tol):
    """ROADMAP C16: reduced granite-moe in fp32 trained 6 AdamW steps at
    lr 1e-3 (warm-up 1, total 6: chip_smoke.py's TRAIN_OC) on one repeated
    global batch of 16 in two chunks of 8, through the JAX trainer and the
    port's from the JAX trainer's own weights (the repo's random scale,
    as the full-width run trains them). Step by step the reported loss and
    the Switch aux loss of the step's weights on that batch agree within
    ``tol`` relative, and both losses fall. With AdamW's eps at 1e-2
    (test_hetero_trainer_step_matches_jax's setting) the two stay within
    fp32 rounding, 2e-5 (measured 2.8e-6 for the loss, 3.7e-7 for the aux
    loss at step 5). At the default eps 1e-8 a gradient entry that is fp32
    noise in both packages takes a full lr step of either sign, so the
    runs part by 2.1e-4 of the loss and 2.4e-4 of the aux loss (measured):
    held to 1e-3."""
    arch = "granite-moe-1b-a400m"
    jcfg = jax_reduced(arch).replace(dtype="float32")
    tcfg = get_reduced_config(arch).replace(dtype="float32")
    oc = dict(lr=1e-3, warmup_steps=1, total_steps=6, eps=eps)
    jt = jtrainer.HeteroTrainer(
        jcfg, [jtrainer.GroupDef("accel", JDeviceKind.ACCEL, fixed_chunk=8,
                                 async_depth=2)],
        seq_len=SEQ, global_batch=16, oc=jopt.OptConfig(**oc), seed=0,
        repeat_data=True)
    tt = HeteroTrainer(
        tcfg, [GroupDef("accel", DeviceKind.ACCEL, device="cpu",
                        fixed_chunk=8, async_depth=2)],
        seq_len=SEQ, global_batch=16, oc=topt.OptConfig(**oc), seed=0,
        repeat_data=True,
        params=params_from_jax(tcfg, _np_tree(jt.params), "cpu"))
    batch = tt.data.batch(0, 16)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: _t(v) for k, v in batch.items()}
    aux_j_fn = jax.jit(lambda p: jstep.loss_fn(jcfg, p, jbatch)[1]
                       ["aux_loss"])
    losses = []
    for step in range(6):
        aux_j = float(aux_j_fn(jt.params))
        with torch.no_grad():
            aux_t = tstep.loss_fn(tcfg, tt.params, tbatch)[1]["aux_loss"]
        np.testing.assert_allclose(aux_t.item(), aux_j, rtol=tol,
                                   err_msg=f"aux loss, step {step}")
        rj, rt = jt.train_step(), tt.train_step()
        assert rt.examples == rj.examples == 16
        np.testing.assert_allclose(rt.loss, rj.loss, rtol=tol,
                                   err_msg=f"loss, step {step}")
        losses.append((rj.loss, rt.loss))
    assert losses[-1][0] < losses[0][0] and losses[-1][1] < losses[0][1]


@pytest.mark.parametrize("arch", FAMILIES)
def test_launcher_trains_each_family_on_the_cpu(arch):
    """``--device cpu --reduced --steps 3`` (bf16, the configs' dtype):
    three step lines, a finite final loss and the reference's JSON keys."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_launcher.main(["--arch", arch, "--reduced", "--steps", "3",
                             "--device", "cpu", "--global-batch", "8",
                             "--seq-len", "16"])
    lines = out.getvalue().splitlines()
    assert sum(line.startswith("step ") for line in lines) == 3
    report = json.loads(lines[-1])
    assert set(report) == {"wall_s", "final_loss", "energy_model_j", "edp"}
    assert np.isfinite(report["final_loss"])
