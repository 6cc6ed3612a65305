"""The paper's core in the port against the JAX package, on the CPU.

* the calibrated simulator (``core/platforms.py``, ``core/simulate.py``,
  copied): every configuration that ``tests/test_paper_claims.py`` runs
  gives the same ``SimResult``, field by field and exactly, and the 15
  claims of that file hold on the port's results;
* the Bulk-Oracle baseline (``core/oracle.py``): the same splits as the
  JAX package's over sleeping executors, its two repairs (ROADMAP C9, a
  split that leaves iterations to CPU groups that do not exist; C10, a
  sweep whose last split is not 100%), each shown against the reference,
  and a bulk run over the port engine's executors whose tokens equal the
  JAX bulk run's over the JAX engine's (reduced stablelm-1.6b in fp32,
  weights from the JAX package through ``repro_torch.bridge``).

``tests/test_properties.py::test_simulator_invariants`` fails in the
reference (priority is slower on EXYNOS 4+2, ROADMAP C); that invariant is
not asserted again here.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import repro.core as R
import test_paper_claims as claims
from repro.configs.registry import get_reduced_config as jax_reduced
from repro.core.dispatch import SleepExecutor as RSleep
from repro.core.oracle import BulkScheduler as RBulk
from repro.serve.engine import HeteroServeEngine as JaxServeEngine
from repro.train.trainer import GroupDef as JaxGroupDef
from repro_torch import core as T
from repro_torch.bridge import params_from_jax
from repro_torch.configs.registry import get_reduced_config
from repro_torch.core.dispatch import SleepExecutor as TSleep
from repro_torch.core.oracle import BulkScheduler as TBulk
from repro_torch.models import model as TM
from repro_torch.serve.engine import GroupDef, HeteroServeEngine

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ---------------------------------------------------------------------------
# the simulator
# ---------------------------------------------------------------------------

def _configs():
    """The keys and runs of test_paper_claims.py's ``sims`` fixture."""
    out = []
    for name, n_little in (("ivy", 0), ("haswell", 0), ("exynos", 4)):
        labels = ["3+1", "4+1"] + (["7+1", "8+1"] if n_little else [])
        for lbl in labels:
            out += [(name, "dyn", lbl), (name, "pri", lbl),
                    (name, "bulk", lbl)]
        out.append((name, "async", "4+1"))
    return out


CONFIGS = _configs()


def _sim(core, key):
    name, mode, lbl = key
    plat = core.PLATFORMS[name]
    if mode == "bulk":
        return core.bulk_oracle(plat, lbl)
    kw = {"dyn": {}, "pri": {"priority": True},
          "async": {"async_depth": 2}}[mode]
    return core.run_config(plat, lbl, **kw)


@pytest.fixture(scope="module")
def port_sims():
    return {key: _sim(T, key) for key in CONFIGS}


def _fields(res):
    return {"time_ms": res.time_ms,
            "energy": dataclasses.asdict(res.energy),
            "overheads": res.overheads,
            "per_device_items": res.per_device_items,
            "n_gpu_chunks": res.n_gpu_chunks,
            "config": dataclasses.asdict(res.config),
            "edp": res.edp, "as_dict": res.as_dict()}


@pytest.mark.parametrize("key", CONFIGS, ids="-".join)
def test_simulator_equals_the_reference_exactly(key, port_sims):
    ref, port = _fields(_sim(R, key)), _fields(port_sims[key])
    assert port == ref


def test_the_configurations_are_the_claims_fixtures():
    assert len(CONFIGS) == 27
    assert set(CONFIGS) == set(claims.sims.__wrapped__())


CLAIMS = sorted((name, fn) for name, fn in vars(claims).items()
                if name.startswith("test_") and callable(fn))


def test_every_claim_is_taken():
    assert len(CLAIMS) == 15


@pytest.mark.parametrize("claim", [fn for _, fn in CLAIMS],
                         ids=[name for name, _ in CLAIMS])
def test_paper_claim_holds_on_the_port(claim, port_sims):
    """The claim's own assertions (tests/test_paper_claims.py), on the
    port's simulator results."""
    claim(port_sims)


# ---------------------------------------------------------------------------
# Bulk-Oracle over sleeping executors
# ---------------------------------------------------------------------------

def _bulk(core_bulk, sleep, groups, n, rate=2e6):
    kinds = {"accel": "ACCEL", "cpu0": "BIG", "cpu1": "BIG"}
    mod = R if core_bulk is RBulk else T
    specs = {g: mod.GroupSpec(g, getattr(mod.DeviceKind, kinds[g]))
             for g in groups}
    return core_bulk(specs, {g: sleep(rate=rate) for g in groups})


def _covered(res):
    idx = [i for r in res.records for i in range(r.token.chunk.begin,
                                                 r.token.chunk.end)]
    return sorted(idx)


@pytest.mark.parametrize("frac", [0.0, 0.3, 0.5, 1.0])
def test_bulk_splits_equal_the_reference(frac):
    n, groups = 1000, ("accel", "cpu0", "cpu1")
    ref = _bulk(RBulk, RSleep, groups, n).run(0, n, frac)
    port = _bulk(TBulk, TSleep, groups, n).run(0, n, frac)
    for res in (ref, port):
        assert _covered(res) == list(range(n))
        assert res.per_group_items.get("accel", 0) == int(n * frac)
    assert port.per_group_items.get("accel", 0) \
        == ref.per_group_items.get("accel", 0)
    assert sum(v for g, v in port.per_group_items.items() if g != "accel") \
        == sum(v for g, v in ref.per_group_items.items() if g != "accel")
    assert port.frac == ref.frac == frac


@pytest.mark.parametrize("frac", [0.0, 0.5, 0.99])
def test_c9_bulk_without_cpu_groups_refuses_to_drop_work(frac):
    """The reference hands int(n*frac) iterations to the accelerator and
    leaves the rest to CPU groups that do not exist: they are never run,
    and the result reports no failure. The port raises."""
    n = 64
    ref = _bulk(RBulk, RSleep, ("accel",), n).run(0, n, frac)
    assert _covered(ref) == list(range(int(n * frac)))
    assert len(_covered(ref)) < n
    with pytest.raises(ValueError, match="non-accel groups"):
        _bulk(TBulk, TSleep, ("accel",), n).run(0, n, frac)
    full = _bulk(TBulk, TSleep, ("accel",), n).run(0, n, 1.0)
    assert _covered(full) == list(range(n))


def _sweep(core_bulk, sleep, n):
    sched = _bulk(core_bulk, sleep, ("accel", "cpu0"), n)
    runs = []
    run = sched.run

    def recording_run(*args):
        runs.append(run(*args))
        return runs[-1]

    sched.run = recording_run
    best = sched.oracle(0, n)
    assert any(r is best for r in runs)
    for r in runs:
        assert _covered(r) == list(range(n))
    return [r.per_group_items.get("accel", 0) for r in runs]


@pytest.mark.parametrize("n", [10, 64, 1000])
def test_c10_the_oracle_sweep_reaches_a_full_split(n):
    """The reference's ``f += step`` ends at 0.9999999999999999, so its
    "100%" run leaves one iteration to the CPU (63 / 1 at n = 64), and on
    the way it drifts below other splits too (0.7999999999999999: 799 of
    1000). The port sweeps k / 10: each split is int(n * k / 10), the last
    n / 0. At n = 64 the first ten splits are the reference's."""
    ref, port = _sweep(RBulk, RSleep, n), _sweep(TBulk, TSleep, n)
    f, accumulated = 0.0, []
    while f <= 1.0001:
        accumulated.append(int(n * f))
        f += 0.1
    assert ref == accumulated
    assert ref[-1] == n - 1
    assert port == [int(n * (k / 10)) for k in range(11)]
    assert port[-1] == n
    if n == 64:
        assert port == [0, 6, 12, 19, 25, 32, 38, 44, 51, 57, 64]
        assert port[:-1] == ref[:-1]


# ---------------------------------------------------------------------------
# Bulk-Oracle over the serving engines' executors
# ---------------------------------------------------------------------------

def _tokens(records):
    out = {}
    for rec in records:
        c = rec.token.chunk
        for i in range(c.size):
            out[c.begin + i] = rec.meta["result"]["tokens_out"][i]
    return out


def test_bulk_over_the_engine_executors_equals_the_jax_engine():
    """Reduced stablelm-1.6b in fp32 (2 layers), groups ``accel`` and
    ``cpu0`` both on the CPU, frac 0.5 of 8 requests (16 prompt + 4
    decode tokens): the accelerator's bulk chunk of 4 and the CPU's
    chunks of 1 through each engine's own executors. Greedy tokens are
    compared exactly, after checking along the port's greedy path that no
    top-two logits lie within 1e-4 of each other."""
    n, prompt_len, decode_tokens = 8, 16, 4
    cfg_j = jax_reduced("stablelm-1.6b").replace(n_layers=2, dtype="float32")
    cfg_t = get_reduced_config("stablelm-1.6b").replace(n_layers=2,
                                                        dtype="float32")
    jgroups = [JaxGroupDef("accel", R.DeviceKind.ACCEL),
               JaxGroupDef("cpu0", R.DeviceKind.BIG)]
    jeng = JaxServeEngine(cfg_j, jgroups, prompt_len=prompt_len,
                          decode_tokens=decode_tokens)
    jres = RBulk({g.name: R.GroupSpec(g.name, g.kind) for g in jgroups},
                 {g.name: jeng._executor_for(g) for g in jgroups}
                 ).run(0, n, 0.5)

    params = params_from_jax(cfg_t, jax.tree.map(np.asarray, jeng.params),
                             CPU)
    tgroups = [GroupDef("accel", T.DeviceKind.ACCEL, device=CPU),
               GroupDef("cpu0", T.DeviceKind.BIG, device=CPU)]
    teng = HeteroServeEngine(cfg_t, tgroups, prompt_len=prompt_len,
                             decode_tokens=decode_tokens, params=params)
    tres = TBulk({g.name: T.GroupSpec(g.name, g.kind) for g in tgroups},
                 {g.name: teng._executor_for(g) for g in tgroups}
                 ).run(0, n, 0.5)

    for res in (jres, tres):
        assert res.per_group_items == {"accel": 4, "cpu0": 4}
        assert _covered(res) == list(range(n))
    prompts = torch.from_numpy(np.stack([teng._prompt(i) for i in range(n)]))
    margins = []
    with torch.no_grad():
        logits, cache = TM.prefill(cfg_t, params, prompts,
                                   max_len=teng.max_len)
        for step in range(decode_tokens):
            top2 = logits[:, -1].topk(2, dim=-1).values
            margins.append((top2[:, 0] - top2[:, 1]).min().item())
            if step + 1 < decode_tokens:
                tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
                logits, cache = TM.decode_step(cfg_t, params, cache, tok)
    assert min(margins) > 1e-4, margins
    jt, tt = _tokens(jres.records), _tokens(tres.records)
    assert sorted(jt) == sorted(tt) == list(range(n))
    for i in range(n):
        np.testing.assert_array_equal(tt[i], jt[i])
