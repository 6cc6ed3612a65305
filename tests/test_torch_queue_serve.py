"""The port's queued and federated serving paths on the CPU, against the
JAX engine and launcher.

Tiny fp32 stablelm-1.6b (reduced, 2 layers, prompts of 8 tokens and 2
decode tokens); the port's weights are the JAX engine's, carried across
by ``repro_torch.bridge.params_from_jax``. Run time is a few seconds of
model work: the JAX engine compiles one prefill/decode pair per batch
bucket.
"""
import io
import json
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_reduced_config as jax_reduced
from repro.core.types import TIERS
from repro.core.types import DeviceKind as JaxDeviceKind
from repro.launch import serve as jax_cli
from repro.queue import Job as JaxJob
from repro.queue import JobState as JaxJobState
from repro.queue import JournalStore as JaxJournalStore
from repro.serve.engine import HeteroServeEngine as JaxServeEngine
from repro.tenancy import TenantRegistry as JaxTenantRegistry
from repro.train.trainer import GroupDef as JaxGroupDef
from repro_torch import telemetry as telemetry_mod
from repro_torch.bridge import params_from_jax
from repro_torch.configs.registry import get_reduced_config
from repro_torch.core import DeviceKind
from repro_torch.core.energy import EnergyModel, PowerSpec
from repro_torch.launch import serve as torch_cli
from repro_torch.queue import Job, JobState, JournalStore
from repro_torch.serve.engine import (FederatedServeReport, GroupDef,
                                      HeteroServeEngine, QueueServeReport)
from repro_torch.tenancy import TenantRegistry

CPU = torch.device("cpu")
TENANTS = "gold:weight=10,free:weight=1:quota=8"
PROMPT, DECODE = 8, 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(scope="module")
def engines():
    cfg_j = jax_reduced("stablelm-1.6b").replace(n_layers=2, dtype="float32")
    cfg_t = get_reduced_config("stablelm-1.6b").replace(n_layers=2,
                                                        dtype="float32")
    # cpu0 dies on its first chunk in both engines: the scheduler requeues
    # its work onto accel, and the group stays dead for the session
    jeng = JaxServeEngine(
        cfg_j, [JaxGroupDef("accel", JaxDeviceKind.ACCEL, fixed_chunk=4,
                            async_depth=2),
                JaxGroupDef("cpu0", JaxDeviceKind.BIG, fail_after_chunks=0)],
        prompt_len=PROMPT, decode_tokens=DECODE)
    params = params_from_jax(cfg_t, jax.tree.map(np.asarray, jeng.params),
                             CPU)
    teng = HeteroServeEngine(
        cfg_t, [GroupDef("accel", DeviceKind.ACCEL, device=CPU,
                         fixed_chunk=4, async_depth=2),
                GroupDef("cpu0", DeviceKind.BIG, device=CPU,
                         fail_after_chunks=0)],
        prompt_len=PROMPT, decode_tokens=DECODE, params=params)
    return jeng, teng, cfg_t, params


def _jobs(JobCls, names, n=24):
    return [JobCls(items=1 + i % 2, priority=i % 3,
                   tier=TIERS[i % len(TIERS)], tenant=names[i % len(names)])
            for i in range(n)]


def test_serve_jobs_matches_the_jax_engine(engines, tmp_path):
    """The same jobs, tenants, journal and dying group through both
    engines: the same outcome, and both journals replay to DONE."""
    jeng, teng, _, _ = engines
    reports, journals = [], []
    for eng, JobCls, Reg, tag in ((jeng, JaxJob, JaxTenantRegistry, "jax"),
                                  (teng, Job, TenantRegistry, "torch")):
        reg = Reg.parse(TENANTS)
        path = str(tmp_path / f"{tag}.journal.jsonl")
        jobs = _jobs(JobCls, reg.names())
        rep = eng.serve_jobs(jobs, batch_jobs=6, journal_path=path,
                             tenants=reg, timeout_s=120.0)
        reports.append(rep)
        journals.append((path, jobs))
    jrep, trep = reports
    assert isinstance(trep, QueueServeReport)
    assert trep.drained and jrep.drained
    for key in ("jobs", "done", "failed", "cancelled", "new_tokens",
                "dead_groups"):
        assert getattr(trep, key) == getattr(jrep, key), key
    assert trep.done == 24 and trep.dead_groups == ["cpu0"]
    assert {t: u["items"] for t, u in trep.per_tenant.items()} \
        == {t: u["items"] for t, u in jrep.per_tenant.items()}
    assert sum(u["items"] for u in trep.per_tenant.values()) == 36
    qd = trep.queue_delay
    assert 0.0 <= qd["p50"] <= qd["p95"] <= qd["p99"]
    for (path, jobs), Store, done in ((journals[0], JaxJournalStore,
                                       JaxJobState.DONE),
                                      (journals[1], JournalStore,
                                       JobState.DONE)):
        final = Store.replay(path)
        assert len(final) == 24
        assert all(final[j.job_id].state == done for j in jobs)
        assert Store.recover(path)[0] == []


def test_serve_jobs_energy_per_tenant(engines):
    """With an energy model every tenant is billed: joules > 0 and EDP =
    joules x attributed wall seconds."""
    _, teng, _, _ = engines
    reg = TenantRegistry.parse(TENANTS)
    em = EnergyModel({"accel": PowerSpec(active_w=700.0, idle_w=0.0),
                      "cpu0": PowerSpec(active_w=65.0, idle_w=0.0)})
    rep = teng.serve_jobs(_jobs(Job, reg.names(), 12), batch_jobs=4,
                          tenants=reg, energy_model=em, timeout_s=120.0)
    assert rep.done == 12
    for u in rep.per_tenant.values():
        assert u["energy_j"] > 0.0
        assert u["edp"] == pytest.approx(u["energy_j"] * u["wall_s"])


@pytest.fixture(scope="module")
def fed_engine(engines):
    """Two groups a runtime, both live: the drills below kill runtimes
    and inject faults, not group deaths."""
    _, _, cfg, params = engines
    return HeteroServeEngine(
        cfg, [GroupDef("accel", DeviceKind.ACCEL, device=CPU, fixed_chunk=4,
                       async_depth=2),
              GroupDef("cpu0", DeviceKind.BIG, device=CPU)],
        prompt_len=PROMPT, decode_tokens=DECODE, params=params,
        telemetry=telemetry_mod.Telemetry())


@pytest.mark.parametrize("drill", ["kill", "chaos"])
def test_serve_jobs_federated_drills(fed_engine, tmp_path, drill):
    """Two runtimes. ``kill``: r1 crashes at half the jobs and its
    journal fails over to r0 (one failover, every job done). ``chaos``:
    the seeded plan of seed 2 over 0.3 s (a chunk exception on r1/accel
    at 27 ms): it fires, r1/accel dies, and every job reaches a terminal
    state."""
    reg = TenantRegistry.parse(TENANTS)
    jobs = _jobs(Job, reg.names(), 32)
    kw = dict(kill_runtime=1, kill_after_frac=0.5) if drill == "kill" \
        else dict(chaos_seed=2, chaos_horizon_s=0.3)
    before = fed_engine.telemetry.registry.snapshot()["counters"]
    rep = fed_engine.serve_jobs_federated(
        jobs, runtimes=2, batch_jobs=4, journal_dir=str(tmp_path),
        tenants=reg, timeout_s=120.0, **kw)
    assert isinstance(rep, FederatedServeReport)
    fed = rep.fed
    assert rep.drained and fed.runtimes == 2 and fed.jobs == 32
    assert fed.done + fed.failed + fed.cancelled == 32
    if drill == "kill":
        assert fed.failovers == 1 and fed.killed == ["r1"]
        assert fed.alive == 1 and fed.done == 32
        assert sum(fed.per_tenant_items.values()) == 48
    assert rep.new_tokens == sum(fed.per_tenant_items.values()) * DECODE
    if drill == "chaos":
        after = fed_engine.telemetry.registry.snapshot()["counters"]
        key = 'chaos.injected{kind="chunk_exception",layer="executor"}'
        assert after.get(key, 0) > before.get(key, 0)


# ---------------------------------------------------------------------------
# the launcher against the reference's
# ---------------------------------------------------------------------------

COMMON = ["--arch", "stablelm-1.6b", "--reduced", "--prompt-len", "8",
          "--decode-tokens", "2", "--requests", "12"]
RUNS = {
    "tenants": ["--queue", "--tenants", TENANTS, "--power",
                "accel=700:0,cpu0=65:10", "--groups",
                "accel:chunk=4:async=2,cpu0", "--priority", "mix"],
    "federated": ["--queue", "--runtimes", "2", "--kill-runtime", "1",
                  "--groups", "accel:chunk=4:async=2",
                  "--tenants", TENANTS],
}


def _keys(d, prefix=""):
    out = set()
    for k, v in d.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("per_group", "per_runtime"):
            out |= _keys(v, prefix + k + ".")
    return out


def _run_torch_cli(argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        torch_cli.main(argv + ["--device", "cpu"])
    return json.loads(buf.getvalue())


def _run_jax_cli(monkeypatch, argv):
    monkeypatch.setattr("sys.argv", ["serve"] + argv)
    buf = io.StringIO()
    with redirect_stdout(buf):
        jax_cli.main()
    return json.loads(buf.getvalue())


@pytest.mark.parametrize("run", sorted(RUNS))
def test_launcher_prints_the_reference_keys(run, monkeypatch):
    argv = COMMON + RUNS[run]
    port = _run_torch_cli(argv)
    ref = _run_jax_cli(monkeypatch, argv)
    assert _keys(port) == _keys(ref)
    if run == "federated":
        assert port["failovers"] == 1 and port["done"] == 12
        assert port["drained"] is True
    else:
        assert port["done"] == 12 and set(port["per_tenant"]) \
            == {"gold", "free"}


def test_launcher_runs_three_runtimes_with_a_kill():
    out = _run_torch_cli(COMMON + ["--queue", "--runtimes", "3",
                                   "--kill-runtime", "1", "--groups",
                                   "accel:chunk=4:async=2"])
    assert out["runtimes"] == 3 and out["alive"] == 2
    assert out["failovers"] == 1 and out["done"] == 12


REFUSALS = {
    "runtimes<1": ["--runtimes", "0"],
    "runtimes-without-queue": ["--runtimes", "2"],
    "kill-out-of-range": ["--queue", "--runtimes", "2", "--kill-runtime",
                          "2"],
    "chaos-seed-and-plan": ["--queue", "--runtimes", "2", "--chaos-seed",
                            "0", "--chaos-plan", "{}"],
    "chaos-one-runtime": ["--queue", "--chaos-seed", "0"],
    "job-items<1": ["--queue", "--job-items", "0"],
    "deadline<=0": ["--queue", "--deadline-ms", "0"],
    "requests<1": ["--requests", "0"],
    "tenants-without-queue": ["--tenants", TENANTS],
    "tenants-and-file": ["--queue", "--tenants", TENANTS, "--tenants-file",
                         "x.json"],
    "bad-tenant-spec": ["--queue", "--tenants", "gold:weight=abc"],
    "no-tenants": ["--queue", "--tenants-file", "{empty}"],
    "power-without-tenants": ["--queue", "--power", "accel=1:0"],
    "bad-power": ["--queue", "--tenants", TENANTS, "--power", "accel=x"],
    "power-groups": ["--queue", "--tenants", TENANTS, "--power",
                     "accel=1:0,gpu9=2:0"],
    "sample-rate": ["--sample-rate", "1.5"],
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_launcher_refuses_what_the_reference_refuses(case, monkeypatch,
                                                     tmp_path, capsys):
    empty = tmp_path / "empty.json"
    empty.write_text("[]")
    argv = ["--arch", "stablelm-1.6b", "--reduced"] + [
        str(empty) if a == "{empty}" else a for a in REFUSALS[case]]
    errors = []
    for run in (lambda: torch_cli.main(argv + ["--device", "cpu"]),
                lambda: (monkeypatch.setattr("sys.argv", ["serve"] + argv),
                         jax_cli.main())):
        with pytest.raises(SystemExit) as exc:
            run()
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1]
                      .split("error: ", 1)[1])
    assert errors[0] == errors[1]
