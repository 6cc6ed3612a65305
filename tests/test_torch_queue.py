"""The port's JAX-free front end against the reference, on the CPU.

Two kinds of test, no model anywhere:

* a drift guard: every module the port copies from a JAX-free module of
  the JAX package must have the same syntax tree as its original once
  ``repro.`` is rewritten to ``repro_torch.`` and docstrings are dropped;
* differential scenarios: the reference class and the port's class are
  driven with the same seeded inputs, and what a user sees (pop order,
  admission decisions, journal states, fault plans, placements, usage,
  window statistics) must be equal.

The reference properties that fail now and then (ROADMAP C: bounded load
balance, quantile-in-bucket, window quantile <= max) are not asserted
again here.
"""
import ast
import dataclasses
import json
import random
import re
from enum import Enum
from pathlib import Path

import pytest
import torch

import repro.chaos as R_chaos
import repro.core as R_core
import repro.core.energy as R_energy
import repro.core.overheads as R_overheads
import repro.core.scheduler as R_scheduler
import repro.core.throughput as R_throughput
import repro.core.types as R_types
import repro.federation as R_fed
import repro.policy as R_policy
import repro.queue as R_queue
import repro.tenancy as R_tenancy
import repro_torch.chaos as T_chaos
import repro_torch.core as T_core
import repro_torch.core.energy as T_energy
import repro_torch.core.overheads as T_overheads
import repro_torch.core.scheduler as T_scheduler
import repro_torch.core.throughput as T_throughput
import repro_torch.core.types as T_types
import repro_torch.federation as T_fed
import repro_torch.policy as T_policy
import repro_torch.queue as T_queue
import repro_torch.tenancy as T_tenancy

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"

COPIED = sorted(
    [f"core/{m}.py" for m in ("types", "locks", "overheads", "throughput",
                              "partitioner", "scheduler", "energy")]
    + [f"telemetry/{m}.py" for m in ("__init__", "registry", "spans",
                                     "exporters")]
    + [str(p.relative_to(REF)) for pkg in ("queue", "tenancy", "policy",
                                           "runtime", "chaos", "federation")
       for p in (REF / pkg).glob("*.py")])
#: copies that must differ from their original, with the reason
DIFFER = {
    "core/scheduler.py":
        "an open epoch a dispatcher jumps past (priority routing) is "
        "finalized once every dispatcher is past it; the reference never "
        "re-checks it, and its batch hangs "
        "(test_epoch_passed_by_a_priority_jump_finalizes)",
    "queue/service.py":
        "deferred jobs being re-offered are counted (_retrying) so an idle "
        "check from another thread does not see them vanish "
        "(test_federation_is_not_idle_while_deferred_jobs_are_reoffered)",
    "federation/service.py":
        "the same for the federation's own deferred pool, and _idle reads "
        "both counts (the reference reports drained with a job pending)",
}


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


# ---------------------------------------------------------------------------
# drift guard
# ---------------------------------------------------------------------------

def _rewrite(src: str) -> str:
    return re.sub(r"\brepro(?=\.|\s+import\b)", "repro_torch", src)


def _without_docstrings(tree: ast.AST) -> ast.AST:
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                             ast.AsyncFunctionDef)) and node.body \
                and isinstance(node.body[0], ast.Expr) \
                and isinstance(node.body[0].value, ast.Constant) \
                and isinstance(node.body[0].value.value, str):
            node.body = node.body[1:] or [ast.Pass()]
    return tree


def _dump(src: str) -> str:
    return ast.dump(_without_docstrings(ast.parse(src)))


def test_every_copied_package_is_covered():
    assert len(COPIED) >= 35
    for pkg in ("queue", "tenancy", "policy", "runtime", "chaos",
                "federation", "telemetry"):
        assert (PORT / pkg / "__init__.py").exists()
        assert {p.name for p in (PORT / pkg).glob("*.py")} \
            == {p.name for p in (REF / pkg).glob("*.py")}, pkg


@pytest.mark.parametrize("rel", COPIED)
def test_copy_has_not_drifted_from_the_reference(rel):
    ref = _dump(_rewrite((REF / rel).read_text()))
    port = _dump((PORT / rel).read_text())
    if rel in DIFFER:
        assert ref != port, f"{rel} no longer differs: {DIFFER[rel]}"
    else:
        assert ref == port, f"src/repro_torch/{rel} drifted from " \
                            f"src/repro/{rel}"


def test_the_drift_guard_sees_a_change():
    src = (REF / "queue" / "manager.py").read_text()
    ref = _dump(_rewrite(src))
    assert _dump(_rewrite(src).replace("heapq.heappush", "heapq.heappop",
                                       1)) != ref
    # a docstring edit is not drift
    assert _dump(_rewrite(src).replace('"""', '"""Edited. ', 1)) == ref


# ---------------------------------------------------------------------------
# differential scenarios
# ---------------------------------------------------------------------------

def _plain(x):
    """Enums of either package as their values, dataclasses as dicts, so
    results of the two packages compare."""
    if isinstance(x, Enum):
        return x.value
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: _plain(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_plain(v) for v in x]
    return x


def _job_specs(seed, n, tenants=("default",)):
    rng = random.Random(seed)
    return [dict(items=rng.randint(1, 9), priority=rng.randint(0, 4),
                 tier=rng.choice(R_types.TIERS),
                 tenant=rng.choice(tenants), job_id=f"j{i:03d}")
            for i in range(n)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_queue_manager_pop_order(seed):
    order = []
    for Q in (R_queue, T_queue):
        qm = Q.QueueManager()
        for spec in _job_specs(seed, 40):
            qm.put(Q.Job(**spec))
        got = [qm.pop().job_id for _ in range(5)]
        got += [j.job_id for j in qm.pop_express(4)]
        got += [j.job_id for j in qm.pop_many(50)]
        assert qm.pop() is None
        order.append(got)
    assert order[0] == order[1]
    assert sorted(order[1]) == [f"j{i:03d}" for i in range(40)]


@pytest.mark.parametrize("quantum", [1, 8, 64])
def test_sharded_queue_dwrr_pop_sequence(quantum):
    spec = "gold:weight=10,silver:weight=3,free:weight=1:quota=4"
    seqs = []
    for Q, Tn in ((R_queue, R_tenancy), (T_queue, T_tenancy)):
        reg = Tn.TenantRegistry.parse(spec)
        sq = Tn.ShardedQueueManager(reg, quantum=quantum)
        for s in _job_specs(quantum, 60, ("gold", "silver", "free")):
            sq.put(Q.Job(**s))
        got, held = [], []
        while True:
            batch = sq.pop_many(7)
            if not batch and not held:
                break
            got.append([(j.tenant, j.job_id) for j in batch])
            for j in batch:
                sq.mark_running(j)
            for j in held + batch[::2]:  # half a batch finishes a round
                sq.mark_finished(j, Q.JobState.DONE)   # later (quota)
            held = batch[1::2]
        seqs.append(got)
    assert seqs[0] == seqs[1]
    assert sum(len(b) for b in seqs[1]) == 60


@pytest.mark.parametrize("tenants", [None, "a:weight=3:quota=6:slo=0.5,"
                                           "b:weight=1:slo=2.0"])
def test_admission_decisions(tenants):
    runs = []
    for Q, Tn, Th, Ov in ((R_queue, R_tenancy, R_throughput, R_overheads),
                          (T_queue, T_tenancy, T_throughput, T_overheads)):
        reg = Tn.TenantRegistry.parse(tenants) if tenants else None
        queue = Tn.ShardedQueueManager(reg) if reg else Q.QueueManager()
        tracker = Th.ThroughputTracker(0.5)
        tracker.seed("accel", 40.0)
        tracker.seed("cpu0", 10.0)
        adm = Q.AdmissionController(queue, tracker, Ov.OverheadLedger(),
                                    slo_delay_s=1.0, registry=reg,
                                    clock=lambda: 1000.0)
        adm.on_group_join("accel", 40.0)
        adm.on_group_join("cpu0", 10.0)
        adm.update_stragglers({"cpu0": 2.0})
        names = tuple(reg.names()) if reg else ("default",)
        out = []
        for i, s in enumerate(_job_specs(7, 80, names)):
            out.append(_plain(adm.admit(Q.Job(**s))))
            if i % 9 == 8:              # some work drains between arrivals
                for j in queue.pop_many(3):
                    queue.mark_running(j)
                    queue.mark_finished(j, Q.JobState.DONE)
        runs.append((out, adm.admitted, adm.deferred, adm.rejected,
                     dict(adm.per_tenant)))
    assert runs[0] == runs[1]
    assert runs[1][1] > 0 and runs[1][2] + runs[1][3] > 0


def _journal_writes(Q, path):
    """Jobs through every lifecycle edge, journaled."""
    store = Q.JournalStore(str(path))
    jobs = [Q.Job(**s) for s in _job_specs(3, 12)]
    S = Q.JobState
    for i, j in enumerate(jobs):
        store.record(j)
        if i % 6 == 5:
            j.transition(S.CANCELLED)
            store.record(j)
            continue
        j.transition(S.ADMITTED)
        store.record(j)
        if i % 6 == 4:
            continue                    # still queued at the "crash"
        j.transition(S.RUNNING)
        store.record(j)
        if i % 6 == 3:
            continue                    # in flight at the "crash"
        if i % 6 == 2:
            j.transition(S.REQUEUED)
            store.record(j)
            j.transition(S.ADMITTED)
            store.record(j)
            j.transition(S.RUNNING)
            store.record(j)
        j.transition(S.FAILED if i % 6 == 1 and i > 6 else S.DONE)
        store.record(j)
    store.close()


def _journal_view(Q, path):
    final = {k: _plain(v.state) for k, v in Q.JournalStore.replay(
        str(path)).items()}
    requeue, done = Q.JournalStore.recover(str(path))
    return (final, sorted((j.job_id, _plain(j.state), j.attempts)
                          for j in requeue),
            sorted((k, _plain(v.state)) for k, v in done.items()))


@pytest.mark.parametrize("writer", ["port", "reference"])
def test_journal_written_by_one_package_reads_the_same_in_both(writer,
                                                               tmp_path):
    path = tmp_path / "journal.jsonl"
    _journal_writes(T_queue if writer == "port" else R_queue, path)
    ref, port = _journal_view(R_queue, path), _journal_view(T_queue, path)
    assert ref == port
    assert set(ref[0].values()) >= {"done", "cancelled", "admitted",
                                     "running"}
    assert ref[1]                       # something to requeue


@pytest.mark.parametrize("seed", [0, 1, 7, 1234])
def test_fault_plan_bytes(seed):
    rids = ["r0", "r1", "r2"]
    groups = [f"{r}/{g}" for r in rids for g in ("accel", "cpu0")]
    a = R_chaos.FaultPlan.generate(seed, 3.0, rids, groups).to_json()
    b = T_chaos.FaultPlan.generate(seed, 3.0, rids, groups).to_json()
    assert a == b
    assert T_chaos.FaultPlan.from_json(a).to_json() == a
    assert json.loads(a)["events"]


def test_router_placement_of_200_keys():
    placed = []
    for F in (R_fed, T_fed):
        router = F.Router(["r0", "r1", "r2", "r3"], vnodes=32, bound=1.25)
        router.set_capacity("r3", 2.0)
        keys = [f"tenant-{i}" for i in range(200)]
        first = router.place_many(keys)
        router.remove_runtime("r1")
        second = {k: router.place(k) for k in keys}
        placed.append((first, second))
    assert placed[0] == placed[1]
    assert set(placed[1][0].values()) == {"r0", "r1", "r2", "r3"}


def _schedule_result(S, Ty, busy, total_time):
    records, pos = [], 0
    for g, b in busy.items():
        tok = Ty.Token(Ty.Chunk(pos, pos + 10, pos), g, Ty.DeviceKind.BIG)
        records.append(Ty.ChunkRecord(tok, tc1=0.0, tc2=0.0, tc3=b,
                                      tg1=0.0, tg5=b))
        pos += 10
    return S.ScheduleResult(total_time=total_time, iterations=pos,
                            records=records, overheads={}, throughput={},
                            per_group_items={g: 10 for g in busy})


def test_tenant_accountant_snapshot_under_one_energy_model():
    snaps = []
    for Q, Tn, E, S, Ty in (
            (R_queue, R_tenancy, R_energy, R_scheduler, R_types),
            (T_queue, T_tenancy, T_energy, T_scheduler, T_types)):
        reg = Tn.TenantRegistry.parse("a:weight=2:energy=30,b:weight=1")
        em = E.EnergyModel({"accel": E.PowerSpec(active_w=700.0,
                                                 idle_w=40.0),
                            "cpu0": E.PowerSpec(active_w=65.0,
                                                idle_w=5.0)})
        acct = Tn.TenantAccountant(reg, energy_model=em)
        rng = random.Random(5)
        t = 0.0
        for _ in range(12):
            jobs = [Q.Job(items=rng.randint(1, 8), tenant=rng.choice("ab"))
                    for _ in range(rng.randint(1, 5))]
            busy = {"accel": rng.uniform(0.01, 0.2),
                    "cpu0": rng.uniform(0.0, 0.4)}
            res = _schedule_result(S, Ty, busy, rng.uniform(0.1, 0.5))
            start = t - rng.uniform(0.0, 0.1)
            t += res.total_time
            acct.record_batch(jobs, res, window=(start, t))
            for j in jobs:
                acct.record_queue_delay(j.tenant, rng.uniform(0.0, 2.0))
        snaps.append((acct.snapshot(), acct.derate_weights()))
    assert snaps[0] == snaps[1]
    assert snaps[1][0]["a"]["energy_j"] > 0 and snaps[1][0]["b"]["edp"] > 0


def test_sliding_window_statistics():
    outs = []
    for P in (R_policy, T_policy):
        w = P.SlidingWindow(horizon_s=2.0, alpha=0.4, max_samples=64)
        rng = random.Random(11)
        t, rows = 0.0, []
        for _ in range(300):
            t += rng.expovariate(20.0)
            w.observe(t, rng.lognormvariate(0.0, 1.0))
            rows.append((w.count, w.ewma, w.last, w.mean(t), w.min(t),
                         w.max(t), w.median(t), w.quantile(0.9, t),
                         w.span(t), w.slope(t)))
        outs.append(rows)
    assert outs[0] == outs[1]


def test_adaptive_policy_decisions():
    outs = []
    for P in (R_policy, T_policy):
        p = P.AdaptivePolicy(window_s=1.0, spike_threshold=2.0,
                             cooldown_s=0.5, alpha=0.5, min_samples=3,
                             lead_s=0.2)
        rng = random.Random(13)
        t, rows = 0.0, []
        for i in range(400):
            t += rng.expovariate(50.0)
            point = rng.lognormvariate(-1.0, 0.8) * (6.0 if i % 50 == 49
                                                     else 1.0)
            est = p.admission_delay(t, point, slo=0.8,
                                    key=("*", "a", "b")[i % 3])
            allow = p.allow_rebalance(
                t, {"cpu0": 1.0 + rng.choice([0.0, 0.01, 0.3])}, {})
            rows.append((est, allow))
        outs.append((rows, p.stats()))
    assert outs[0] == outs[1]
    assert outs[1][1]["spikes"] > 0 and outs[1][1]["rebalances"] > 0


# ---------------------------------------------------------------------------
# faults of the reference that the port repairs (ROADMAP C)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["reference", "port"])
def test_epoch_passed_by_a_priority_jump_finalizes(pkg):
    """Two dispatchers, driven by hand through the scheduler's own
    protocol (no threads). A takes all of epoch 0, B moves on to epoch 1;
    A requeues a chunk into epoch 0, leaves, and revisits it; B finishes
    epoch 1 and leaves it while A is still behind; A finishes epoch 0 and
    jumps to epoch 2, the best open epoch with work, past epoch 1. Every
    dispatcher is now past epoch 1 and its work is done. The port
    finalizes it; the reference never looks at it again, so its batch
    waits forever (the hang found in the queued and federated drills)."""
    C, Ty = (R_core, R_types) if pkg == "reference" else (T_core, T_types)
    groups = {g: Ty.GroupSpec(g, Ty.DeviceKind.BIG) for g in ("a", "b")}
    execs = {g: C.SleepExecutor(rate=1e9) for g in groups}
    sched = C.DynamicScheduler(groups, execs, telemetry=False)
    sched._spawn_locked = lambda name, idx: sched._worker_pos.__setitem__(
        name, idx)                      # dispatchers stepped by hand
    e0, e1 = sched.submit_epoch((0, 8)), sched.submit_epoch((0, 8))
    part = sched.partitioner

    def take_all(name, epoch):
        toks = []
        while (t := part.next_token(name, epoch.space)) is not None:
            toks.append(t)
        return toks

    assert sched._await_epoch("a", 0) is e0
    taken = take_all("a", e0)
    assert sched._await_epoch("b", 0) is e1
    part.requeue(taken[-1].chunk, e0.space)
    sched._leave_epoch("a", e0)
    assert sched._await_epoch("a", 1) is e0      # revisit: work again
    take_all("b", e1)
    sched._leave_epoch("b", e1)
    e2 = sched.submit_epoch((0, 8))
    take_all("a", e0)
    sched._leave_epoch("a", e0)
    assert e0.finalized
    assert sched._await_epoch("a", 1) is e2      # the jump past epoch 1
    assert all(pos > e1.index for pos in sched._worker_pos.values())
    assert e1.space.remaining == 0 and not part.has_work(e1.space)
    assert e1.finalized == (pkg == "port")


@pytest.mark.parametrize("pkg", ["reference", "port"])
@pytest.mark.parametrize("pool", ["federation", "runtime"])
def test_federation_is_not_idle_while_deferred_jobs_are_reoffered(
        pkg, pool, tmp_path):
    """A deferred job is taken out of its pool (the federation's, or a
    runtime's) and re-offered; at that moment it is in no pool and no
    queue. The federation's idle check, asked then from another thread,
    must still say "not idle". The reference says idle, so a federated
    run can report drained with that job still pending and its results
    lost (seen in the kill drill)."""
    Q, Tn, F = (R_queue, R_tenancy, R_fed) if pkg == "reference" \
        else (T_queue, T_tenancy, T_fed)
    reg = Tn.TenantRegistry.parse("a:weight=1")

    def make_service(rid, journal, telemetry):
        queue = Q.QueueManager()
        adm = Q.AdmissionController(queue, slo_delay_s=float("inf"),
                                    telemetry=False)
        return Q.JobService(lambda: None, queue=queue, admission=adm,
                            journal=journal, telemetry=False)

    fed = F.FederatedService(make_service, ["r0"], str(tmp_path),
                             tenants=reg, telemetry=False)
    node = fed.nodes()["r0"]
    job = Q.Job(items=1, tenant="a")
    seen = []
    if pool == "federation":
        fed._deferred.append(job)
        submit = fed.submit
        fed.submit = lambda j: (seen.append(fed._idle()), submit(j))[1]
        fed.retry_deferred()
    else:
        node.service._deferred.append(job)
        admit = node.service.admission.admit
        node.service.admission.admit = lambda j: (seen.append(fed._idle()),
                                                  admit(j))[1]
        node.service.retry_deferred()
    assert seen == [pkg == "reference"]
    assert job.state == Q.JobState.ADMITTED and not fed._idle()
    fed.close()
