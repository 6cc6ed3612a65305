"""FederatedService: N JobService runtimes behind one submit/serve front.

The single-runtime stack (admission → DWRR shards → persistent scheduler
runtime) scales one process on one chip; this tier federates N of them —
in-process simulated "hosts", each with its own scheduler runtime,
tenancy shards, and journal — behind the existing submit interface:

  * routing — jobs place by tenant consistent-hashing with bounded loads
    (``Router``), corrected by live per-runtime capacity gossiped from
    each runtime's λ-trackers (``GossipBus``, stale-derated), so a hot
    tenant sticks to a home runtime until it is genuinely overloaded,
    then spills deterministically;
  * replication — each runtime's journal mirrors to a ring peer
    (``ReplicationRing``); ``kill_runtime`` replays the victim's replica
    through a survivor's ``JobService.recover``, requeueing 100 % of its
    in-flight/queued jobs with tier/deadline metadata intact;
  * global contracts — tenant in-flight quotas and energy budgets are
    enforced against the *fleet-wide* gossip aggregate, so a tenant
    cannot multiply its quota by the number of runtimes.

The host-side overheads the paper measures per chunk reappear here one
level up as routing/gossip/handoff overheads per job; the federation
metrics (``fed.*``) make them observable the same way.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, field, replace
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch import telemetry as telemetry_mod
from repro_torch.chaos.injector import ChaosInjector, ChaosSink
from repro_torch.federation.gossip import GossipBus, Heartbeat
from repro_torch.federation.replication import ReplicaSink, ReplicationRing
from repro_torch.federation.router import Router
from repro_torch.queue.admission import AdmissionDecision, Decision
from repro_torch.queue.job import Job, JobState
from repro_torch.queue.journal import JournalStore, _entry_line

clock = time.monotonic


@dataclass
class RuntimeNode:
    """One federated runtime: its service, journal, and the mirror sink
    feeding its ring peer's replica of this journal."""
    runtime_id: str
    service: JobService
    journal: JournalStore
    sink: ReplicaSink
    alive: bool = True
    # submissions routed here since the last gossip round — the router's
    # load view and the global-quota gate must see them before the next
    # heartbeat does (reset when the heartbeat captures the queue state)
    routed_items: float = 0.0
    pending_jobs: Dict[str, int] = field(default_factory=dict)


@dataclass
class FederationReport:
    runtimes: int
    alive: int
    jobs: int
    done: int
    failed: int
    cancelled: int
    requeues: int
    recovered: int
    failovers: int
    gossip_rounds: int
    time_s: float = 0.0
    killed: List[str] = field(default_factory=list)
    per_runtime: Dict[str, Dict[str, float]] = field(default_factory=dict)
    per_tenant_items: Dict[str, int] = field(default_factory=dict)


class FederatedService:
    def __init__(self,
                 make_service: Callable[..., JobService],
                 runtime_ids: Sequence[str],
                 journal_dir: str,
                 tenants=None,
                 telemetry=None,
                 heartbeat_s: float = 0.2,
                 stale_after_s: Optional[float] = None,
                 bound: float = 1.25,
                 vnodes: int = 64,
                 max_deferred: int = 10_000,
                 spread_after: int = 32,
                 auto_compact_lines: Optional[int] = None,
                 chaos: Optional[ChaosInjector] = None):
        """``make_service(runtime_id, journal, telemetry) -> JobService``
        builds one runtime (scheduler factory, queue, admission wired by
        the caller); the federation owns journals + replication + the
        per-runtime telemetry namespace. ``tenants`` is a duck-typed
        TenantRegistry enabling the global quota / energy-budget tier.
        ``chaos`` attaches a fault-injection plane (repro_torch.chaos): journal
        write filters, mirror-failure sinks, gossip drop/delay/partition,
        and plan-scheduled runtime kills, all executed here."""
        if not runtime_ids:
            raise ValueError("federation needs at least one runtime")
        self.tenants = tenants
        self.heartbeat_s = max(1e-3, float(heartbeat_s))
        self.max_deferred = max_deferred
        # hot-tenant fan-out threshold (jobs): a tenant whose fleet-wide
        # unfinished count exceeds k × spread_after routes over k+1
        # virtual ring keys, up to the live-runtime count (0 disables)
        self.spread_after = max(0, int(spread_after))
        self.telemetry = telemetry_mod.resolve(telemetry)
        self.ring = ReplicationRing(runtime_ids, journal_dir)
        self.bus = GossipBus(
            stale_after_s=stale_after_s if stale_after_s is not None
            else max(4 * self.heartbeat_s, 0.5))
        self.router = Router(vnodes=vnodes, bound=bound)
        self._lock = threading.Lock()
        self._jobs: Dict[str, Job] = {}       # latest materialization
        self._placement: Dict[str, str] = {}  # job_id -> runtime_id
        self._deferred: List[Job] = []        # blocked on GLOBAL quota
        # deferred jobs taken out by retry_deferred and not yet re-routed
        # (in neither the pool nor a runtime): _idle counts them
        self._retrying = 0
        self._tenant_seq: Dict[str, int] = {}  # fan-out round-robin
        self._killed: List[str] = []
        self.recovered = 0
        self.quota_defers = 0
        self._started = False
        self._stop_evt = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self._t0: Optional[float] = None
        self._chaos = chaos
        # kill_runtime is serialized: two concurrent kills may otherwise
        # each pick the other as survivor mid-crash and replay into a
        # runtime that is already dying, losing the replayed jobs
        self._kill_lock = threading.Lock()

        self._nodes: Dict[str, RuntimeNode] = {}
        for rid in runtime_ids:
            journal = JournalStore(
                self.ring.journal_path(rid),
                auto_compact_lines=auto_compact_lines,
                write_filter=chaos.journal_write_filter(rid)
                if chaos is not None else None)
            sink = self._wrap_sink(self.ring.make_sink(rid), rid)
            journal.attach_mirror(sink)
            tel_arg = self.telemetry.labeled(runtime=rid) \
                if self.telemetry is not None else telemetry_mod.OFF
            service = make_service(rid, journal, tel_arg)
            if service.journal is None:
                service.journal = journal
            self._nodes[rid] = RuntimeNode(rid, service, journal, sink)
            self.router.add_runtime(rid)
            # fleet-wide quota view for each runtime's own admission gate
            adm = service.admission
            if adm is not None \
                    and getattr(adm, "global_unfinished", None) is None:
                adm.global_unfinished = self.global_unfinished

    def _wrap_sink(self, sink: ReplicaSink, rid: str):
        """Replica sinks pass through the chaos plane when one is
        attached, so ``mirror_fail`` windows hit mirror writes."""
        if self._chaos is None:
            return sink
        return ChaosSink(sink, rid, self._chaos)

    # -- telemetry ------------------------------------------------------
    def _counter(self, name: str, **labels):
        if self.telemetry is None:
            return None
        return self.telemetry.registry.counter(name, **labels)

    def _count(self, name: str, v: float = 1.0, **labels) -> None:
        c = self._counter(name, **labels)
        if c is not None:
            c.add(v)

    # -- fleet views ----------------------------------------------------
    def nodes(self) -> Dict[str, RuntimeNode]:
        return dict(self._nodes)

    def alive_nodes(self) -> List[RuntimeNode]:
        return [n for n in self._nodes.values() if n.alive]

    def global_unfinished(self, tenant: str) -> int:
        """Fleet-wide unfinished jobs for a tenant: the gossip aggregate
        plus submissions routed since the last heartbeat (so a burst
        between rounds cannot slip past the quota)."""
        with self._lock:
            pending = sum(n.pending_jobs.get(tenant, 0)
                          for n in self._nodes.values() if n.alive)
        return self.bus.unfinished(tenant) + pending

    def _loads(self) -> Dict[str, float]:
        """Router load view: gossiped backlog items corrected by
        un-gossiped local placements."""
        out: Dict[str, float] = {}
        for rid, node in self._nodes.items():
            if not node.alive:
                continue
            hb = self.bus.get(rid)
            base = float(hb.backlog_items) if hb is not None else 0.0
            out[rid] = base + node.routed_items
        return out

    # -- submission -----------------------------------------------------
    def submit(self, job: Job) -> AdmissionDecision:
        """Route one job onto a runtime. The *global* tenant quota gates
        first (gossip-aggregated — N runtimes' local gates each allow a
        full quota); within budget, placement is bounded-load consistent
        hashing on the tenant and the runtime's own admission runs."""
        spec = self.tenants.get(job.tenant) \
            if self.tenants is not None else None
        if spec is not None and spec.max_inflight is not None \
                and self.global_unfinished(job.tenant) \
                >= spec.max_inflight:
            with self._lock:
                full = len(self._deferred) >= self.max_deferred
                if not full:
                    self._deferred.append(job)
                    self.quota_defers += 1
            if full:
                job.transition(JobState.CANCELLED)
                return AdmissionDecision(
                    Decision.REJECT, 0.0, 0.0, tenant=job.tenant,
                    reason=f"federation deferred pool at capacity "
                           f"({self.max_deferred})")
            self._count("fed.quota_defers", tenant=job.tenant)
            return AdmissionDecision(
                Decision.DEFER, 0.0, 0.0, tenant=job.tenant,
                reason=f"tenant {job.tenant} at global in-flight quota "
                       f"{spec.max_inflight}")
        rid = self.router.place(self._route_key(job), self._loads(),
                                weight=float(job.items))
        if rid is None:
            job.transition(JobState.CANCELLED)
            return AdmissionDecision(Decision.REJECT, 0.0, 0.0,
                                     tenant=job.tenant,
                                     reason="no live runtimes")
        node = self._nodes[rid]
        with self._lock:
            self._jobs[job.job_id] = job
            self._placement[job.job_id] = rid
        self._count("fed.routed", runtime=rid)
        dec = node.service.submit(job)
        # the un-gossiped correction is recorded AFTER the runtime's own
        # admission ran: recording first would make the quota gate count
        # the job against itself (max(local, global) with global already
        # including it), turning quota N into N-1
        if dec.decision != Decision.REJECT:
            with self._lock:
                node.routed_items += float(job.items)
                node.pending_jobs[job.tenant] = \
                    node.pending_jobs.get(job.tenant, 0) + 1
        return dec

    def _route_key(self, job: Job) -> str:
        """Ring key for one job. Normally the tenant (full stickiness: a
        tenant's jobs share a runtime's cache, journal, and DWRR shard).
        A *saturating* tenant — fleet-wide unfinished count past
        ``spread_after`` per fanned key — routes round-robin over enough
        virtual keys (``tenant#k``) to span the backlog, so competing hot
        tenants co-locate on every runtime and weighted DWRR arbitration
        holds fleet-wide instead of degenerating into tenant-exclusive
        runtimes (where local weights arbitrate nothing)."""
        if not self.spread_after:
            return job.tenant
        fan = 1 + self.global_unfinished(job.tenant) // self.spread_after
        fan = min(max(1, len(self.alive_nodes())), fan)
        if fan <= 1:
            return job.tenant
        with self._lock:
            seq = self._tenant_seq.get(job.tenant, 0)
            self._tenant_seq[job.tenant] = seq + 1
        return f"{job.tenant}#{seq % fan}"

    def retry_deferred(self) -> int:
        """Re-offer globally-deferred jobs; returns how many routed."""
        with self._lock:
            waiting, self._deferred = self._deferred, []
            self._retrying += len(waiting)
        routed = 0
        try:
            for job in waiting:
                if job.state != JobState.PENDING:
                    continue
                dec = self.submit(job)
                routed += dec.decision == Decision.ADMIT
        finally:
            with self._lock:
                self._retrying -= len(waiting)
        return routed

    # -- gossip ---------------------------------------------------------
    def _heartbeat(self, node: RuntimeNode) -> Heartbeat:
        svc = node.service
        queue = svc.queue
        unfinished: Dict[str, int] = {}
        unfinished_fn = getattr(queue, "unfinished", None)
        names = list(self.tenants.names()) \
            if self.tenants is not None else []
        if unfinished_fn is not None and names:
            for t in names:
                unfinished[t] = unfinished_fn(t)
        else:
            for j in queue.jobs():
                if j.state in (JobState.ADMITTED, JobState.RUNNING):
                    unfinished[j.tenant] = unfinished.get(j.tenant, 0) + 1
        energy: Dict[str, float] = {}
        if svc.accountant is not None:
            for t, u in svc.accountant.snapshot().items():
                energy[t] = u["energy_j"]
        if svc.admission is not None:
            capacity = svc.admission.capacity_items_s()
        else:
            sched = svc.scheduler()
            tracker = getattr(sched, "tracker", None) if sched else None
            capacity = sum(tracker.snapshot().values()) \
                if tracker is not None else 1.0
        delays = svc.stats.delay_percentiles()
        return Heartbeat(
            runtime_id=node.runtime_id, ts=self.bus.clock(),
            capacity_items_s=capacity,
            queue_depth=queue.depth(),
            backlog_items=queue.backlog_items(),
            delay_p50_s=delays.get("p50", 0.0),
            delay_p95_s=delays.get("p95", 0.0),
            done=svc.stats.done, failed=svc.stats.failed,
            unfinished_jobs=unfinished, energy_j=energy)

    def gossip_round(self) -> None:
        """One heartbeat exchange: every live runtime publishes, the
        router refreshes stale-derated capacities, global energy budgets
        re-derate DWRR weights, and the globally-deferred pool re-gates.
        With a chaos plane attached this is also where its federation
        faults execute: plan-scheduled kills fire here, a runtime inside
        a ``gossip_drop``/``partition`` window publishes nothing (the
        bus's stale derate takes over), a ``gossip_delay`` window lags
        the heartbeat timestamp by ``magnitude`` seconds, and mirrors
        detached during a ``mirror_fail`` window are re-synced once the
        window has passed."""
        now = self.bus.clock()
        chaos = self._chaos
        if chaos is not None:
            for rid in chaos.take_kills(
                    [n.runtime_id for n in self.alive_nodes()]):
                self.kill_runtime(rid)
        for node in self.alive_nodes():
            if chaos is not None and (
                    chaos.active("federation", "gossip_drop",
                                 node.runtime_id) is not None
                    or chaos.active("federation", "partition",
                                    node.runtime_id) is not None):
                continue    # heartbeat lost; routed_items correction
            hb = self._heartbeat(node)      # stays banked for later
            if chaos is not None:
                ev = chaos.active("federation", "gossip_delay",
                                  node.runtime_id)
                if ev is not None and ev.magnitude > 0.0:
                    hb = replace(hb, ts=hb.ts - ev.magnitude)
            self.bus.publish(hb)
            with self._lock:
                # the heartbeat just captured this queue's state; the
                # un-gossiped correction window restarts
                node.routed_items = 0.0
                node.pending_jobs.clear()
        self._heal_mirrors()
        for node in self.alive_nodes():
            self.router.set_capacity(
                node.runtime_id,
                self.bus.effective_capacity(node.runtime_id, now))
        self._apply_energy_budgets()
        self._count("fed.gossip_rounds")
        if self.telemetry is not None:
            self.telemetry.registry.gauge("fed.runtimes_alive") \
                .set(len(self.alive_nodes()))
        self.retry_deferred()

    def _heal_mirrors(self) -> None:
        """Re-attach replication for any journal whose mirror detached
        (a sink write error — under chaos, a ``mirror_fail`` window).
        Detachment is the journal's self-protection, but a runtime
        running unmirrored is a replication gap: a later kill would lose
        whatever the replica missed. Healing rewrites a fresh sink from
        the primary's current per-job state and resumes forwarding; the
        heal is skipped while the fault window is still open (it would
        just detach again)."""
        for node in self.alive_nodes():
            if node.journal.has_mirror():
                continue
            if self._chaos is not None and self._chaos.active(
                    "federation", "mirror_fail",
                    node.runtime_id) is not None:
                continue
            node.sink.close()
            sink = self._wrap_sink(
                self.ring.make_sink(node.runtime_id), node.runtime_id)
            try:
                node.journal.resync_mirror(sink)
            except Exception:       # window raced the resync; next round
                sink.close()
                continue
            node.sink = sink
            self._count("fed.mirror_resyncs", runtime=node.runtime_id)

    def _apply_energy_budgets(self) -> None:
        """Global energy enforcement: a tenant's fleet-wide attributed
        joules vs. its budget → weight derate pushed into every runtime's
        accountant (merged by min() with the local derates) and applied
        to the DWRR shards immediately."""
        if self.tenants is None:
            return
        derates: Dict[str, float] = {}
        for t in self.tenants.names():
            budget = self.tenants.get(t).energy_budget_j
            if budget is None:
                continue
            spent = self.bus.energy(t)
            if spent > budget > 0:
                derates[t] = budget / spent
        for node in self.alive_nodes():
            acct = node.service.accountant
            if acct is None:
                continue
            acct.set_external_derates(derates)
            set_derates = getattr(node.service.queue,
                                  "set_weight_derates", None)
            if set_derates is not None:
                set_derates(acct.derate_weights())

    # -- failure / handoff ----------------------------------------------
    def kill_runtime(self, rid: str) -> List[Job]:
        """Crash one runtime (unclean: in-flight batches die un-finalized)
        and fail its work over: the victim's replica and primary journals
        are merged (terminal verdicts win — a replica that is a stale
        prefix must not resurrect a finished job, and a primary whose
        final write was torn must not lose one) and the merge replays
        through a survivor's ``recover`` — RUNNING rewinds to REQUEUED,
        queued jobs re-enter a live queue, PENDING re-gates — conserving
        deadline/tier metadata, deduplicated by job id. Kills are
        serialized (``_kill_lock``): two racing kills could otherwise
        each pick the other as survivor mid-crash and replay into a
        dying runtime. Returns the re-materialized jobs (empty when no
        survivor remains)."""
        with self._kill_lock:
            node = self._nodes[rid]
            if not node.alive:
                return []
            node.alive = False
            self._killed.append(rid)
            self.router.remove_runtime(rid)
            self.bus.drop(rid)
            with self._lock:
                node.routed_items = 0.0
                node.pending_jobs.clear()
            node.service.crash()
            if self._chaos is not None and self._chaos.take(
                    "journal", "torn_write", rid) is not None:
                node.journal.tear_tail()
            node.journal.close()
            node.sink.close()
            self._count("fed.failovers")
            survivor = self._survivor_for(rid)
            if survivor is None:
                return []
            recovered = survivor.service.recover(
                self._merged_recovery_source(rid))
            with self._lock:
                for job in recovered:
                    self._jobs[job.job_id] = job
                    self._placement[job.job_id] = survivor.runtime_id
                self.recovered += len(recovered)
            self._count("fed.recovered_jobs", len(recovered),
                        runtime=survivor.runtime_id)
            return recovered

    def _merged_recovery_source(self, rid: str) -> str:
        """Merge every recovery source for ``rid`` into one replayable
        journal. Sources are consulted replica-then-primary with
        later-source-wins per job — the primary is the newer view when
        both parsed — EXCEPT that a terminal verdict from any source
        sticks: the one unsafe disagreement is a stale non-terminal
        record shadowing a DONE/FAILED/CANCELLED one, which would requeue
        (and re-execute) a job that already finished."""
        sources = self.ring.recovery_sources(rid)
        if len(sources) == 1:
            return sources[0]
        merged: Dict[str, Job] = {}
        order: List[str] = []
        for path in sources:
            for jid, job in JournalStore.replay(path).items():
                cur = merged.get(jid)
                if cur is None:
                    merged[jid] = job
                    order.append(jid)
                elif not cur.terminal:
                    merged[jid] = job
        out = os.path.join(self.ring.directory, f"{rid}.recovery.jsonl")
        with open(out, "w", encoding="utf-8") as fh:
            for jid in order:
                fh.write(_entry_line(merged[jid],
                                     merged[jid].state.value) + "\n")
        return out

    def _survivor_for(self, rid: str) -> Optional[RuntimeNode]:
        """The victim's ring peer, walking past peers that are themselves
        dead (cascading failures hand off transitively)."""
        seen = {rid}
        cur = self.ring.peer_of(rid)
        while cur not in seen:
            node = self._nodes.get(cur)
            if node is not None and node.alive:
                return node
            seen.add(cur)
            cur = self.ring.peer_of(cur)
        return None

    # -- lifecycle ------------------------------------------------------
    def start(self) -> None:
        if self._started:
            return
        self._started = True
        self._t0 = clock()
        if self._chaos is not None:
            self._chaos.start()     # fault clock origin = fleet start
        for node in self.alive_nodes():
            node.service.start()
        self.gossip_round()            # seed the router before any wait
        self._stop_evt.clear()
        self._hb_thread = threading.Thread(
            target=self._hb_loop, name="fed-gossip", daemon=True)
        self._hb_thread.start()

    def _hb_loop(self) -> None:
        while not self._stop_evt.wait(self.heartbeat_s):
            self.gossip_round()

    def _idle(self) -> bool:
        with self._lock:
            if self._deferred or self._retrying:
                return False
        for node in self.alive_nodes():
            svc = node.service
            # queue.jobs() holds every non-terminal job (terminal ones
            # are evicted), which covers the popped-but-not-yet-submitted
            # window a depth() check would miss
            if svc._inflight or svc.queue.jobs():
                return False
            with svc._lock:
                if svc._deferred or svc._retrying:
                    return False
        return True

    def run_until_idle(self, timeout_s: float = 60.0) -> bool:
        """Drain every runtime (daemons + gossip) until no live work
        remains anywhere; False on timeout."""
        self.start()
        deadline = clock() + timeout_s
        while clock() < deadline:
            if self._idle():
                return True
            time.sleep(min(self.heartbeat_s, 0.02))
        return False

    def stop(self) -> None:
        self._stop_evt.set()
        if self._hb_thread is not None:
            self._hb_thread.join(timeout=5.0)
            self._hb_thread = None
        self._started = False

    def close(self) -> None:
        self.stop()
        for node in self._nodes.values():
            if node.alive:
                node.service.close()
                node.journal.close()
            node.sink.close()

    # -- reporting ------------------------------------------------------
    def gossip_rounds(self) -> int:
        if self.telemetry is None:
            return 0
        return int(self.telemetry.registry.counter(
            "fed.gossip_rounds").value())

    def report(self) -> FederationReport:
        with self._lock:
            jobs = list(self._jobs.values())
        by_state: Dict[JobState, int] = {}
        per_tenant: Dict[str, int] = {}
        for j in jobs:
            by_state[j.state] = by_state.get(j.state, 0) + 1
            if j.state == JobState.DONE:
                per_tenant[j.tenant] = per_tenant.get(j.tenant, 0) + j.items
        per_runtime = {}
        for rid, node in self._nodes.items():
            st = node.service.stats
            per_runtime[rid] = {
                "alive": float(node.alive), "done": float(st.done),
                "batches": float(st.batches),
                "items": float(sum(st.per_group_items.values()))}
        return FederationReport(
            runtimes=len(self._nodes), alive=len(self.alive_nodes()),
            jobs=len(jobs),
            done=by_state.get(JobState.DONE, 0),
            failed=by_state.get(JobState.FAILED, 0),
            cancelled=by_state.get(JobState.CANCELLED, 0),
            requeues=sum(n.service.stats.requeues
                         for n in self._nodes.values()),
            recovered=self.recovered,
            failovers=len(self._killed),
            gossip_rounds=self.gossip_rounds(),
            time_s=(clock() - self._t0) if self._t0 is not None else 0.0,
            killed=list(self._killed),
            per_runtime=per_runtime,
            per_tenant_items=per_tenant)
