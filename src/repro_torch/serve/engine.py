"""HeteroServeEngine: the paper's scheduler applied to batched inference.

Torch counterpart of ``repro.serve.engine``: the bare ``serve`` path, the
queued path (``serve_jobs``: admission control, priority tiers, tenants,
journal) and the federated path (``serve_jobs_federated``: N runtimes
behind one front door, failover and chaos drills). The iteration space is
the request queue; a chunk is a batch of requests. The accelerator group's
tuned chunk G is the throughput-optimal serving batch; other groups get
λ-proportional batches. Each chunk is prefill + a fixed greedy decode
burst; effective throughput is generated tokens / wall time, which feeds
eq. (4).

Each group runs on one torch device (``GroupDef.device``): a CUDA group
runs the model with the hand-written kernels on its executor's stream, a
CPU group runs the eager path. The kernels take bfloat16, so a CUDA group
with a config of another dtype is refused before any weight is placed.
The engine holds one copy of the weights per device that a group uses;
every executor on a device, of every federated runtime, reads that copy.
Each executor has its own CUDA stream.

``_fns_for(b)`` is the JAX engine's per-bucket ``jax.jit`` of ``prefill``
and ``decode_step``. On a CUDA group its functions replay CUDA graphs
captured once per (executor, bucket) on the executor's stream
(``serve.graphs``, on the capture that the trainer shares:
``repro_torch.graphs``); ``graph_counts`` counts the captures, replays and
failures. There is no eager path on CUDA: a capture that fails raises. A
CPU group calls the model eagerly.
"""
from __future__ import annotations

import os
import tempfile
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch import telemetry as telemetry_mod
from repro_torch.configs.base import LMConfig
from repro_torch.core import (ChunkFailure, DynamicScheduler, GroupSpec,
                              OverheadLedger, ThroughputTracker,
                              TorchChunkExecutor)
from repro_torch.core.dispatch import (GroupDef, bucket, group_devices,
                                       phase_totals)
from repro_torch.core.energy import EnergyModel
from repro_torch.graphs import GraphCounts
from repro_torch.models import model as M
from repro_torch.queue import (AdmissionController, Job, JobService,
                               JournalStore, QueueManager, percentiles)
from repro_torch.serve.graphs import GraphedStep
from repro_torch.tenancy import (ShardedQueueManager, TenantAccountant,
                                 TenantRegistry)
from repro_torch.train.optimizer import tree_map


@dataclass
class ServeReport:
    requests: int
    new_tokens: int
    time_s: float
    per_group_items: Dict[str, int]
    overheads: Dict[str, Dict[str, float]]
    throughput: Dict[str, float]
    #: request index -> its generated tokens (decode_tokens,)
    tokens_out: Dict[int, np.ndarray] = field(default_factory=dict)
    #: the accelerator groups' chunk phases, summed by name (``serve.inputs``,
    #: ``serve.prefill``, ``serve.decode`` with its steps, ``serve.gather``,
    #: ``serve.fetch_wait``, ``serve.fetch``): ``{name: {"device_s",
    #: "host_s", "count", "steps"}}``; empty with telemetry off
    phases: Dict[str, Dict[str, float]] = field(default_factory=dict)
    #: the bytes of the largest cache one of the call's chunks held, by
    #: kind: ``kv`` (attention's K/V), ``ssm_state`` (recurrent states),
    #: ``conv`` (Mamba-2's conv windows)
    cache_bytes: Dict[str, int] = field(default_factory=dict)


@dataclass
class QueueServeReport:
    """Result of the queued-submission path (serve_jobs)."""
    jobs: int
    done: int
    failed: int
    cancelled: int
    requeues: int
    batches: int
    new_tokens: int
    time_s: float
    queue_delay: Dict[str, float]          # p50/p95/p99 seconds
    per_group_items: Dict[str, int]
    throughput: Dict[str, float]
    dead_groups: List[str] = field(default_factory=list)
    drained: bool = True
    # multi-tenant mode: per-tenant attributed usage (items, busy_s,
    # energy_j, edp, queue-delay percentiles) + admission counters
    per_tenant: Dict[str, Dict] = field(default_factory=dict)
    admission_per_tenant: Dict[str, Dict[str, int]] = \
        field(default_factory=dict)
    # latency tiers: per-tier deadline misses, express-lane batches, and
    # in-flight epochs cancelled (deadline preemption)
    deadline_misses: Dict[str, int] = field(default_factory=dict)
    express_batches: int = 0
    cancelled_batches: int = 0


@dataclass
class FederatedServeReport:
    """Result of the federated path (serve_jobs_federated): the
    federation-level report plus engine-level aggregates."""
    fed: "object"                    # repro_torch.federation.FederationReport
    drained: bool
    per_tenant: Dict[str, Dict] = field(default_factory=dict)
    new_tokens: int = 0


class HeteroServeEngine:
    def __init__(self, cfg: LMConfig, groups: List[GroupDef],
                 prompt_len: int = 32, decode_tokens: int = 8,
                 max_len: Optional[int] = None, seed: int = 0,
                 alpha: float = 0.5, chunk_mode: str = "range",
                 telemetry=None, adaptive_refill: bool = True,
                 params: Optional[Dict] = None):
        if not groups:
            raise ValueError("no device groups")
        self.cfg = cfg
        self.groups = groups
        self.devices = group_devices(cfg, groups, "run")
        self.prompt_len = prompt_len
        self.decode_tokens = decode_tokens
        self.max_len = max_len or bucket(prompt_len + decode_tokens)
        self.seed = seed
        self.alpha = alpha
        # history-driven refill sizing in the partitioner (steal-rate
        # feedback; see HeterogeneousPartitioner._refill_quota_locked)
        self.adaptive_refill = adaptive_refill
        # "range": zero-contention dispatch (private λ-share ranges with
        # work stealing); "paper": the lock-per-token baseline
        self.chunk_mode = chunk_mode
        self.telemetry = telemetry_mod.resolve(telemetry)
        if params is None:
            dev = self.devices[groups[0].name]
            gen = torch.Generator(device=dev).manual_seed(seed)
            params = M.init_params(cfg, gen, dev)
        # one copy of the weights per device a group runs on
        self._params: Dict[torch.device, Dict] = {}
        for dev in self.devices.values():
            if dev not in self._params:
                self._params[dev] = tree_map(lambda t: t.to(dev), params)
        # (executor or None, bucket) -> (prefill_fn, decode_fn): None
        # keys the eager functions every CPU executor shares; a CUDA
        # executor has graphs of its own
        self._fns: Dict[Tuple[Optional[TorchChunkExecutor], int],
                        tuple] = {}
        self.graph_counts = GraphCounts()
        # fail-injection counters persist across executors so an injected
        # group death stays dead over a queued multi-batch run
        self._fail_counters: Dict[str, Dict[str, int]] = {}
        # executors are built once per (namespaced) group and reused
        # across epochs and scheduler rebuilds
        self._executors: Dict[str, TorchChunkExecutor] = {}
        # bucket -> its chunk's cache bytes by kind
        self._cache_sizes: Dict[int, Dict[str, int]] = {}

    def cache_bytes(self, b: int) -> Dict[str, int]:
        """The bytes by kind (``kv``, ``ssm_state``, ``conv``) of the cache
        a chunk of bucket ``b`` holds, counted from the abstract cache once
        a bucket (``M.cache_bytes``)."""
        got = self._cache_sizes.get(b)
        if got is None:
            got = self._cache_sizes[b] = M.cache_bytes(self.cfg, b,
                                                       self.max_len)
        return got

    # ------------------------------------------------------------------
    def _fns_for(self, b: int,
                 executor: Optional[TorchChunkExecutor] = None):
        """(prefill_fn, decode_fn) for batch bucket ``b``, cached:
        ``prefill_fn(params, tokens, prefix) -> (logits, cache)`` and
        ``decode_fn(params, cache, tokens) -> (logits, cache)``. Without
        an executor, or for a CPU one, they call the model eagerly; for a
        CUDA executor they replay that executor's graphs of the bucket,
        captured on its stream at the first call (``GraphedStep``), whose
        outputs the next replay overwrites."""
        cuda = executor is not None and executor.device.type == "cuda"
        key = (executor if cuda else None, b)
        fns = self._fns.get(key)
        if fns is not None:
            return fns
        cfg = self.cfg
        if cuda:
            graphs = GraphedStep(cfg, self._params[executor.device], b,
                                 self.prompt_len, self.max_len,
                                 executor.stream, self.graph_counts,
                                 executor.name)
            fns = (graphs.prefill, graphs.decode)
        else:
            def prefill_fn(params, tokens, prefix):
                return M.prefill(cfg, params, tokens, prefix,
                                 max_len=self.max_len)

            def decode_fn(params, cache, tokens):
                return M.decode_step(cfg, params, cache, tokens)

            fns = (prefill_fn, decode_fn)
        self._fns[key] = fns
        return fns

    def _prompt(self, idx: int, rng_salt: int = 0) -> np.ndarray:
        rng = np.random.Generator(np.random.PCG64(
            (self.seed << 32) ^ (idx + rng_salt)))
        return rng.integers(0, self.cfg.vocab, self.prompt_len,
                            dtype=np.int32)

    def _make_executor(self, g: GroupDef,
                       key: Optional[str] = None) -> TorchChunkExecutor:
        cfg = self.cfg
        device = self.devices[g.name]
        params = self._params[device]

        def make_inputs(token):
            ex.mark("serve.inputs")         # this and the copy to the device
            c = token.chunk
            pad = bucket(c.size)
            toks = np.stack([self._prompt(i) for i in range(c.begin, c.end)])
            if pad > c.size:
                toks = np.concatenate(
                    [toks, np.zeros((pad - c.size, self.prompt_len),
                                    np.int32)])
            out = {"tokens": toks}
            if cfg.prefix_len:
                rngp = np.random.Generator(np.random.PCG64(c.begin))
                out["prefix_emb"] = rngp.standard_normal(
                    (pad, cfg.prefix_len, cfg.d_model)).astype(np.float32) \
                    * 0.02
            return out

        counter = self._fail_counters.setdefault(key or g.name, {"n": 0})

        @torch.no_grad()
        def step(batch):
            # fail injection and the slowdown stay on the host, outside
            # any graph
            if g.fail_after_chunks is not None:
                counter["n"] += 1
                if counter["n"] > g.fail_after_chunks:
                    raise ChunkFailure(f"group {g.name} injected failure")
            b = batch["tokens"].shape[0]
            prefill_fn, decode_fn = self._fns_for(b, ex)
            if self.telemetry is not None:
                # the chunk's cache by kind, on the trace
                self.telemetry.tracer.instant(
                    "serve.cache_bytes", f"{key or g.name}/cache",
                    bucket=b, **self.cache_bytes(b))
            if g.slowdown > 1.0:
                time.sleep((g.slowdown - 1.0) * 0.001 * b)
            # greedy decoding stays on the device: no token comes back to
            # the host before fetch(). Each argmax is a new tensor, read
            # from the logits before the next replay overwrites them.
            ex.mark("serve.prefill")
            logits, cache = prefill_fn(params, batch["tokens"],
                                       batch.get("prefix_emb"))
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            toks = [tok]
            ex.mark("serve.decode", steps=self.decode_tokens - 1)
            for _ in range(self.decode_tokens - 1):
                logits, cache = decode_fn(params, cache, tok)
                tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
                toks.append(tok)
            ex.mark("serve.gather")
            return torch.cat(toks, dim=1)

        def fetch(outs):
            # the copy runs on the stream after the next chunk's step
            ex.settle("serve.fetch_wait")
            ex.mark("serve.fetch")
            return {"tokens_out": outs.cpu().numpy()}

        ex = TorchChunkExecutor(step, make_inputs, fetch, device=device,
                                async_depth=g.async_depth,
                                priority_boost=g.priority_boost,
                                name=key or g.name,
                                time_phases=self.telemetry is not None)
        return ex

    def _executor_for(self, g: GroupDef,
                      namespace: str = "") -> TorchChunkExecutor:
        # executors (and fail-injection counters) are cached per
        # *namespaced* name: federated runtimes must not share one
        # executor's async pipeline (or stream) across their dispatcher
        # threads; they do share the device's one copy of the weights
        key = namespace + g.name
        ex = self._executors.get(key)
        if ex is None:
            ex = self._executors[key] = self._make_executor(g, key)
        return ex

    # ------------------------------------------------------------------
    def _build_scheduler(self, max_chunk: Optional[int] = None,
                         exclude: Optional[set] = None,
                         namespace: str = "",
                         telemetry=None,
                         wrap_executor: Optional[Callable] = None) \
            -> DynamicScheduler:
        """``namespace`` prefixes every group name (federation: runtime
        ``r1``'s accel group is ``r1/accel``), so per-runtime schedulers
        get private executors, distinct trace tracks, and unambiguous
        dead-group exclusion. ``wrap_executor(name, ex)`` decorates each
        group's executor (the chaos plane's injection point)."""
        specs, execs = {}, {}
        for g in self.groups:
            name = namespace + g.name
            if exclude and name in exclude:
                continue
            specs[name] = GroupSpec(name, g.kind,
                                    fixed_chunk=g.fixed_chunk,
                                    min_chunk=1, max_chunk=max_chunk,
                                    init_throughput=1.0)
            ex = self._executor_for(g, namespace)
            if wrap_executor is not None:
                ex = wrap_executor(name, ex)
            execs[name] = ex
        if not specs:
            raise RuntimeError("no live device groups")
        return DynamicScheduler(specs, execs, alpha=self.alpha,
                                chunk_mode=self.chunk_mode,
                                adaptive_refill=self.adaptive_refill,
                                telemetry=telemetry if telemetry is not None
                                else self._tel_arg())

    def _tel_arg(self):
        """Forward the engine's resolved telemetry (None after resolve
        means *uninstrumented*, so pass OFF, not None)."""
        return self.telemetry if self.telemetry is not None \
            else telemetry_mod.OFF

    def telemetry_snapshot(self) -> Optional[Dict]:
        """Merged metrics + trace snapshot, or None when uninstrumented."""
        if self.telemetry is None:
            return None
        return self.telemetry.snapshot()

    def serve(self, n_requests: int) -> ServeReport:
        sched = self._build_scheduler(max_chunk=n_requests)
        res = sched.run(0, n_requests)
        tokens_out: Dict[int, np.ndarray] = {}
        cache_bytes: Dict[str, int] = {}
        for rec in res.records:
            result = rec.meta.get("result")
            if result is None:
                continue
            c = rec.token.chunk
            for i in range(c.size):
                tokens_out[c.begin + i] = result["tokens_out"][i]
            for kind, n in self.cache_bytes(bucket(c.size)).items():
                cache_bytes[kind] = max(cache_bytes.get(kind, 0), n)
        return ServeReport(
            requests=res.iterations,
            new_tokens=res.iterations * self.decode_tokens,
            time_s=res.total_time,
            per_group_items=res.per_group_items,
            overheads=res.overheads,
            throughput=res.throughput,
            tokens_out=tokens_out,
            cache_bytes=cache_bytes,
            phases=phase_totals(p for rec in res.records
                                if rec.token.is_accel
                                for p in rec.meta.get("phases", ())))

    # ------------------------------------------------------------------
    # queued-submission path: requests arrive as prioritized Jobs, pass
    # admission control, and are drained batch-wise by a JobService.
    # ------------------------------------------------------------------
    def serve_jobs(self, jobs: List[Job],
                   slo_delay_s: Optional[float] = None,
                   batch_jobs: int = 8,
                   journal_path: Optional[str] = None,
                   timeout_s: float = 300.0,
                   pipeline_depth: int = 2,
                   persistent: bool = True,
                   tenants: Optional[TenantRegistry] = None,
                   energy_model: Optional[EnergyModel] = None,
                   express: bool = True,
                   policy=None, idle_s: float = 0.0) \
            -> QueueServeReport:
        """Serve prioritized jobs through admission control + queue.

        Batches drain onto one *persistent* scheduler runtime: dispatcher
        threads and (cached) executors are built once and reused across
        epochs, and with ``pipeline_depth ≥ 2`` batch N+1 is dispatched
        while batch N is still in flight (continuous double-buffered
        drain — no inter-batch barrier, no per-batch rebuild).
        λ-estimates and overhead fractions are runtime-scoped (one
        ThroughputTracker / OverheadLedger for the whole session), so
        admission's capacity model and the partitioner both warm up once
        and stay warm. ``slo_delay_s=None`` disables the admission gate
        (every job is queued). Groups that die mid-run stay excluded for
        the rest of the session. ``persistent=False`` restores the old
        rebuild-per-batch behavior (benchmark baseline).

        Multi-tenant mode: pass a ``tenants`` registry and jobs are
        sharded per ``job.tenant`` with a DWRR weighted-fair drain,
        quota-aware admission (when an SLO enables the gate), and
        per-tenant accounting; with an ``energy_model`` each tenant's
        attributed joules/EDP are reported and soft energy budgets derate
        DWRR weights. Without a registry nothing changes.

        Latency tiers: urgent jobs drain through the service's express
        lane (``express=False`` disables it, the benchmark baseline),
        batches run at the tier of their most urgent member, and jobs
        with ``deadline_s`` are shed at pop or cooperatively cancelled in
        flight once the budget is spent.

        ``policy`` (repro_torch.policy.AdaptivePolicy) smooths admission
        over a sliding window and cools down straggler rebalances.
        ``idle_s > 0`` keeps the drain daemon parked for that long after
        the queue drains — the idle-efficiency probe that shows the
        event-driven drain isn't busy-polling.
        """
        tracker = ThroughputTracker(self.alpha)
        ledger = OverheadLedger()
        ledger.keep_records = False           # bounded memory for long runs
        dead: set = set()

        def make_scheduler() -> DynamicScheduler:
            # called once for the persistent runtime; again only if every
            # group died (or per batch with persistent=False)
            sched = self._build_scheduler(exclude=dead)
            sched.tracker = tracker           # runtime-scoped λ / §3.3
            sched.ledger = ledger
            return sched

        accountant = None
        if tenants is not None:
            queue = ShardedQueueManager(tenants, telemetry=self._tel_arg())
            accountant = TenantAccountant(tenants,
                                          energy_model=energy_model)
        else:
            queue = QueueManager()
        admission = None
        # the gate also turns on when any tenant spec carries an SLO or
        # quota — otherwise those contracts would be silently inert
        # without a global --slo; with no global SLO the global delay
        # band is infinite and only the per-tenant contracts bind
        if slo_delay_s is not None or (tenants is not None
                                       and tenants.any_gating()):
            admission = AdmissionController(
                queue, tracker, ledger,
                slo_delay_s=slo_delay_s if slo_delay_s is not None
                else float("inf"),
                registry=tenants, telemetry=self._tel_arg(),
                policy=policy)
            for g in self.groups:
                admission.on_group_join(g.name, 1.0)
        journal = JournalStore(journal_path) if journal_path else None
        service = JobService(make_scheduler, queue=queue,
                             admission=admission, journal=journal,
                             batch_jobs=batch_jobs,
                             on_group_failed=dead.add,
                             pipeline_depth=pipeline_depth,
                             persistent=persistent,
                             accountant=accountant,
                             telemetry=self._tel_arg(),
                             express=express)
        t0 = time.monotonic()
        for job in jobs:
            service.submit(job)
        drained = service.run_until_idle(timeout_s=timeout_s)
        dt = time.monotonic() - t0
        if idle_s > 0.0:
            # park the daemon on an empty queue: with the event-driven
            # drain it should accrue only fallback-timeout wakeups, at
            # ≤ 1/fallback_s per second (vs. 1/poll_s busy-polling)
            service.start()
            time.sleep(idle_s)
        service.close()
        if journal is not None:
            journal.close()
        st = service.stats
        cancelled = sum(1 for j in jobs if j.state.value == "cancelled")
        done_items = sum(j.items for j in jobs if j.state.value == "done")
        return QueueServeReport(
            jobs=len(jobs), done=st.done, failed=st.failed,
            cancelled=cancelled, requeues=st.requeues, batches=st.batches,
            new_tokens=done_items * self.decode_tokens, time_s=dt,
            queue_delay=percentiles(st.queue_delays),
            per_group_items=dict(st.per_group_items),
            throughput=tracker.snapshot(), dead_groups=sorted(dead),
            drained=drained,
            per_tenant=accountant.snapshot() if accountant else {},
            admission_per_tenant=dict(admission.per_tenant)
            if admission is not None else {},
            deadline_misses=dict(st.deadline_misses),
            express_batches=st.express_batches,
            cancelled_batches=st.cancelled_batches)

    # ------------------------------------------------------------------
    # federated path: N runtimes behind one front-end (repro_torch.federation)
    # ------------------------------------------------------------------
    def serve_jobs_federated(self, jobs: List[Job],
                             runtimes: int = 3,
                             slo_delay_s: Optional[float] = None,
                             batch_jobs: int = 8,
                             journal_dir: Optional[str] = None,
                             timeout_s: float = 300.0,
                             pipeline_depth: int = 2,
                             tenants: Optional[TenantRegistry] = None,
                             energy_model: Optional[EnergyModel] = None,
                             express: bool = True,
                             heartbeat_s: float = 0.1,
                             kill_runtime: Optional[int] = None,
                             kill_after_frac: float = 0.5,
                             chaos_seed: Optional[int] = None,
                             chaos_plan: Optional[str] = None,
                             chaos_horizon_s: float = 2.0) \
            -> "FederatedServeReport":
        """Serve jobs through a ``FederatedService``: ``runtimes``
        independent JobService runtimes — each with its own persistent
        scheduler (namespaced device groups ``rK/<group>``, private
        executors), runtime-scoped λ-tracker/ledger, tenancy shards, and
        mirrored journal — behind one tenant-consistent-hash front door.
        Global tenant quotas / energy budgets bind fleet-wide via gossip.

        ``kill_runtime=K`` crashes runtime ``rK`` once ``kill_after_frac``
        of the jobs are done (failure drill: its replica replays onto a
        survivor; the report's ``recovered`` counts the requeued jobs).

        Chaos plane: ``chaos_seed`` generates a deterministic randomized
        ``FaultPlan`` over ``chaos_horizon_s`` seconds (same seed ⇒ same
        schedule); ``chaos_plan`` instead loads an explicit plan (a JSON
        string or a path to one). Executor faults wrap every group's
        executor; journal/federation faults are executed by the
        federation tier.
        """
        from repro_torch.chaos import ChaosExecutor, ChaosInjector, FaultPlan
        from repro_torch.federation import FederatedService
        if journal_dir is None:
            journal_dir = tempfile.mkdtemp(prefix="repro-fed-")
        rids = [f"r{i}" for i in range(max(1, runtimes))]

        chaos = None
        if chaos_plan is not None or chaos_seed is not None:
            if chaos_plan is not None:
                text = chaos_plan
                if os.path.exists(chaos_plan):
                    with open(chaos_plan, "r", encoding="utf-8") as fh:
                        text = fh.read()
                plan = FaultPlan.from_json(text)
            else:
                plan = FaultPlan.generate(
                    chaos_seed, chaos_horizon_s, rids,
                    [f"{rid}/{g.name}" for rid in rids
                     for g in self.groups])
            chaos = ChaosInjector(plan, telemetry=self._tel_arg())

        def make_service(rid: str, journal, telemetry) -> JobService:
            tracker = ThroughputTracker(self.alpha)
            ledger = OverheadLedger()
            ledger.keep_records = False
            dead: set = set()

            def make_scheduler() -> DynamicScheduler:
                wrap = None
                if chaos is not None:
                    def wrap(name, ex):
                        return ChaosExecutor(ex, name, chaos)
                sched = self._build_scheduler(exclude=dead,
                                              namespace=f"{rid}/",
                                              telemetry=telemetry,
                                              wrap_executor=wrap)
                sched.tracker = tracker
                sched.ledger = ledger
                return sched

            accountant = None
            if tenants is not None:
                queue = ShardedQueueManager(tenants, telemetry=telemetry)
                accountant = TenantAccountant(tenants,
                                              energy_model=energy_model)
            else:
                queue = QueueManager()
            admission = None
            if slo_delay_s is not None or (tenants is not None
                                           and tenants.any_gating()):
                admission = AdmissionController(
                    queue, tracker, ledger,
                    slo_delay_s=slo_delay_s if slo_delay_s is not None
                    else float("inf"),
                    registry=tenants, telemetry=telemetry)
                for g in self.groups:
                    admission.on_group_join(f"{rid}/{g.name}", 1.0)
            return JobService(make_scheduler, queue=queue,
                              admission=admission, journal=journal,
                              batch_jobs=batch_jobs,
                              on_group_failed=dead.add,
                              pipeline_depth=pipeline_depth,
                              accountant=accountant,
                              telemetry=telemetry, express=express)

        fed = FederatedService(make_service, rids, journal_dir,
                               tenants=tenants,
                               telemetry=self._tel_arg(),
                               heartbeat_s=heartbeat_s,
                               chaos=chaos)
        t0 = time.monotonic()
        fed.start()
        for job in jobs:
            fed.submit(job)
        victim = f"r{kill_runtime}" if kill_runtime is not None \
            and 0 <= kill_runtime < len(rids) else None
        if victim is not None:
            threshold = max(1, int(kill_after_frac * len(jobs)))
            deadline = time.monotonic() + timeout_s
            while time.monotonic() < deadline:
                done = sum(1 for j in jobs
                           if j.state.value in ("done", "failed",
                                                "cancelled"))
                if done >= threshold:
                    break
                time.sleep(0.01)
            fed.kill_runtime(victim)
        drained = fed.run_until_idle(timeout_s=timeout_s)
        rep = fed.report()
        rep.time_s = time.monotonic() - t0
        per_tenant: Dict[str, Dict] = {}
        for node in fed.nodes().values():
            acct = node.service.accountant
            if acct is None:
                continue
            for t, d in acct.snapshot().items():
                agg = per_tenant.setdefault(
                    t, {"items": 0, "busy_s": 0.0, "energy_j": 0.0,
                        "batches": 0})
                agg["items"] += d["items"]
                agg["busy_s"] += d["busy_s"]
                agg["energy_j"] += d["energy_j"]
                agg["batches"] += d["batches"]
        fed.close()
        return FederatedServeReport(
            fed=rep, drained=drained, per_tenant=per_tenant,
            new_tokens=sum(rep.per_tenant_items.values())
            * self.decode_tokens)
