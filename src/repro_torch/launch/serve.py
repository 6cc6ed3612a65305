"""Heterogeneous serving driver: batched requests scheduled across groups.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch stablelm-1.6b \\
      --requests 64 --prompt-len 512 --decode-tokens 16 \\
      --groups accel:chunk=8:async=2,cpu0 --reduced

The first group runs on the card (``cuda:0``) and the others on the CPU.
``--device cpu`` runs every group on the CPU; without it, a machine with no
CUDA device is an error, never a silent fall-back. The CUDA kernels take
bfloat16, so ``--dtype float32`` serves only with ``--device cpu``.
Groups syntax: name[:k=v,...] where the kind is inferred (first group =
accel), knobs: async=<depth>, slow=<factor>, chunk=<fixed>, pri=1. Prints
a JSON report.

Queued mode (admission control + priority queue + journal), drained onto
the persistent scheduler runtime with a double-buffered batch pipeline:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --reduced \\
      --queue --requests 64 --job-items 2 --slo 5.0 \\
      --pipeline-depth 2 --journal serve.journal.jsonl

``--rebuild-per-batch`` restores the old build-run-teardown scheduler per
batch (the baseline of the persistent runtime).

Multi-tenant mode (requires --queue): jobs are spread round-robin across
the tenants and drained weighted-fair with per-tenant accounting:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --reduced \\
      --queue --requests 64 \\
      --tenants "gold:weight=10,free:weight=1:quota=8:slo=5.0" \\
      --power "accel=8:2,cpu0=4:1"

Federated mode (requires --queue): the same jobs drain across N
in-process scheduler runtimes behind one consistent-hash front door,
with mirrored journals; ``--kill-runtime K`` runs the failure drill:

  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-6b --reduced \\
      --queue --requests 64 --runtimes 3 --kill-runtime 1 \\
      --tenants "gold:weight=10,free:weight=1:quota=8"

``--tenants-file spec.json`` loads the same specs from a JSON file
(``[{"name": ..., "weight": ..., "max_inflight": ..., "slo_delay_s": ...,
"energy_budget_j": ...}, ...]``); ``--power group=active_w:idle_w,...``
enables the energy model so per-tenant joules/EDP are reported and soft
energy budgets derate DWRR weights.
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.core.energy import EnergyModel, PowerSpec
from repro_torch.core.types import TIERS, DeviceKind
from repro_torch.policy import AdaptivePolicy
from repro_torch.queue import Job
from repro_torch.serve.engine import GroupDef, HeteroServeEngine
from repro_torch.telemetry import MetricsExporter, Telemetry
from repro_torch.tenancy import TenantRegistry


def parse_groups(spec: str):
    out = []
    for i, part in enumerate(spec.split(",")):
        bits = part.split(":")
        name = bits[0]
        kind = DeviceKind.ACCEL if i == 0 else (
            DeviceKind.LITTLE if name.startswith("little")
            else DeviceKind.BIG)
        g = GroupDef(name, kind)
        for kv in bits[1:]:
            k, v = kv.split("=")
            if k == "async":
                g.async_depth = int(v)
            elif k == "slow":
                g.slowdown = float(v)
            elif k == "chunk":
                g.fixed_chunk = int(v)
            elif k == "pri":
                g.priority_boost = bool(int(v))
        out.append(g)
    return out


def parse_power(text: str) -> EnergyModel:
    """``group=active_w:idle_w,...`` → EnergyModel."""
    specs = {}
    for tok in text.split(","):
        name, _, watts = tok.strip().partition("=")
        active, _, idle = watts.partition(":")
        specs[name] = PowerSpec(active_w=float(active),
                                idle_w=float(idle) if idle else 0.0)
    return EnergyModel(specs)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--decode-tokens", type=int, default=8)
    ap.add_argument("--groups", default="accel:chunk=8:async=2,cpu0")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--chunk-mode", choices=["range", "paper"],
                    default="range",
                    help="dispatch hot path: 'range' = zero-contention "
                         "work-stealing range partitioner (default); "
                         "'paper' = the lock-per-token baseline")
    ap.add_argument("--queue", action="store_true",
                    help="submit requests as prioritized jobs through "
                         "admission control instead of one bare batch")
    ap.add_argument("--job-items", type=int, default=1,
                    help="requests per job in --queue mode")
    ap.add_argument("--batch-jobs", type=int, default=8,
                    help="jobs drained per scheduler run in --queue mode")
    ap.add_argument("--slo", type=float, default=None,
                    help="queue-delay SLO seconds (enables admission "
                         "backpressure in --queue mode)")
    ap.add_argument("--priority", default="standard",
                    choices=["urgent", "standard", "batch", "mix"],
                    help="latency tier for queued jobs; 'mix' cycles "
                         "urgent/standard/batch across jobs")
    ap.add_argument("--deadline-ms", type=float, default=None,
                    help="per-job latency budget in ms (--queue mode); "
                         "jobs past it are shed at pop and in-flight "
                         "batches past it are cancelled cooperatively")
    ap.add_argument("--no-express", action="store_true",
                    help="disable the urgent-tier express lane "
                         "(baseline: urgent jobs wait out the pipeline)")
    ap.add_argument("--journal", default=None,
                    help="JSONL journal path for durable job state")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="batches in flight on the persistent runtime "
                         "(2 = double-buffered continuous drain)")
    ap.add_argument("--rebuild-per-batch", action="store_true",
                    help="legacy mode: fresh scheduler + dispatcher "
                         "threads per batch (benchmark baseline)")
    ap.add_argument("--tenants", default=None,
                    help="tenant specs for --queue mode, e.g. "
                         "'gold:weight=10,free:weight=1:quota=8:slo=5.0'")
    ap.add_argument("--tenants-file", default=None,
                    help="JSON tenant spec file (alternative to --tenants)")
    ap.add_argument("--power", default=None,
                    help="per-group power 'group=active_w:idle_w,...' — "
                         "enables per-tenant energy/EDP accounting")
    ap.add_argument("--metrics-out", default=None,
                    help="JSONL metrics feed: one merged registry "
                         "snapshot per --metrics-interval (tail -f "
                         "friendly); a final snapshot is always written")
    ap.add_argument("--metrics-interval", type=float, default=1.0,
                    help="seconds between metric snapshots (<= 0: only "
                         "the final snapshot)")
    ap.add_argument("--trace-out", default=None,
                    help="Chrome trace-event JSON of chunk-lifecycle "
                         "spans (load in Perfetto / chrome://tracing)")
    ap.add_argument("--prom-out", default=None,
                    help="final Prometheus text-format dump")
    ap.add_argument("--sample-rate", type=float, default=1.0,
                    help="fraction of chunks traced (deterministic by "
                         "chunk seq)")
    ap.add_argument("--policy-window", type=float, default=5.0,
                    help="adaptive-policy sliding window seconds for "
                         "admission smoothing / spike detection in "
                         "--queue mode (0 disables the policy)")
    ap.add_argument("--spike-threshold", type=float, default=3.0,
                    help="a projected delay this many × the windowed "
                         "median counts as a load spike")
    ap.add_argument("--cooldown-s", type=float, default=1.0,
                    help="minimum seconds between applied straggler "
                         "capacity rebalances")
    ap.add_argument("--adaptive-refill",
                    action=argparse.BooleanOptionalAction, default=True,
                    help="steal-rate-driven refill sizing in the range "
                         "partitioner (--no-adaptive-refill: fixed "
                         "refill quota)")
    ap.add_argument("--idle-s", type=float, default=0.0,
                    help="keep the drain daemon alive this long after "
                         "the queue empties (idle-efficiency probe: "
                         "near-zero wakeups expected)")
    ap.add_argument("--runtimes", type=int, default=1,
                    help="federate the queued drain across this many "
                         "in-process scheduler runtimes (requires "
                         "--queue; 1 = the single-runtime path)")
    ap.add_argument("--kill-runtime", type=int, default=None,
                    help="failure drill (--runtimes > 1): crash runtime "
                         "rK once half the jobs are done and fail its "
                         "journal over to a survivor")
    ap.add_argument("--journal-dir", default=None,
                    help="directory for federated journals + replicas "
                         "(default: a fresh temp dir)")
    ap.add_argument("--chaos-seed", type=int, default=None,
                    help="fault injection (--runtimes > 1): generate a "
                         "deterministic randomized FaultPlan from this "
                         "seed (same seed => identical fault schedule)")
    ap.add_argument("--chaos-plan", default=None,
                    help="fault injection: an explicit FaultPlan (JSON "
                         "string or path); mutually exclusive with "
                         "--chaos-seed")
    ap.add_argument("--chaos-horizon-s", type=float, default=2.0,
                    help="horizon seconds for a --chaos-seed generated "
                         "plan")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: the first group on cuda:0, the others on "
                         "the CPU; cpu: every group on the CPU")
    ap.add_argument("--dtype", choices=["bfloat16", "float32"],
                    default=None,
                    help="activation/parameter dtype (default: the "
                         "config's)")
    args = ap.parse_args(argv)
    if args.runtimes < 1:
        ap.error("--runtimes must be >= 1")
    if args.runtimes > 1 and not args.queue:
        ap.error("--runtimes requires --queue")
    if args.kill_runtime is not None and \
            not 0 <= args.kill_runtime < args.runtimes:
        ap.error("--kill-runtime must name a runtime in "
                 f"[0, {args.runtimes})")
    if args.chaos_seed is not None and args.chaos_plan is not None:
        ap.error("--chaos-seed and --chaos-plan are mutually exclusive")
    if (args.chaos_seed is not None or args.chaos_plan is not None) \
            and args.runtimes < 2:
        ap.error("--chaos-seed/--chaos-plan require --runtimes >= 2")
    if args.job_items < 1:
        ap.error("--job-items must be >= 1")
    if args.deadline_ms is not None and args.deadline_ms <= 0:
        ap.error("--deadline-ms must be > 0")
    if args.requests < 1:
        ap.error("--requests must be >= 1")
    if (args.tenants or args.tenants_file) and not args.queue:
        ap.error("--tenants/--tenants-file require --queue")
    if args.tenants and args.tenants_file:
        ap.error("--tenants and --tenants-file are mutually exclusive")
    registry = None
    try:
        if args.tenants:
            registry = TenantRegistry.parse(args.tenants)
        elif args.tenants_file:
            registry = TenantRegistry.from_file(args.tenants_file)
    except (ValueError, KeyError, OSError) as e:
        ap.error(f"bad tenant spec: {e}")
    if registry is not None and not registry.names():
        ap.error("tenant spec defines no tenants")
    if args.power and registry is None:
        # per-tenant accounting is the only consumer of the energy model
        # on this path; silently dropping it would look like a no-op run
        ap.error("--power requires --tenants/--tenants-file")
    try:
        energy_model = parse_power(args.power) if args.power else None
    except ValueError as e:
        ap.error(f"bad --power spec: {e}")

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.dtype:
        cfg = cfg.replace(dtype=args.dtype)
    if args.device == "cuda" and cfg.dtype != "bfloat16":
        ap.error(f"--dtype {cfg.dtype}: the CUDA kernels take bfloat16; "
                 f"pass --device cpu to serve {cfg.dtype} on the CPU")
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA GPU is available (torch.cuda.is_available() is "
                 "False); pass --device cpu to serve on the CPU")
    groups = parse_groups(args.groups)
    for i, g in enumerate(groups):
        g.device = torch.device("cuda", 0) \
            if args.device == "cuda" and i == 0 else torch.device("cpu")
    if energy_model is not None:
        # a typo'd or missing group name would silently bill that
        # group's busy time at 0 W to every tenant
        group_names = {g.name for g in groups}
        unknown = set(energy_model.specs) - group_names
        missing = group_names - set(energy_model.specs)
        if unknown or missing:
            problems = []
            if unknown:
                problems.append(f"unknown group(s) {sorted(unknown)}")
            if missing:
                problems.append(f"uncovered group(s) {sorted(missing)}")
            ap.error(f"--power {'; '.join(problems)}; groups are "
                     f"{sorted(group_names)}")
    if not 0.0 <= args.sample_rate <= 1.0:
        ap.error("--sample-rate must be in [0, 1]")
    tel = Telemetry(sample_rate=args.sample_rate)
    exporter = MetricsExporter(tel, metrics_path=args.metrics_out,
                               interval_s=args.metrics_interval,
                               trace_path=args.trace_out,
                               prometheus_path=args.prom_out)
    eng = HeteroServeEngine(cfg, groups, prompt_len=args.prompt_len,
                            decode_tokens=args.decode_tokens,
                            seed=args.seed, chunk_mode=args.chunk_mode,
                            telemetry=tel,
                            adaptive_refill=args.adaptive_refill)
    exporter.start()
    try:
        _run(args, ap, eng, groups, registry, energy_model)
    finally:
        snap = exporter.stop()
        if args.metrics_out or args.trace_out or args.prom_out:
            print(json.dumps({
                "telemetry": {
                    "snapshots_written": exporter.snapshots_written,
                    "trace_events_written": exporter.trace_events_written,
                    "self_overhead_s":
                        round(snap["self"]["est_overhead_s"], 6),
                }}, indent=2))


def _run(args, ap, eng, groups, registry, energy_model):
    if args.queue:
        # cover --requests exactly: full jobs plus a remainder job
        full, rem = divmod(args.requests, args.job_items)
        sizes = [args.job_items] * full + ([rem] if rem else [])
        names = registry.names() if registry is not None else ["default"]
        deadline_s = args.deadline_ms / 1000.0 \
            if args.deadline_ms is not None else None
        jobs = [Job(items=n, priority=i % 3,
                    tier=TIERS[i % len(TIERS)] if args.priority == "mix"
                    else args.priority,
                    deadline_s=deadline_s,
                    tenant=names[i % len(names)])
                for i, n in enumerate(sizes)]
        if args.runtimes > 1:
            frep = eng.serve_jobs_federated(
                jobs, runtimes=args.runtimes, slo_delay_s=args.slo,
                batch_jobs=args.batch_jobs, journal_dir=args.journal_dir,
                pipeline_depth=args.pipeline_depth, tenants=registry,
                energy_model=energy_model, express=not args.no_express,
                kill_runtime=args.kill_runtime,
                chaos_seed=args.chaos_seed, chaos_plan=args.chaos_plan,
                chaos_horizon_s=args.chaos_horizon_s)
            fed = frep.fed
            out = {
                "runtimes": fed.runtimes, "alive": fed.alive,
                "jobs": fed.jobs, "done": fed.done,
                "failed": fed.failed, "cancelled": fed.cancelled,
                "requeues": fed.requeues, "recovered": fed.recovered,
                "failovers": fed.failovers, "killed": fed.killed,
                "gossip_rounds": fed.gossip_rounds,
                "drained": frep.drained,
                "new_tokens": frep.new_tokens,
                "time_s": round(fed.time_s, 3),
                "tok_per_s": round(
                    frep.new_tokens / max(fed.time_s, 1e-9), 1),
                "per_runtime": fed.per_runtime,
                "per_tenant_items": fed.per_tenant_items,
            }
            if frep.per_tenant:
                out["per_tenant"] = {
                    t: {k: round(v, 4) if isinstance(v, float) else v
                        for k, v in u.items()}
                    for t, u in frep.per_tenant.items()}
            print(json.dumps(out, indent=2))
            return
        policy = None
        if args.policy_window > 0:
            policy = AdaptivePolicy(window_s=args.policy_window,
                                    spike_threshold=args.spike_threshold,
                                    cooldown_s=args.cooldown_s,
                                    telemetry=eng.telemetry)
        rep = eng.serve_jobs(jobs, slo_delay_s=args.slo,
                             batch_jobs=args.batch_jobs,
                             journal_path=args.journal,
                             pipeline_depth=args.pipeline_depth,
                             persistent=not args.rebuild_per_batch,
                             tenants=registry, energy_model=energy_model,
                             express=not args.no_express,
                             policy=policy, idle_s=args.idle_s)
        out = {
            "jobs": rep.jobs, "done": rep.done, "failed": rep.failed,
            "cancelled": rep.cancelled, "requeues": rep.requeues,
            "batches": rep.batches, "new_tokens": rep.new_tokens,
            "time_s": round(rep.time_s, 3),
            "tok_per_s": round(rep.new_tokens / max(rep.time_s, 1e-9), 1),
            "queue_delay_s": {k: round(v, 4)
                              for k, v in rep.queue_delay.items()},
            "per_group": rep.per_group_items,
            "dead_groups": rep.dead_groups,
            "deadline_misses": rep.deadline_misses,
            "express_batches": rep.express_batches,
            "cancelled_batches": rep.cancelled_batches,
        }
        if rep.per_tenant:
            out["per_tenant"] = {
                t: {"items": u["items"],
                    "busy_s": round(u["busy_s"], 4),
                    "energy_j": round(u["energy_j"], 4),
                    "edp": round(u["edp"], 6),
                    "queue_delay_s": {k: round(v, 4) for k, v in
                                      u["queue_delay_s"].items()}}
                for t, u in rep.per_tenant.items()}
        if rep.admission_per_tenant:
            out["admission_per_tenant"] = rep.admission_per_tenant
        print(json.dumps(out, indent=2))
        return
    rep = eng.serve(args.requests)
    print(json.dumps({
        "requests": rep.requests,
        "new_tokens": rep.new_tokens,
        "time_s": round(rep.time_s, 3),
        "tok_per_s": round(rep.new_tokens / max(rep.time_s, 1e-9), 1),
        "per_group": rep.per_group_items,
        "accel_overheads": {k: round(v, 4) for k, v in
                            rep.overheads.get(groups[0].name, {}).items()},
    }, indent=2))


if __name__ == "__main__":
    main()
