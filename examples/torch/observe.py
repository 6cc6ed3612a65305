"""Observability tour: serve 50 jobs through the queued engine with a
fresh Telemetry instance, stream JSONL snapshots while it runs, then
print the live registry snapshot and where the exported artifacts landed.
The port's counterpart of ``examples/observe.py``: group ``accel`` runs on
``--device`` (the card by default), ``cpu0`` on the CPU.

Run:  python examples/torch/observe.py [--device cpu]
Then open trace at https://ui.perfetto.dev (or chrome://tracing).
"""
import argparse
import json
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import torch

from repro_torch.configs.registry import get_reduced_config
from repro_torch.core.types import DeviceKind
from repro_torch.queue import Job
from repro_torch.serve.engine import GroupDef, HeteroServeEngine
from repro_torch.telemetry import MetricsExporter, Telemetry, read_jsonl
from repro_torch.tenancy import TenantRegistry


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where group accel runs (cpu0 is always the CPU)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA GPU is available; pass --device cpu")

    cfg = get_reduced_config("yi-6b")
    groups = [
        GroupDef("accel", DeviceKind.ACCEL, device=args.device,
                 fixed_chunk=8, async_depth=2),
        GroupDef("cpu0", DeviceKind.BIG, device="cpu", slowdown=2.0),
    ]
    tenants = TenantRegistry.parse("gold:weight=4,free:weight=1")
    jobs = [Job(items=2, priority=i % 3,
                tenant="gold" if i % 2 else "free") for i in range(50)]

    out = Path(tempfile.mkdtemp(prefix="repro-observe-"))
    tel = Telemetry(sample_rate=1.0)
    eng = HeteroServeEngine(cfg, groups, prompt_len=24, decode_tokens=6,
                            telemetry=tel)
    with MetricsExporter(tel, metrics_path=str(out / "metrics.jsonl"),
                         interval_s=0.25,
                         trace_path=str(out / "trace.json"),
                         prometheus_path=str(out / "prom.txt")):
        rep = eng.serve_jobs(jobs, batch_jobs=8, tenants=tenants)

    print(f"{rep.jobs} jobs ({rep.done} done) -> {rep.new_tokens} tokens "
          f"in {rep.time_s:.2f}s")

    snap = eng.telemetry_snapshot()
    chunks = {k: v for k, v in snap["counters"].items()
              if k.startswith("sched.chunks")}
    host = {k: round(v["mean"] * 1e6, 1) for k, v in
            snap["histograms"].items() if k.startswith("sched.chunk_host")}
    print("\nlive snapshot highlights")
    print("  chunks per group:   ", chunks)
    print("  host overhead (us): ", host)
    print("  DWRR pops:          ",
          {k: v for k, v in snap["counters"].items()
           if k.startswith("queue.dwrr_pops")})
    print("  registry self-cost: ",
          f"{snap['self']['ns_per_op']:.0f} ns/op, "
          f"{snap['self']['est_overhead_s'] * 1e3:.2f} ms total")

    snaps = read_jsonl(out / "metrics.jsonl")
    trace = json.loads((out / "trace.json").read_text())
    print(f"\nexported to {out}")
    print(f"  metrics.jsonl  {len(snaps)} snapshots "
          f"(last is final={snaps[-1]['final']})")
    print(f"  trace.json     {len(trace['traceEvents'])} events — load in "
          f"Perfetto")
    print(f"  prom.txt       Prometheus text format")
    return rep, snap


if __name__ == "__main__":
    main()
