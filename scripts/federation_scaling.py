#!/usr/bin/env python3
"""What N federated runtimes on one CUDA card cost, and why.

    python3 scripts/federation_scaling.py [--arch yi-6b] [--runtimes 1,2,3]

Builds the port's engine on a full-width model (``--arch``, default yi-6b;
random bf16 weights from a torch.Generator seeded with 0, one group
``accel:chunk=8:async=2`` on cuda:0, 64 jobs of one request, 512 prompt and
16 decode tokens: chip_smoke.py phase 10's workload), warms it up with one
bare chunk, then runs ``serve_jobs_federated`` once per runtime count, first
with chip_smoke.py's tenants (``gold:weight=10,free:weight=1:quota=8``: the
free tenant's quota holds its jobs back, so batches run narrow) and then
with no tenants (every job admitted at once). Prints one JSON line per run:
wall time, tok/s, chunks and items per chunk (from the run's telemetry),
decode steps (chunks x 15) and wall time per decode step. With the
runtimes' dispatcher threads sharing one interpreter, the wall time per
decode step says whether N runtimes overlap their host work (it falls
with N) or serialize it (it stays or grows). Then 8 jobs without tenants
at the fewest and the most runtimes under ``torch.profiler``: device
busy seconds and idle share, kernel launches and the host seconds spent
in the launch calls (``profile_serve_torch.py``'s ``device_report``, by
``gpubench/trace.py``).
The profiler adds host time per operator, so its idle shares are upper
bounds. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
JOBS, PROMPT, DECODE = 64, 512, 16
TENANTS = "gold:weight=10,free:weight=1:quota=8"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b")
    ap.add_argument("--runtimes", default="1,2,3")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("federation_scaling: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "scripts"))
    from profile_serve_torch import device_report
    from repro_torch import telemetry as telemetry_mod
    from repro_torch.configs.registry import get_config
    from repro_torch.core.types import DeviceKind
    from repro_torch.models import model as M
    from repro_torch.queue import Job
    from repro_torch.serve.engine import GroupDef, HeteroServeEngine
    from repro_torch.tenancy import TenantRegistry

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "torch": torch.__version__}), flush=True)
    dev = torch.device("cuda", 0)
    cfg = get_config(args.arch)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    groups = [GroupDef("accel", DeviceKind.ACCEL, device=dev, fixed_chunk=8,
                       async_depth=2)]
    warm = HeteroServeEngine(cfg, groups, prompt_len=PROMPT,
                             decode_tokens=DECODE, params=params)
    warm.serve(8)
    del warm

    def run(n, tenants, n_jobs=JOBS):
        tel = telemetry_mod.Telemetry()
        eng = HeteroServeEngine(cfg, groups, prompt_len=PROMPT,
                                decode_tokens=DECODE, params=params,
                                telemetry=tel)
        reg = TenantRegistry.parse(tenants) if tenants else None
        names = reg.names() if reg else ["default"]
        jobs = [Job(items=1, tenant=names[i % len(names)])
                for i in range(n_jobs)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        rep = eng.serve_jobs_federated(jobs, runtimes=n, tenants=reg,
                                       timeout_s=600.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if not rep.drained or rep.fed.done != n_jobs:
            raise SystemExit(f"run incomplete: {rep.fed}")
        chunks = sum(v for k, v in tel.registry.snapshot()["counters"]
                     .items() if k.startswith("sched.chunks"))
        steps = chunks * (DECODE - 1)
        return {"arch": args.arch, "runtimes": n, "tenants": tenants,
                "wall_s": wall, "tok_per_s": rep.new_tokens / wall,
                "jobs": n_jobs, "chunks": chunks,
                "items_per_chunk": n_jobs / max(chunks, 1),
                "decode_steps": steps,
                "wall_ms_per_decode_step": 1e3 * wall / max(steps, 1)}

    counts = [int(x) for x in args.runtimes.split(",")]
    for tenants in (TENANTS, None):
        for n in counts:
            print(json.dumps(run(n, tenants)), flush=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    for n in sorted({min(counts), max(counts)}):
        with torch.profiler.profile(activities=acts) as prof:
            out = run(n, None, n_jobs=8)    # a short run: a trace per launch
        dev = device_report(prof, out["wall_s"])
        out.update(profiled=True, device_busy_s=dev["device_busy_s"],
                   idle_share_of_wall=dev["idle_share_of_profiled_wall"],
                   kernel_launches=dev["kernel_launches"],
                   host_launch_s=dev["host_launch_s"],
                   host_us_per_launch=1e6 * dev["host_launch_s"]
                   / max(dev["kernel_launches"], 1))
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
