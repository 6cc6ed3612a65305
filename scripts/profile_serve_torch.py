#!/usr/bin/env python3
"""Where the serving path's time goes on one CUDA card (torch.profiler).

    python3 scripts/profile_serve_torch.py

Builds the port's engine on full-width stablelm-1.6b (random bf16 weights,
one group ``accel:chunk=8:async=2`` on cuda:0, prompts of 512 tokens, 16
decode tokens), serves 8 requests once to warm up, then serves 16 requests
(2 chunks) twice: once bare, for the wall time, and once under
``torch.profiler`` with CPU and CUDA activities. Prints, as JSON lines:

- the bare and the profiled wall time of the 16 requests;
- device busy time (the union of all GPU kernel and copy intervals) and
  the idle share of the profiled window;
- GPU time per kernel name, the largest first;
- the number of kernel launches and the host time spent launching them.

The profiler adds host time per operator, so the profiled idle share is an
upper bound of the bare run's. Exits non-zero without a CUDA device.
"""
from __future__ import annotations

import json
import sys
import time
from collections import defaultdict
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def _union_us(intervals):
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve_torch: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    from torch.autograd import DeviceType
    from repro_torch.configs.registry import get_config
    from repro_torch.core.types import DeviceKind
    from repro_torch.models import model as M
    from repro_torch.serve.engine import GroupDef, HeteroServeEngine

    dev = torch.device("cuda", 0)
    cfg = get_config("stablelm-1.6b")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    eng = HeteroServeEngine(
        cfg, [GroupDef("accel", DeviceKind.ACCEL, device=dev, fixed_chunk=8,
                       async_depth=2)],
        prompt_len=512, decode_tokens=16, seed=0, params=params)
    eng.serve(8)                                   # warm-up: one chunk
    torch.cuda.synchronize()

    t0 = time.perf_counter()
    bare = eng.serve(16)
    torch.cuda.synchronize()
    bare_s = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        eng.serve(16)
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0

    events = prof.events()
    gpu = [e for e in events if e.device_type == DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in gpu]
    busy_us = _union_us(spans)
    window_us = (max(e for _, e in spans) - min(s for s, _ in spans)) \
        if spans else 0.0
    per_kernel = defaultdict(lambda: [0, 0.0])
    for e in gpu:
        per_kernel[e.name][0] += 1
        per_kernel[e.name][1] += e.time_range.end - e.time_range.start
    launches = [e for e in events if e.device_type == DeviceType.CPU
                and e.name in ("cudaLaunchKernel", "cuLaunchKernel",
                               "cudaLaunchKernelExC", "cuLaunchKernelEx")]
    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "requests": bare.requests, "chunks": bare.overheads["accel"]
        ["n_chunks"], "bare_wall_s": bare_s,
        "bare_tok_per_s": bare.new_tokens / bare_s,
        "bare_accel_overheads": bare.overheads["accel"],
        "profiled_wall_s": prof_s}))
    print(json.dumps({
        "gpu_events": len(gpu), "device_busy_s": busy_us / 1e6,
        "gpu_window_s": window_us / 1e6,
        "idle_share_of_profiled_wall": 1.0 - busy_us / 1e6 / prof_s,
        "idle_share_of_gpu_window": (1.0 - busy_us / window_us)
        if window_us else None,
        "kernel_launches": len(launches),
        "host_launch_s": sum(e.cpu_time_total for e in launches) / 1e6}))
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1][1])[:15]
    print(json.dumps({"gpu_time_by_kernel": [
        {"name": name[:90], "calls": n, "gpu_s": us / 1e6}
        for name, (n, us) in top]}))


if __name__ == "__main__":
    main()
