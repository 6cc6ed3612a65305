#!/usr/bin/env python3
"""Where the serving path's time goes on one CUDA card (torch.profiler).

    python3 scripts/profile_serve_torch.py [--arch zamba2-1.2b]

Builds the port's engine on a full-width model (``--arch``, default
stablelm-1.6b; random bf16 weights, one group ``accel:chunk=8:async=2`` on
cuda:0, prompts of 512 tokens, 16 decode tokens), serves 8 requests once to
warm up (which captures the executor's CUDA graphs of the bucket of 8:
the engine serves a CUDA group through graphs only), then serves 16
requests (2 chunks) twice: once bare, for the wall time, and once under
``torch.profiler`` with CPU and CUDA activities. Prints, as JSON lines:

- the graphs' captures and replays, and the capture's seconds;
- the bare and the profiled wall time of the 16 requests;
- the profiled window reduced by ``gpubench/trace.py`` (``device_report``):
  device busy time (the union of all GPU kernel and copy intervals) and
  the idle share of the profiled wall and of the device's first to last
  event, the ten longest device operations, the hand-written kernels'
  launches and seconds, the longest idle gaps by what the host was doing,
  and the number of kernel launches and of graph launches with the host
  time spent in them;
- the split of one chunk (8 prompts), eager (``M.prefill`` /
  ``M.decode_step``) and through the executor's graphs: the wall time of
  its prefill and of its 15 decode steps, each ended by a synchronise.

The profiler adds host time per operator, so the profiled idle share is an
upper bound of the bare run's. Exits non-zero without a CUDA device. For
the benchmark's cells, ``python3 gpubench/run.py --workload <cell> --seed 0
--seconds 40 --trace 1`` reports the same reduction as per-layer metrics.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cuLaunchKernelEx")
GRAPH_LAUNCH_CALLS = ("cudaGraphLaunch", "cuGraphLaunch")


def device_report(prof, wall_s):
    """The profiled window of ``prof`` (a finished ``torch.profiler``
    run), from its device's first event to its last, reduced by
    ``gpubench/trace.py``; ``wall_s`` is the window's wall time."""
    from gpubench.trace import _events, reduce
    events = _events(prof)
    dev = [(s, e) for d, _, s, e in events if d]
    if not dev:
        raise SystemExit("the profiler saw no device event")
    summary = reduce(events, min(s for s, _ in dev), max(e for _, e in dev))

    def host(names):
        return [e - s for d, n, s, e in events if not d and n in names]

    launches, graphs = host(LAUNCH_CALLS), host(GRAPH_LAUNCH_CALLS)
    return {
        "device_busy_s": summary.busy_s, "gpu_window_s": summary.window_s,
        "idle_share_of_profiled_wall": 1.0 - summary.busy_s / wall_s,
        "idle_share_of_gpu_window": summary.idle_share,
        "kernel_launches": len(launches), "host_launch_s": sum(launches),
        "graph_launches": len(graphs), "host_graph_launch_s": sum(graphs),
        "hand_written_kernels": {k: {"launches": len(v), "gpu_s": sum(v)}
                                 for k, v in summary.kernels.items()},
        "gpu_time_by_op": [{"name": n[:90], "gpu_s": t}
                           for n, t in summary.device_ops],
        "idle_gaps": [{"host_event": n[:90], "s": t}
                      for n, t in summary.idle_gaps]}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_serve_torch: no CUDA device")
    from repro_torch.configs.registry import get_config
    from repro_torch.core.types import DeviceKind
    from repro_torch.models import model as M
    from repro_torch.serve.engine import GroupDef, HeteroServeEngine

    dev = torch.device("cuda", 0)
    cfg = get_config(args.arch)
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

    counts = eng.graph_counts.snapshot()
    print(json.dumps({"graphs": {k: counts[k] for k in
                                 ("captures", "replays", "failures",
                                  "capture_log")}}))
    print(json.dumps({
        "arch": cfg.arch_id, "card": torch.cuda.get_device_name(0),
        "requests": bare.requests, "chunks": bare.overheads["accel"]
        ["n_chunks"], "bare_wall_s": bare_s,
        "bare_tok_per_s": bare.new_tokens / bare_s,
        "bare_accel_overheads": bare.overheads["accel"],
        "profiled_wall_s": prof_s}))
    print(json.dumps(device_report(prof, prof_s)))

    tokens = torch.from_numpy(
        np.stack([eng._prompt(i) for i in range(8)])).to(dev)
    prefix = torch.randn(8, cfg.prefix_len, cfg.d_model, device=dev) \
        * 0.02 if cfg.prefix_len else None
    eager = (lambda p, t: M.prefill(cfg, p, t, prefix, max_len=eng.max_len),
             lambda p, c, t: M.decode_step(cfg, p, c, t))
    prefill_fn, decode_fn = eng._fns_for(
        8, eng._executor_for(eng.groups[0]))
    graphed = (lambda p, t: prefill_fn(p, t, prefix), decode_fn)
    for name, (prefill, decode) in (("eager", eager), ("graphed", graphed)):
        with torch.no_grad():
            for _ in range(2):           # the second run's times are kept
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                logits, cache = prefill(params, tokens)
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                for _ in range(15):
                    tok = logits[:, -1].argmax(-1, keepdim=True) \
                        .to(torch.int32)
                    logits, cache = decode(params, cache, tok)
                torch.cuda.synchronize()
                t2 = time.perf_counter()
        print(json.dumps({f"one_chunk_{name}": {
            "prefill_s": t1 - t0, "decode_15_steps_s": t2 - t1,
            "decode_step_s": (t2 - t1) / 15}}))


if __name__ == "__main__":
    main()
