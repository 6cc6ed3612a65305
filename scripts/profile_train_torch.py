#!/usr/bin/env python3
"""Where a training step's time goes on one CUDA card, eager and through
the trainer's CUDA graphs (torch.profiler).

    python3 scripts/profile_train_torch.py [--arch zamba2-1.2b]
        [--seq 512] [--batch 32]

Builds ``HeteroTrainer`` on a full-width model (``--arch``, default
stablelm-1.6b; random bf16 weights from a torch.Generator seeded with 0),
one group ``accel:chunk=8:async=2`` on cuda:0, ``--batch`` examples of
``--seq`` tokens a step, the same examples every step. Twice from the same
weights: once with every chunk's step eager, once as the trainer runs it
on a CUDA group (one graph of the step per bucket, replayed a chunk).
Each run takes one step to warm up (the graphed run's capture is in it),
one step bare for the wall time, and one step under ``torch.profiler``
with CPU and CUDA activities. Prints, as JSON lines per run:

- the bare and the profiled step's wall time, and trained tokens/s;
- the profiled window reduced by ``gpubench/trace.py`` (as
  ``profile_serve_torch.py``'s ``device_report``): device busy time and
  idle share, the longest device operations and idle gaps, the
  hand-written kernels' launches and seconds, and the kernel and graph
  launches on the host with the host time spent in them;
- the graphed run's captures, replays and each capture's seconds and
  pool bytes.

The profiler adds host time per operator, so the profiled idle share is an
upper bound of the bare run's. Exits non-zero without a CUDA device. For
the benchmark's training cell, ``python3 gpubench/run.py --workload
stablelm-1.6b.train --seed 0 --seconds 40 --trace 1`` reports the same
reduction as per-layer metrics.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from functools import partial
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def _profile(run_step):
    """(profiled wall s, the finished profiler)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run_step()
        torch.cuda.synchronize()
        prof_s = time.perf_counter() - t0
    return prof_s, prof


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=32)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_torch: no CUDA device")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "scripts"))
    from profile_serve_torch import device_report
    from repro_torch.configs.registry import get_config
    from repro_torch.core.types import DeviceKind
    from repro_torch.models import model as M
    from repro_torch.train.optimizer import OptConfig, tree_map
    from repro_torch.train.train_step import chunk_grad_step
    from repro_torch.train.trainer import GroupDef, HeteroTrainer

    class EagerTrainer(HeteroTrainer):
        def _grad_fn(self, ex, b):
            return partial(chunk_grad_step, self.cfg)

    dev = torch.device("cuda", 0)
    cfg = get_config(args.arch)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    for mode, cls in (("eager", EagerTrainer), ("graphed", HeteroTrainer)):
        tr = cls(cfg, [GroupDef("accel", DeviceKind.ACCEL, device=dev,
                                fixed_chunk=8, async_depth=2)],
                 seq_len=args.seq, global_batch=args.batch,
                 oc=OptConfig(lr=1e-3, warmup_steps=1, total_steps=3),
                 seed=0, repeat_data=True,
                 params=tree_map(torch.clone, params))
        t0 = time.perf_counter()
        tr.train_step()                          # warm-up (and capture)
        torch.cuda.synchronize()
        warm_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        tr.train_step()
        torch.cuda.synchronize()
        bare_s = time.perf_counter() - t0
        prof_s, prof = _profile(tr.train_step)
        snap = tr.graph_counts.snapshot()
        print(json.dumps({
            "arch": cfg.arch_id, "mode": mode,
            "card": torch.cuda.get_device_name(0), "seq": args.seq,
            "batch": args.batch, "first_step_s": warm_s,
            "bare_step_s": bare_s,
            "bare_tok_per_s": args.batch * args.seq / bare_s,
            "graphs": {k: snap[k] for k in ("captures", "replays",
                                            "failures", "capture_log")},
            "profiled_wall_s": prof_s, **device_report(prof, prof_s)}))
        del tr, prof
        gc.collect()            # the executors' closures hold the trainer
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
