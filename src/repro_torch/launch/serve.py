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
"""
from __future__ import annotations

import argparse
import json

import torch

from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.core.types import DeviceKind
from repro_torch.serve.engine import GroupDef, HeteroServeEngine


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
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: the first group on cuda:0, the others on "
                         "the CPU; cpu: every group on the CPU")
    ap.add_argument("--dtype", choices=["bfloat16", "float32"],
                    default=None,
                    help="activation/parameter dtype (default: the "
                         "config's)")
    args = ap.parse_args(argv)
    if args.requests < 1:
        ap.error("--requests must be >= 1")
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
    eng = HeteroServeEngine(cfg, groups, prompt_len=args.prompt_len,
                            decode_tokens=args.decode_tokens,
                            seed=args.seed, chunk_mode=args.chunk_mode)
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
