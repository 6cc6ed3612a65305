#!/usr/bin/env python3
"""How far full-width zamba2-1.2b in bf16 drifts from its fp32 self, by
depth, through the CUDA kernels and through their plain versions.

    python3 scripts/hybrid_drift.py [--layers 1,2,3,6,7]

Random weights from a torch.Generator seeded with 0 (as chip_smoke.py's),
cut to the first n Mamba-2 blocks (from 6 on: the first group with the
shared attention block, then tail blocks); a 300-token prompt (b=2) and 4
greedy decode steps. For each depth it prints one JSON line with max
|dlogit| / max |logit| of the kernel run and of the plain versions' bf16
run from the fp32 run (plain versions, TF32 off), of the kernels from the
plain versions, and per step. It needs one CUDA card and exits non-zero
without one.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--layers", default="1,2,3,6,7")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("hybrid_drift: no CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as cs
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    dev = torch.device("cuda", 0)
    cfg = get_config("zamba2-1.2b")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    for n in (int(v) for v in args.layers.split(",")):
        (got, plain, ref), counts, _ = cs.hybrid_runs(dev, cfg, params, n)
        print(json.dumps({
            "n_layers": n, "launches": counts,
            "kernels_vs_fp32": cs.rel_err(got, ref),
            "plain_bf16_vs_fp32": cs.rel_err(plain, ref),
            "kernels_vs_plain": cs.rel_err(got, plain),
            "max_logit_fp32": ref.abs().max().item(),
            "per_step_kernels_vs_fp32": [cs.rel_err(got[i], ref[i])
                                         for i in range(len(ref))],
            "per_step_plain_vs_fp32": [cs.rel_err(plain[i], ref[i])
                                       for i in range(len(ref))]}),
            flush=True)


if __name__ == "__main__":
    main()
