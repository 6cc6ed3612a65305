"""End-to-end heterogeneous training launcher (torch counterpart of
``repro.launch.train``).

  PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
      --reduced --steps 200 --global-batch 32 --seq-len 64 \\
      --groups accel:async=2,cpu:slow=2.5 --tune-chunk --ckpt-dir ck

The first group runs on the card (``cuda:0``) and the others on the CPU.
``--device cpu`` runs every group on the CPU; without it, a machine with no
CUDA device is an error, never a silent fall-back. The CUDA kernels take
bfloat16, so a config of another dtype trains only with ``--device cpu``.
Groups syntax: name[:k=v,...] where kind is inferred (first group = accel),
knobs: async=<depth>, slow=<factor>, chunk=<fixed>, pri=1. Checkpoints are
the JAX package's format: either package resumes from the other's.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.base import reduced
from repro_torch.configs.registry import get_config
from repro_torch.core.energy import EnergyModel, PowerSpec
from repro_torch.core.types import DeviceKind
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import GroupDef, HeteroTrainer


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
    ap.add_argument("--reduced", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--global-batch", type=int, default=32)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--groups", default="accel:async=2,cpu0")
    ap.add_argument("--tune-chunk", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: the first group on cuda:0, the others on "
                         "the CPU; cpu: every group on the CPU")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.device == "cuda" and cfg.dtype != "bfloat16":
        ap.error(f"{cfg.arch_id} is {cfg.dtype}: the CUDA kernels take "
                 f"bfloat16; pass --device cpu to train {cfg.dtype} on the "
                 f"CPU")
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA GPU is available (torch.cuda.is_available() is "
                 "False); pass --device cpu to train on the CPU")
    groups = parse_groups(args.groups)
    for i, g in enumerate(groups):
        g.device = torch.device("cuda", 0) \
            if args.device == "cuda" and i == 0 else torch.device("cpu")
    oc = OptConfig(lr=args.lr, warmup_steps=args.warmup,
                   total_steps=args.steps)
    trainer = HeteroTrainer(cfg, groups, seq_len=args.seq_len,
                            global_batch=args.global_batch, oc=oc,
                            seed=args.seed)

    ck = Checkpointer(args.ckpt_dir) if args.ckpt_dir else None
    if ck and args.resume and ck.latest_step() is not None:
        tree, meta = ck.restore()
        trainer.load_state(tree["params"], tree["opt"], meta["step"])
        print(f"resumed from step {meta['step']}")

    if args.tune_chunk:
        G = trainer.tune_accel_chunk()
        print(f"tuned accel chunk G = {G}")

    energy = EnergyModel({g.name: PowerSpec(200.0, 75.0) for g in groups})
    t0 = time.time()
    while trainer.step_idx < args.steps:
        rep = trainer.train_step()
        acc_ov = rep.overheads.get(groups[0].name, {})
        print(f"step {rep.step:4d} loss {rep.loss:.4f} "
              f"({rep.time_s:.2f}s, items {rep.per_group_items}, "
              f"O_td {acc_ov.get('O_td', 0) * 100:.1f}%)", flush=True)
        if ck and rep.step % args.ckpt_every == 0:
            ck.save_async(rep.step,
                          {"params": trainer.params, "opt": trainer.opt})
    if ck:
        ck.wait()
        ck.save(trainer.step_idx,
                {"params": trainer.params, "opt": trainer.opt})
    wall = time.time() - t0
    busy = {}
    for rep in trainer.history:
        for g, n in rep.per_group_items.items():
            busy[g] = busy.get(g, 0.0) + n * 1e-3
    erep = energy.energy(wall, busy)
    print(json.dumps({"wall_s": wall, "final_loss": trainer.history[-1].loss,
                      "energy_model_j": erep.total_j, "edp": erep.edp}))


if __name__ == "__main__":
    main()
