"""End-to-end example: train a (reduced) stablelm-family LM for a few hundred
steps with the heterogeneous dynamic scheduler — an accelerator group with
dispatch-ahead plus a slower CPU group, with checkpointing and automatic
straggler rebalancing. The port's counterpart of
``examples/train_hetero_lm.py``: group ``accel`` trains on ``--device``
(the card by default, through the CUDA kernels), ``cpu0`` on the CPU.

Run:  python examples/torch/train_hetero_lm.py [--steps 200] [--device cpu]
"""
import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.registry import get_reduced_config
from repro_torch.core.types import DeviceKind
from repro_torch.train.optimizer import OptConfig
from repro_torch.train.trainer import GroupDef, HeteroTrainer


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where group accel trains (cpu0 is always the CPU)")
    args = ap.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("no CUDA GPU is available; pass --device cpu")

    cfg = get_reduced_config(args.arch)
    groups = [
        GroupDef("accel", DeviceKind.ACCEL, device=args.device,
                 async_depth=2),
        GroupDef("cpu0", DeviceKind.BIG, device="cpu", slowdown=2.5),
    ]
    tr = HeteroTrainer(cfg, groups, seq_len=64, global_batch=32,
                       oc=OptConfig(lr=1e-3, warmup_steps=10,
                                    total_steps=args.steps),
                       repeat_data=False)
    G = tr.tune_accel_chunk(seed_chunk=4)
    print(f"tuned accelerator chunk G = {G}")

    ckdir = tempfile.mkdtemp(prefix="hetero_ck_")
    ck = Checkpointer(ckdir)
    for _ in range(args.steps):
        rep = tr.train_step()
        if rep.step % 10 == 0 or rep.step == 1:
            lam = ", ".join(f"{k}:{v:.0f}" for k, v in rep.throughput.items())
            print(f"step {rep.step:4d}  loss {rep.loss:.4f}  "
                  f"split {rep.per_group_items}  λ {{{lam}}}")
        if rep.step % 20 == 0:
            ck.save_async(rep.step, {"params": tr.params, "opt": tr.opt})
    ck.wait()
    print(f"final loss {tr.history[-1].loss:.4f} "
          f"(start {tr.history[0].loss:.4f}); checkpoints in {ckdir}")
    assert tr.history[-1].loss < tr.history[0].loss
    return tr


if __name__ == "__main__":
    main()
