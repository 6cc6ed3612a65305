"""Serving example: batched requests scheduled across heterogeneous groups
(prefill + decode bursts), with the accelerator batch tuned like the paper's
GPU chunk. The port's counterpart of ``examples/serve_hetero.py``: group
``accel`` runs on ``--device`` (the card by default, through the CUDA
kernels), ``cpu0`` on the CPU.

Run:  python examples/torch/serve_hetero.py [--device cpu]
"""
import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

import torch

from repro_torch.configs.registry import get_reduced_config
from repro_torch.core.types import DeviceKind
from repro_torch.serve.engine import GroupDef, HeteroServeEngine


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
    eng = HeteroServeEngine(cfg, groups, prompt_len=24, decode_tokens=6)
    rep = eng.serve(48)
    print(f"{rep.requests} requests -> {rep.new_tokens} tokens "
          f"in {rep.time_s:.2f}s "
          f"({rep.new_tokens / rep.time_s:.1f} tok/s)")
    print("split:", rep.per_group_items)
    ov = rep.overheads.get("accel", {})
    print("accel offload overheads:",
          {k: round(v, 4) for k, v in ov.items()})
    return rep


if __name__ == "__main__":
    main()
