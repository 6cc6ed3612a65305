"""Tiny cells for the CPU tests: a copy of the benchmark's files under a
temporary root, with a small configuration of the dense family, small
serving and training mixes, and the cells that pair them. The limits are the real
cells' own."""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

SMALL = dict(d_model=64, n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128,
             vocab=256)
SERVE = {"driver": "serve_batch", "prompt_len": 16, "decode_tokens": 6,
         "requests": 16, "chunk": 4, "async": 2, "traced_requests": 8,
         "check_requests": 4,
         "check_rows": 2}
TRAIN = {"driver": "train", "seq_len": 16, "global_batch": 8, "chunk": 4,
         "async": 2, "traced_steps": 1, "check_steps": 3, "check_rows": 4,
         "opt": {"lr": 1e-3, "beta1": 0.9, "beta2": 0.95, "eps": 1e-8,
                 "weight_decay": 0.1, "clip_norm": 1.0, "warmup_steps": 1,
                 "total_steps": 10000, "min_lr_frac": 0.1}}
#: tiny cell -> (configuration, mix, the real cell whose limits it takes)
CELLS = {"tiny-dense.serve": ("tiny-dense", "tiny-serve",
                              "stablelm-1.6b.decode"),
         "tiny-dense.train": ("tiny-dense", "tiny-train",
                              "stablelm-1.6b.train")}


def tiny_config(src: str, name: str, **over) -> dict:
    c = json.loads((ROOT / "gpubench" / "configs" / f"{src}.json")
                   .read_text())
    c.update(SMALL, name=name, n_layers=2, **over)
    return c


def make_root(tmp: Path) -> Path:
    """A checkout's benchmark files under ``tmp``, with the tiny cells."""
    root = Path(tmp)
    shutil.copytree(ROOT / "gpubench", root / "gpubench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    doc = json.loads((ROOT / "BENCHMARK.json").read_text())
    g = root / "gpubench"
    (g / "configs" / "tiny-dense.json").write_text(json.dumps(
        tiny_config("stablelm-1.6b", "tiny-dense")))
    (g / "traffic" / "tiny-serve.json").write_text(json.dumps(SERVE))
    (g / "traffic" / "tiny-train.json").write_text(json.dumps(TRAIN))
    for cell, (config, mix, real) in CELLS.items():
        doc["workloads"].append({"name": cell, "config": config,
                                 "traffic": mix, "chips": 1, "why": "test"})
        shutil.copy(g / "limits" / f"{real}.json",
                    g / "limits" / f"{cell}.json")
        for m in doc["end_to_end"] + doc["per_layer"]:
            if real in m.get("workloads", []):
                m["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(doc, indent=1))
    return root


def run_cpu(root: Path, cell: str, seed: int = 5, trace: bool = False,
            seconds: float = 0.2) -> dict:
    """One run of a tiny cell on the CPU, in this process."""
    import torch
    from gpubench import bench
    torch.manual_seed(0)
    return bench.run(root, cell, seed, seconds, trace, "cpu",
                     time.monotonic())
