"""Readings from which a cell's correctness limits are set: the program's
on many seeds, and the control's and the planted faults' on some.

    python3 gpubench/control.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3]

One process, one card. For each seed it builds the cell's set-up as a run
does and reads the numbers a run compares:

- serving: the program's served-token gaps on a sample of a call of
  chunk x async requests after the set-up (at the cell's own batch and
  lengths), and on the control seeds the control's: the float32
  reference's gap of the token that the same reference computed in fp8
  puts first, at the same positions of the same prompts and tokens;
- training: the program's first three steps against the reference's, and
  on the control seeds the reference computed in fp8 and the reference
  with half of each batch left out (a planted fault), against the float32
  reference. A step that leaves the weights unchanged reads 1 by the
  measure and needs no run.

Each reading is one JSON line on standard output. Where the cell has its
limits file, each of the program's, the control's and the faults'
readings is judged as a run is (``check.judge``) and carries its
``correct``; the command exits non-zero where the program reads not
correct, or the control or a fault reads correct.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _free(device):
    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def serve_readings(drv, seed: int, control: bool):
    from gpubench import check
    from gpubench.reference.layers import Precision, float32_matmuls
    m = drv.mix
    drv.setup()
    calls = m["chunk"] * m["async"]
    rep = drv.engine.serve(calls)
    pick = check.sample_requests(seed, calls, m["check_requests"])
    served = {i: rep.tokens_out[i] for i in pick if i in rep.tokens_out}
    del drv.engine, rep
    _free(drv.device)
    float32_matmuls()
    out = {"program": check.served_gaps(
        drv.family, drv.config, drv.params, seed, m["prompt_len"], served,
        drv.device, Precision("float32"), rows=m["check_rows"])}
    if control:
        out["control_fp8"] = check.served_gaps(
            drv.family, drv.config, drv.params, seed, m["prompt_len"],
            served, drv.device, Precision("float32"), rows=m["check_rows"],
            rival=Precision("fp8"))
    return {k: dict(check.gap_numbers(v), attempted=len(pick),
                    failed=len(pick) - len(served),
                    share_not_best=float((v > 0).mean()),
                    max_gap_per_request=[float(x) for x in v.max(axis=1)],
                    tokens=int(v.size)) for k, v in out.items()}


def train_readings(drv, seed: int, control: bool):
    from gpubench import check, weights
    from gpubench.reference import training
    from gpubench.reference.layers import Precision, float32_matmuls
    m = drv.mix
    drv.setup()
    drv.release()
    _free(drv.device)
    float32_matmuls()

    def ref(prec, keep_rows=None):
        params = weights.make(drv.family.param_specs(drv.config), seed,
                              drv.device)
        got = training.readings(drv.family, drv.config, params, seed,
                                m["seq_len"], m["global_batch"], m["opt"],
                                m["check_steps"], drv.device, prec,
                                rows=m["check_rows"], keep_rows=keep_rows)
        del params
        _free(drv.device)
        return got

    base = ref(Precision("float32"))
    steps = dict(attempted=m["check_steps"], failed=0)
    out = {"program": dict(check.training_numbers(drv.readings, base),
                           **steps)}
    if control:
        out["control_fp8"] = dict(check.training_numbers(
            ref(Precision("fp8")), base), **steps)
        out["fault_half_batch"] = dict(check.training_numbers(
            ref(Precision("float32"), keep_rows=m["global_batch"] // 2),
            base), **steps)
    out["losses"] = {"program": drv.readings["loss"], "reference":
                     base["loss"]}
    return out


#: the readings that a sound limit has to pass, and those it has to fail
PASS, FAIL = ("program",), ("control_fp8", "fault_half_batch")


def judged(got: dict, limits: dict, seed: int) -> bool:
    """Each reading of ``got`` judged under ``limits`` as a run is, its
    ``correct`` set in place and printed beside its numbers on standard
    error; whether every one came out as it has to."""
    from gpubench import check
    sound = True
    for name in PASS + FAIL:
        if name not in got:
            continue
        r = got[name]
        r["correct"], checks = check.judge(r["attempted"], r["failed"], r,
                                           limits)
        sound &= r["correct"] == (name in PASS)
        print(f"control: seed {seed} {name} correct {r['correct']}: "
              + ", ".join(f"{k} {c['value']!r} limit {c['limit']!r}"
                          for k, c in checks.items()), file=sys.stderr)
    return sound


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    from gpubench import bench
    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    spec = bench.Benchmark(ROOT)
    cell = spec.cell(args.workload)
    config, mix = spec.config(cell), spec.mix(cell)
    dev = torch.device("cuda", 0)
    limits = (spec.limits(cell)
              if (spec.dir / "limits" / f"{cell['name']}.json").exists()
              else None)
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    sound = True
    for seed in seeds + sorted(ctl - set(seeds)):
        t0 = time.perf_counter()
        drv = bench.driver_class(mix)(config, mix, seed, dev)
        read = serve_readings if drv.kind == "serve" else train_readings
        got = read(drv, seed, seed in ctl)
        del drv
        _free(dev)
        if limits is not None:
            sound &= judged(got, limits, seed)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "seconds": time.perf_counter() - t0, **got}),
              flush=True)
    if not sound:
        print("control: the limits do not part the program from the "
              "control and the faults", file=sys.stderr)
    return 0 if sound else 1


if __name__ == "__main__":
    sys.exit(main())
