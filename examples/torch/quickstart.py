"""Quickstart: the paper's Dynamic scheduler in 60 lines.

Schedules a 20k-iteration parallel loop across one "accelerator" group and
two CPU groups (one deliberately slow), prints the throughput-proportional
split and the §3.3 overhead ledger, then shows the §3.2 chunk search and the
energy/EDP report. The port's counterpart of ``examples/quickstart.py``;
every executor sleeps, so it needs no device.

Run:  python examples/torch/quickstart.py
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.core import (DeviceKind, DynamicScheduler, EnergyModel,
                              GroupSpec, PowerSpec, SleepExecutor,
                              occupancy_seed, search_chunk)


def main():
    # --- 1. device groups: one accel (fixed tuned chunk G) + two CPU ---
    groups = {
        "accel": GroupSpec("accel", DeviceKind.ACCEL, fixed_chunk=512,
                           init_throughput=400_000),
        "cpu0": GroupSpec("cpu0", DeviceKind.BIG, init_throughput=100_000,
                          min_chunk=8),
        "cpu1": GroupSpec("cpu1", DeviceKind.BIG, init_throughput=100_000,
                          min_chunk=8),
    }
    executors = {
        "accel": SleepExecutor(rate=400_000, t_kl=0.0005),  # 0.5ms launch
        "cpu0": SleepExecutor(rate=100_000),
        "cpu1": SleepExecutor(rate=50_000),                # straggler!
    }

    sched = DynamicScheduler(groups, executors, alpha=0.5)
    res = sched.run(0, 20_000)

    print(f"scheduled {res.iterations} iterations in {res.total_time:.3f}s")
    print("split:", res.per_group_items)
    print("measured λ:",
          {k: f"{v:,.0f}/s" for k, v in res.throughput.items()})
    print("accel overheads (fractions of total time):")
    for k, v in res.overheads["accel"].items():
        print(f"  {k:12s} {v:.4f}")

    # --- 2. the §3.2 chunk-size search (occupancy-seeded hill climb) ---
    seed = occupancy_seed(n_units=8, per_unit_quantum=16)   # = 128

    def measured_throughput(chunk):   # synthetic λ(chunk) curve, peak 512
        occ = min(1.0, chunk / 512)
        cache = 1.0 if chunk <= 512 else 1.0 / (1 + 0.4 * (chunk / 512 - 1))
        return 400_000 * occ * cache

    trace = search_chunk(measured_throughput, seed)
    print(f"\nchunk search: tried {[c for c, _ in trace.tried]} "
          f"-> G = {trace.best_chunk}")

    # --- 3. energy / EDP ----------------------------------------------
    model = EnergyModel({"accel": PowerSpec(200, 75),
                         "cpu0": PowerSpec(30, 10),
                         "cpu1": PowerSpec(30, 10)})
    rep = model.energy_from_records(res.total_time, res.records)
    print(f"\nenergy {rep.total_j:.1f} J, EDP {rep.edp:.2f} J·s")

    # split a one-shot run's bill across consumers (for the pipelined
    # serve drain, TenantAccountant does this continuously with marginal
    # energy)
    bill = model.attribute(rep, {"team-a": 0.75, "team-b": 0.25})
    print("attributed: " + ", ".join(f"{who} {j:.1f} J"
                                     for who, j in sorted(bill.items())))
    return res


if __name__ == "__main__":
    main()
