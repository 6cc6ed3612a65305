"""Reproduce the paper's overhead study (Figs. 2, 5, 6, 7) with the
calibrated simulator: Dynamic vs Bulk-Oracle, 3+1 vs 4+1, priority boost,
and big.LITTLE, on Ivy Bridge / Haswell / Exynos models. The port's
counterpart of ``examples/overhead_analysis.py``: the same simulator, the
same table.

Run:  python examples/torch/overhead_analysis.py
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2] / "src"))

from repro_torch.core import PLATFORMS, bulk_oracle, run_config


def main():
    for plat_name, labels in [("ivy", ["3+1", "4+1"]),
                              ("haswell", ["3+1", "4+1"]),
                              ("exynos", ["3+1", "4+1", "7+1", "8+1"])]:
        plat = PLATFORMS[plat_name]
        base = bulk_oracle(plat, "3+1")
        print(f"\n=== {plat_name} (normalized to Bulk-Oracle 3+1) ===")
        print(f"{'config':24s} {'time':>6s} {'energy':>7s} {'EDP':>6s} "
              f"{'O_td':>6s} {'O_kl':>6s} {'O_hd':>6s}")
        for lbl in labels:
            for mode, kw in [("bulk-oracle", {}),
                             ("dynamic", {}),
                             ("dynamic-pri", {"priority": True}),
                             ("dynamic-async2", {"async_depth": 2})]:
                if mode == "bulk-oracle":
                    r = bulk_oracle(plat, lbl)
                else:
                    r = run_config(plat, lbl, **kw)
                ov = r.overheads
                print(f"{mode + ' ' + lbl:24s} "
                      f"{r.time_ms / base.time_ms:6.3f} "
                      f"{r.energy.total_j / base.energy.total_j:7.3f} "
                      f"{r.edp / base.edp:6.3f} "
                      f"{ov['O_td'] * 100:5.1f}% "
                      f"{ov['O_kl'] * 100:5.1f}% "
                      f"{ov['O_hd'] * 100:5.1f}%")


if __name__ == "__main__":
    main()
