"""Energy accounting and EDP — the paper's §4.1.1 methodology.

The paper integrates INA231 power samples over time per rail (A15/A7/GPU/
DRAM). We integrate the scheduler timeline instead: every device group has an
active and an idle power; energy = Σ_g (P_active·t_busy + P_idle·t_idle) +
P_base·T. EDP = E·T (Gonzales & Horowitz).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional

from repro_torch.core.types import ChunkRecord


@dataclass(frozen=True)
class PowerSpec:
    active_w: float
    idle_w: float


@dataclass
class EnergyReport:
    total_time_s: float
    per_group_j: Dict[str, float]
    base_j: float
    total_j: float = 0.0

    def __post_init__(self):
        self.total_j = self.base_j + sum(self.per_group_j.values())

    @property
    def edp(self) -> float:
        return self.total_j * self.total_time_s

    def as_dict(self) -> Dict:
        return {"time_s": self.total_time_s, "energy_j": self.total_j,
                "edp": self.edp, "per_group_j": dict(self.per_group_j)}


class EnergyModel:
    def __init__(self, specs: Dict[str, PowerSpec], base_w: float = 0.0):
        self.specs = dict(specs)
        self.base_w = base_w

    def energy(self, total_time_s: float,
               busy_s: Dict[str, float]) -> EnergyReport:
        per = {}
        for g, spec in self.specs.items():
            b = min(busy_s.get(g, 0.0), total_time_s)
            per[g] = spec.active_w * b + spec.idle_w * (total_time_s - b)
        return EnergyReport(total_time_s, per, self.base_w * total_time_s)

    def energy_from_records(self, total_time_s: float,
                            records: Iterable[ChunkRecord]) -> EnergyReport:
        busy: Dict[str, float] = {}
        for r in records:
            busy[r.token.group] = busy.get(r.token.group, 0.0) \
                + max(r.device_time, 0.0)
        return self.energy(total_time_s, busy)

    def busy_energy_j(self, busy_s: Dict[str, float]) -> float:
        """Active-power energy of the given busy seconds only — no idle or
        base term. This is the *marginal* energy of a slice of work, safe
        to sum across overlapping wall-clock windows (idle/base power is a
        cost of the window, so charging it per overlapping batch would
        double-bill it; see TenantAccountant)."""
        return sum(self.specs[g].active_w * b
                   for g, b in busy_s.items() if g in self.specs)

    def attribute(self, report: EnergyReport,
                  shares: Dict[str, float]) -> Dict[str, float]:
        """Split a report's joules across consumers (tenants) by share.

        Active, idle, and base energy are all attributed proportionally:
        during a shared batch every tenant's work keeps the package out of
        its low-power state, so idle/base joules are a cost of running the
        batch at all, borne in proportion to use (the per-rail integration
        of §4.1.1 has no finer tenant signal to offer). Shares should sum
        to 1; they are normalized defensively if they do not.
        """
        total_share = sum(shares.values())
        if total_share <= 0.0:
            return {}
        return {who: report.total_j * (s / total_share)
                for who, s in shares.items()}
