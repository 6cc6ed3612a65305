"""Tenant specs and the registry — the contract side of multi-tenancy.

A TenantSpec is the resource-arbitration contract for one tenant:

  weight           relative share of drained work under contention (the
                   DWRR weight; 10:1 weights → 10:1 drained-items share
                   while both tenants are backlogged)
  max_inflight     hard cap on jobs popped-but-not-finished at once; the
                   admission gate defers work beyond it and the sharded
                   queue will not drain past it (per-tenant concurrency
                   isolation)
  slo_delay_s      per-tenant queue-delay SLO used by quota-aware
                   admission instead of the controller's global SLO
  energy_budget_j  soft energy budget: a tenant whose attributed joules
                   exceed it gets its effective DWRR weight derated
                   (budget/spent, floored), not its jobs dropped
  burst_quantum    bounded deficit carry-over in items (DWRR/token-bucket
                   hybrid): when the tenant's shard empties it keeps up
                   to this much banked deficit instead of the classic
                   reset to zero, so a spiky interactive tenant does not
                   re-pay ramp-up each burst; 0 (default) keeps classic
                   DWRR behavior

The registry is deliberately permissive: get() auto-registers unknown
tenants with a default spec so a single-tenant deployment (everything
under ``tenant="default"``) needs zero configuration and behaves exactly
like the unsharded queue.

This module must stay import-free of ``repro_torch.queue`` — admission imports
the registry type only lazily/duck-typed, and a spec file is parseable
without pulling the runtime in.
"""
from __future__ import annotations

import json
import threading
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional

DEFAULT_TENANT = "default"


@dataclass(frozen=True)
class TenantSpec:
    name: str
    weight: float = 1.0
    max_inflight: Optional[int] = None
    slo_delay_s: Optional[float] = None
    energy_budget_j: Optional[float] = None
    burst_quantum: float = 0.0

    def __post_init__(self):
        if not self.name:
            raise ValueError("tenant name must be non-empty")
        if self.weight <= 0.0:
            raise ValueError(f"tenant {self.name}: weight must be > 0")
        if self.max_inflight is not None and self.max_inflight < 1:
            raise ValueError(f"tenant {self.name}: max_inflight must be >= 1")
        if self.burst_quantum < 0.0:
            raise ValueError(
                f"tenant {self.name}: burst_quantum must be >= 0")

    def as_dict(self) -> Dict:
        return {"name": self.name, "weight": self.weight,
                "max_inflight": self.max_inflight,
                "slo_delay_s": self.slo_delay_s,
                "energy_budget_j": self.energy_budget_j,
                "burst_quantum": self.burst_quantum}


def _parse_one(token: str) -> TenantSpec:
    """``name[:weight=W][:quota=N][:slo=S][:energy=J][:burst=B]`` →
    TenantSpec."""
    parts = token.strip().split(":")
    name, kw = parts[0], {}
    keys = {"weight": ("weight", float),
            "quota": ("max_inflight", int),
            "slo": ("slo_delay_s", float),
            "energy": ("energy_budget_j", float),
            "burst": ("burst_quantum", float)}
    for p in parts[1:]:
        if "=" not in p:
            raise ValueError(f"tenant spec {token!r}: bad field {p!r}")
        k, v = p.split("=", 1)
        if k not in keys:
            raise ValueError(f"tenant spec {token!r}: unknown field {k!r}")
        attr, cast = keys[k]
        kw[attr] = cast(v)
    return TenantSpec(name, **kw)


class TenantRegistry:
    """Thread-safe name → TenantSpec map with auto-registration."""

    def __init__(self, specs: Iterable[TenantSpec] = ()):
        self._specs: Dict[str, TenantSpec] = {}
        self._lock = threading.Lock()
        for s in specs:
            self.register(s)

    # -- construction ---------------------------------------------------
    @classmethod
    def parse(cls, text: str) -> "TenantRegistry":
        """CLI form: ``gold:weight=10,free:weight=1:quota=8:slo=2.0``."""
        return cls(_parse_one(t) for t in text.split(",") if t.strip())

    @classmethod
    def from_file(cls, path: str) -> "TenantRegistry":
        """JSON spec file: a list of objects or ``{"tenants": [...]}``."""
        with open(path, "r", encoding="utf-8") as fh:
            data = json.load(fh)
        if isinstance(data, dict):
            data = data.get("tenants", [])

        def opt(value, cast):
            # cast here so a string value raises ValueError (which CLI
            # callers turn into a usage error), not a TypeError later
            # from a spec-validation comparison
            return None if value is None else cast(value)

        specs = []
        for d in data:
            specs.append(TenantSpec(
                name=d["name"], weight=float(d.get("weight", 1.0)),
                max_inflight=opt(d.get("max_inflight"), int),
                slo_delay_s=opt(d.get("slo_delay_s"), float),
                energy_budget_j=opt(d.get("energy_budget_j"), float),
                burst_quantum=float(d.get("burst_quantum", 0.0))))
        return cls(specs)

    # -- access ---------------------------------------------------------
    def register(self, spec: TenantSpec) -> TenantSpec:
        with self._lock:
            self._specs[spec.name] = spec
            return spec

    def get(self, name: str) -> TenantSpec:
        """Spec for ``name``; unknown tenants are auto-registered with the
        default contract (weight 1, no quota/SLO/budget) so single-tenant
        callers never have to touch the registry."""
        with self._lock:
            spec = self._specs.get(name)
            if spec is None:
                spec = self._specs[name] = TenantSpec(name)
            return spec

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._specs)

    def any_gating(self) -> bool:
        """True when any spec carries an admission-gate contract (SLO or
        in-flight quota) — callers use it to enable the admission
        controller even when no global SLO was configured, so a tenant's
        ``slo=``/``quota=`` is never silently inert."""
        with self._lock:
            return any(s.slo_delay_s is not None or s.max_inflight is not None
                       for s in self._specs.values())

    def __contains__(self, name: str) -> bool:
        with self._lock:
            return name in self._specs

    def __len__(self) -> int:
        with self._lock:
            return len(self._specs)

    def as_dict(self) -> Dict[str, Dict]:
        with self._lock:
            return {n: s.as_dict() for n, s in sorted(self._specs.items())}
