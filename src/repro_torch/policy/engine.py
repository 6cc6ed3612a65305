"""AdaptivePolicy: windowed admission smoothing + rebalance cooldown.

Two decision surfaces, both driven by the same sliding-window history:

**Admission** (``admission_delay``): the gate's projected queueing delay
is a point estimate — one fast drain or one slow chunk flips ADMIT/DEFER
for everything behind it. Three history terms fix that:

* *smoothing* — ``max(point, window_ewma)`` reacts instantly when load
  rises (the point sample dominates) but decays slowly when it falls
  (the EWMA holds the gate up through the tail of a burst);
* *trend projection* — a positive least-squares slope over the window
  adds ``slope × lead_s`` to the estimate, so a ramping backlog starts
  deferring *before* it slams into the SLO edge (this is what lowers
  the admitted-tail p99, not just the flip count);
* *hysteresis* — when the caller passes its SLO, the policy is a
  Schmitt trigger: once the estimate crosses the SLO the gate latches
  DEFER and only re-admits after the windowed ``recovery_q`` quantile
  falls below ``slo × (1 - hysteresis)``. Without the latch a backlog
  hovering exactly at the band edge alternates ADMIT/DEFER on every
  sample (the point-gate's worst case).

A sample more than ``spike_threshold`` × the windowed median is counted
as a spike — the telemetry signal operators alarm on.

Gates are keyed: the admission controller passes ``key=`` the tenant
name (or ``"*"`` for the tenant-blind global gate), and each key gets
its own window and latch. One shared window would let a low-weight
tenant's enormous fair-share delay projections poison every other
tenant's smoothed estimate — observed as a high-weight tenant's jobs
being rejected outright the moment a starved tenant shares the gate.

**Rebalance** (``allow_rebalance``): straggler-driven derate maps can
flap when a group hovers around the detection threshold, and every flap
re-advertises capacity to the admission gate. A proposed map that
differs from the applied one by less than ``rebalance_epsilon`` on every
group is a no-op; a significant change lands immediately unless one
landed within the last ``cooldown_s`` — then it's suppressed (and
counted). A *persistent* change is therefore delayed at most one
cooldown period, never starved (property-tested).
"""
from __future__ import annotations

import math
import threading
import time
from typing import Dict, Optional

from repro_torch.policy.window import SlidingWindow


class _GateState:
    """Per-key admission state: one sample window plus the Schmitt
    latch. Keys are admission populations (tenant name, or "*" for the
    global gate) — they share nothing, by design."""

    __slots__ = ("window", "deferring")

    def __init__(self, window_s: float, alpha: float):
        self.window = SlidingWindow(window_s, alpha=alpha)
        self.deferring = False


class AdaptivePolicy:
    def __init__(self, window_s: float = 5.0, spike_threshold: float = 3.0,
                 cooldown_s: float = 1.0, alpha: float = 0.3,
                 min_samples: int = 5, rebalance_epsilon: float = 0.05,
                 lead_s: float = 0.1, hysteresis: float = 0.1,
                 recovery_q: float = 0.9, telemetry=None, clock=None):
        assert window_s > 0.0
        assert spike_threshold >= 1.0
        assert cooldown_s >= 0.0
        assert lead_s >= 0.0
        assert 0.0 <= hysteresis < 1.0
        assert 0.0 <= recovery_q <= 1.0
        self.window_s = window_s
        self.spike_threshold = spike_threshold
        self.cooldown_s = cooldown_s
        self.min_samples = min_samples
        self.rebalance_epsilon = rebalance_epsilon
        self.lead_s = lead_s
        self.hysteresis = hysteresis
        self.recovery_q = recovery_q
        self.telemetry = telemetry
        self.clock = clock if clock is not None else time.monotonic
        self._alpha = alpha
        self._gates: Dict[str, _GateState] = {}
        self.spikes = 0
        self.rebalances = 0
        self.rebalances_suppressed = 0
        self.hysteresis_holds = 0
        self._last_rebalance: Optional[float] = None
        # serializes the rebalance check-then-act (straggler monitor and
        # manual update_stragglers calls can race)
        self._lock = threading.Lock()

    # -- admission -----------------------------------------------------
    def _gate_state(self, key: str) -> _GateState:
        st = self._gates.get(key)
        if st is None:
            st = self._gates[key] = _GateState(self.window_s, self._alpha)
        return st

    @property
    def delay_window(self) -> SlidingWindow:
        """The global ("*") gate's sample window — the only gate in
        registry-less deployments and the virtual-clock benchmarks."""
        return self._gate_state("*").window

    def admission_delay(self, now: float, point: float,
                        slo: Optional[float] = None,
                        key: str = "*") -> float:
        """Fold a point projected-delay sample into ``key``'s window and
        return the smoothed estimate the admission gate should act on.
        With ``slo`` the estimate includes the Schmitt latch: while
        latched, the returned value stays strictly above the SLO even
        when the point sample dips back under it, until the windowed
        ``recovery_q`` quantile clears ``slo × (1 - hysteresis)``.
        Not thread-safe on its own — the admission controller already
        serializes its gate."""
        st = self._gate_state(key)
        w = st.window
        if w.count >= self.min_samples:
            med = w.median(now)
            if med > 0.0 and point > self.spike_threshold * med:
                self.spikes += 1
                if self.telemetry is not None:
                    self.telemetry.registry.counter(
                        "policy.spikes", gate=key).add()
                    self.telemetry.tracer.instant(
                        "policy_spike", tid="policy", gate=key,
                        delay_s=round(point, 6), median_s=round(med, 6))
        w.observe(now, point)
        est = max(point, w.ewma)
        # trend projection — only once the window covers at least the
        # lead time: a slope fit over samples microseconds apart (a
        # submit burst) extrapolates far beyond its data and would
        # reject everything behind the first few arrivals
        if self.lead_s > 0.0 and w.span(now) >= self.lead_s:
            trend = w.slope(now)
            if trend > 0.0:
                est += trend * self.lead_s
        if slo is not None:
            if st.deferring:
                recent = w.quantile(self.recovery_q, now)
                if max(est, recent) > slo * (1.0 - self.hysteresis):
                    if est <= slo:        # the latch, not the estimate,
                        self.hysteresis_holds += 1   # is deciding
                        if self.telemetry is not None:
                            self.telemetry.registry.counter(
                                "policy.hysteresis_holds", gate=key).add()
                    est = max(est, math.nextafter(slo, math.inf))
                else:
                    st.deferring = False
            if est > slo:
                st.deferring = True
        return est

    # -- rebalance gating ----------------------------------------------
    def significant(self, new: Dict[str, float],
                    old: Dict[str, float]) -> bool:
        eps = self.rebalance_epsilon
        for g in set(new) | set(old):
            if abs(new.get(g, 1.0) - old.get(g, 1.0)) > eps:
                return True
        return False

    def allow_rebalance(self, now: float, new: Dict[str, float],
                        old: Dict[str, float]) -> bool:
        """True iff the proposed derate map should be applied now.
        Insignificant changes return False without counting (nothing to
        apply); significant ones inside the cooldown are suppressed and
        counted; otherwise the change is approved and the cooldown
        restarts."""
        if not self.significant(new, old):
            return False
        with self._lock:
            last = self._last_rebalance
            if last is not None and now - last < self.cooldown_s:
                self.rebalances_suppressed += 1
                if self.telemetry is not None:
                    self.telemetry.registry.counter(
                        "policy.rebalances_suppressed").add()
                    self.telemetry.tracer.instant(
                        "rebalance_suppressed", tid="policy",
                        wait_s=round(self.cooldown_s - (now - last), 6))
                return False
            self._last_rebalance = now
            self.rebalances += 1
        if self.telemetry is not None:
            self.telemetry.registry.counter("policy.rebalances").add()
        return True

    def stats(self) -> Dict[str, float]:
        return {
            "spikes": float(self.spikes),
            "rebalances": float(self.rebalances),
            "rebalances_suppressed": float(self.rebalances_suppressed),
            "hysteresis_holds": float(self.hysteresis_holds),
            "deferring": float(any(st.deferring
                                   for st in self._gates.values())),
            "delay_ewma": self.delay_window.ewma,
            "delay_samples": float(sum(st.window.count
                                       for st in self._gates.values())),
        }
