"""Adaptive control policy: decisions from history, not point samples.

The control loops around the scheduler (admission backpressure,
straggler-driven capacity rebalance, refill sizing) originally gated on
point-in-time thresholds — one noisy sample could flip a decision, and
bursty traffic made them oscillate. This package is the GPUScheduler-style
policy/monitor split applied to our stack:

- ``SlidingWindow`` — bounded ring of timestamped samples with a horizon,
  EWMA, and windowed quantiles (``repro_torch.policy.window``).
- ``AdaptivePolicy`` — the decision engine (``repro_torch.policy.engine``):
  a windowed projected-delay view for the admission gate (up fast on
  spikes, down slowly — hysteresis kills decision flapping), spike
  detection counters, and a post-rebalance cooldown so straggler-derate
  churn cannot thrash capacity advertisements.

Consumers: ``AdmissionController(policy=...)``, ``StragglerDetector``
(windowed baselines), and the partitioner's adaptive ``refill_chunks``
sizing (which keeps its own refill/steal history — see
``HeterogeneousPartitioner``). Everything here is stdlib-only and
telemetry-instrumented.
"""
from repro_torch.policy.engine import AdaptivePolicy
from repro_torch.policy.window import SlidingWindow

__all__ = ["AdaptivePolicy", "SlidingWindow"]
