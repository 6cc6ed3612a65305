"""FaultPlan: one seedable, deterministic spec for layered fault drills.

A plan is a flat, time-ordered list of ``FaultEvent``s generated from a
single ``random.Random(seed)`` stream, so the same seed always yields a
byte-identical schedule (``to_json`` round-trips exactly — the
reproduction workflow is "re-run with the seed from the failing soak
row"). Events name a *layer* (executor / journal / federation / queue),
a *kind* within it, a target (group name, runtime id, or ``"*"``), an
onset relative to plan start, and either a window (``duration_s > 0``)
or a one-shot trigger (``duration_s == 0``, consumed once by the first
hook that observes it due).

Kinds by layer (hooks live in repro_torch.chaos.injector and the layers
themselves):

  executor    chunk_exception (one-shot → ChunkFailure), hang (one-shot,
              one chunk sleeps ``magnitude`` seconds so the Watchdog
              trips), slowdown (window, +``magnitude`` seconds per
              chunk)
  journal     corrupt_record / fsync_stall (one-shot, applied to the
              next primary write via the journal's write filter),
              torn_write (one-shot, applied by ``kill_runtime`` as the
              crash-mid-write artifact)
  federation  gossip_drop / gossip_delay / partition (windows on a
              runtime's heartbeat publish), mirror_fail (window on its
              replica sink), kill (one-shot runtime crash)
  queue       clock_skew (window, admission clock + ``magnitude``),
              listener_drop (window, queue arrival notifies swallowed)

The generator keeps three safety constraints so randomized plans stay
inside the no-loss envelope the soak asserts (each is a *real* coverage
gap, documented in README — synchronous replication ack would be the
fix, out of scope here): per runtime, a ``mirror_fail`` window never
overlaps a ``kill``, ``torn_write``, or ``corrupt_record`` on the same
runtime; at most ``len(runtimes) - 1`` kills total; kills land in the
middle 60 % of the horizon so there is work to fail over.
"""
from __future__ import annotations

import json
import random
from dataclasses import asdict, dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

LAYERS = ("executor", "journal", "federation", "queue")

KINDS: Dict[str, Tuple[str, ...]] = {
    "executor": ("chunk_exception", "hang", "slowdown"),
    "journal": ("corrupt_record", "fsync_stall", "torn_write"),
    "federation": ("gossip_drop", "gossip_delay", "partition",
                   "mirror_fail", "kill"),
    "queue": ("clock_skew", "listener_drop"),
}


@dataclass(frozen=True)
class FaultEvent:
    at_s: float                 # onset, seconds from ChaosInjector.start()
    layer: str                  # one of LAYERS
    kind: str                   # one of KINDS[layer]
    target: str                 # group / runtime id / "*"
    duration_s: float = 0.0     # 0 → one-shot, else active window length
    magnitude: float = 0.0      # kind-specific (skew s, lag s, per-chunk s)

    def __post_init__(self):
        if self.layer not in KINDS:
            raise ValueError(f"unknown fault layer {self.layer!r}")
        if self.kind not in KINDS[self.layer]:
            raise ValueError(
                f"unknown {self.layer} fault kind {self.kind!r}")

    @property
    def end_s(self) -> float:
        return self.at_s + self.duration_s

    def matches(self, target: Optional[str]) -> bool:
        return target is None or self.target == "*" \
            or self.target == target


@dataclass
class FaultPlan:
    seed: int
    horizon_s: float
    events: List[FaultEvent] = field(default_factory=list)

    # -- serialization (byte-stable) -----------------------------------
    def to_json(self) -> str:
        """Deterministic: same plan → same bytes (sorted keys, floats
        already rounded by generate())."""
        return json.dumps(
            {"seed": self.seed, "horizon_s": self.horizon_s,
             "events": [asdict(e) for e in self.events]},
            sort_keys=True)

    @classmethod
    def from_json(cls, s: str) -> "FaultPlan":
        d = json.loads(s)
        return cls(seed=int(d["seed"]), horizon_s=float(d["horizon_s"]),
                   events=[FaultEvent(**e) for e in d["events"]])

    # -- hand-authored plans -------------------------------------------
    @classmethod
    def compose(cls, events: Sequence[FaultEvent], horizon_s: float,
                seed: int = -1) -> "FaultPlan":
        """Explicitly composed plan (smoke drills, regression repros);
        ``seed=-1`` marks it as not generator-derived."""
        evs = sorted(events, key=lambda e: (e.at_s, e.layer, e.kind,
                                            e.target))
        return cls(seed=seed, horizon_s=horizon_s, events=evs)

    # -- seeded generation ---------------------------------------------
    @classmethod
    def generate(cls, seed: int, horizon_s: float,
                 runtimes: Sequence[str], groups: Sequence[str],
                 events_per_s: float = 2.0,
                 kinds: Optional[Sequence[Tuple[str, str]]] = None) \
            -> "FaultPlan":
        """Randomized layered schedule from one seeded stream.

        ``kinds`` restricts the (layer, kind) pool; default is every
        hookable kind except ``torn_write`` paired automatically with
        kills (the torn tail is a crash artifact, meaningless without
        one). Deterministic: all randomness comes from
        ``random.Random(seed)``, and floats are rounded to µs so the
        JSON form is byte-stable across platforms.
        """
        rng = random.Random(seed)
        runtimes = list(runtimes)
        groups = list(groups)
        pool = list(kinds) if kinds is not None else [
            ("executor", "chunk_exception"), ("executor", "hang"),
            ("executor", "slowdown"),
            ("journal", "corrupt_record"), ("journal", "fsync_stall"),
            ("federation", "gossip_drop"), ("federation", "gossip_delay"),
            ("federation", "partition"), ("federation", "mirror_fail"),
            ("federation", "kill"),
            ("queue", "clock_skew"), ("queue", "listener_drop"),
        ]
        n_events = max(1, int(events_per_s * horizon_s))
        events: List[FaultEvent] = []
        kills: List[Tuple[str, float]] = []        # (runtime, at_s)
        mirror_windows: List[Tuple[str, float, float]] = []
        max_kills = max(0, len(runtimes) - 1)

        def overlaps_mirror(rid: str, t0: float, t1: float) -> bool:
            return any(r == rid and t0 <= we and t1 >= wb
                       for r, wb, we in mirror_windows)

        for _ in range(n_events):
            layer, kind = pool[rng.randrange(len(pool))]
            at = round(rng.uniform(0.0, horizon_s), 6)
            if layer == "executor":
                target = groups[rng.randrange(len(groups))] if groups \
                    else "*"
                if kind == "chunk_exception":
                    events.append(FaultEvent(at, layer, kind, target))
                elif kind == "hang":
                    # one-shot (duration_s=0): ONE chunk wedges for
                    # ``magnitude`` seconds — long enough to trip a
                    # 0.25s-floor watchdog, short enough to drain past
                    mag = round(rng.uniform(0.3, 0.8), 6)
                    events.append(FaultEvent(at, layer, kind, target,
                                             magnitude=mag))
                else:                              # slowdown
                    dur = round(rng.uniform(0.2, 0.6), 6)
                    mag = round(rng.uniform(0.002, 0.01), 6)
                    events.append(FaultEvent(at, layer, kind, target,
                                             duration_s=dur,
                                             magnitude=mag))
            elif layer == "journal":
                rid = runtimes[rng.randrange(len(runtimes))]
                if kind == "corrupt_record" \
                        and overlaps_mirror(rid, at, at):
                    continue                       # keep a surviving copy
                mag = round(rng.uniform(0.01, 0.05), 6) \
                    if kind == "fsync_stall" else 0.0
                events.append(FaultEvent(at, layer, kind, rid,
                                         magnitude=mag))
            elif layer == "federation":
                rid = runtimes[rng.randrange(len(runtimes))]
                if kind == "kill":
                    if len(kills) >= max_kills \
                            or any(k[0] == rid for k in kills):
                        continue
                    at = round(rng.uniform(0.2 * horizon_s,
                                           0.8 * horizon_s), 6)
                    if overlaps_mirror(rid, at, at):
                        continue                   # replica must be whole
                    kills.append((rid, at))
                    events.append(FaultEvent(at, layer, kind, rid))
                    # crash-mid-write artifact rides along half the time
                    if rng.random() < 0.5:
                        events.append(FaultEvent(at, "journal",
                                                 "torn_write", rid))
                elif kind == "mirror_fail":
                    dur = round(rng.uniform(0.2, 0.5), 6)
                    if any(k[0] == rid and at <= k[1] <= at + dur
                           for k in kills):
                        continue
                    mirror_windows.append((rid, at, at + dur))
                    events.append(FaultEvent(at, layer, kind, rid,
                                             duration_s=dur))
                elif kind == "gossip_delay":
                    dur = round(rng.uniform(0.2, 0.6), 6)
                    mag = round(rng.uniform(0.5, 2.0), 6)
                    events.append(FaultEvent(at, layer, kind, rid,
                                             duration_s=dur,
                                             magnitude=mag))
                else:                              # gossip_drop/partition
                    dur = round(rng.uniform(0.2, 0.6), 6)
                    events.append(FaultEvent(at, layer, kind, rid,
                                             duration_s=dur))
            else:                                  # queue
                rid = runtimes[rng.randrange(len(runtimes))]
                dur = round(rng.uniform(0.2, 0.6), 6)
                mag = round(rng.uniform(-0.5, 0.5), 6) \
                    if kind == "clock_skew" else 0.0
                events.append(FaultEvent(at, layer, kind, rid,
                                         duration_s=dur, magnitude=mag))
        events.sort(key=lambda e: (e.at_s, e.layer, e.kind, e.target))
        return cls(seed=seed, horizon_s=horizon_s, events=events)
