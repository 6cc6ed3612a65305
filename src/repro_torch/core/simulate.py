"""Discrete-event simulator of the offload timeline (paper §§3–5).

Reproduces the paper's experiments without 2015 hardware: compute threads and
the accelerator's host thread advance on a shared event heap; the OS wake-up
policy ("rr" Windows vs "fair" Linux) governs the thread-dispatch delay the
paper identified as the dominant overhead; energy integrates per-rail power
over busy/idle intervals exactly like the paper's sampling library.

Scheduler modes:
  dynamic      the paper's Dynamic (per-device chunks, eqs. 3–4)
  bulk         static split: accelerator gets one bulk chunk of frac·N,
               CPU threads dynamically share the rest (Bulk baseline;
               the *oracle* sweeps frac and keeps the best: oracle.py)

Optimizations:
  priority     Dynamic Pri: host thread preempts on wake (eps dispatch)
  host_pin     "big" | "little": which core class hosts the dispatcher
  async_depth  ≥2 = TPU-idiomatic dispatch-ahead (beyond-paper; subsumes Pri)
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.core.energy import EnergyModel, EnergyReport, PowerSpec
from repro_torch.core.overheads import OverheadLedger
from repro_torch.core.platforms import Platform
from repro_torch.core.types import Chunk, ChunkRecord, DeviceKind, GroupSpec, \
    IterationSpace, Token


@dataclass
class SimConfig:
    n_big: int = 3                 # compute threads on big cores
    n_little: int = 0              # compute threads on little cores
    host_pin: str = "big"          # where the host (dispatcher) thread lives
    priority: bool = False         # Dynamic Pri
    scheduler: str = "dynamic"     # dynamic | bulk
    bulk_frac: Optional[float] = None
    G: Optional[int] = None        # accelerator chunk (default platform G_opt)
    timesteps: int = 15
    n_iterations: int = 100_000
    async_depth: int = 1           # ≥2: dispatch-ahead (beyond-paper)

    @property
    def label(self) -> str:
        return f"{self.n_big + self.n_little}+1"


@dataclass
class SimResult:
    time_ms: float
    energy: EnergyReport
    overheads: Dict[str, float]
    per_device_items: Dict[str, int]
    n_gpu_chunks: int
    config: SimConfig

    @property
    def edp(self) -> float:
        return self.energy.edp

    def as_dict(self) -> Dict:
        return {"time_ms": self.time_ms, "energy_j": self.energy.total_j,
                "edp": self.edp, "overheads": self.overheads,
                "per_device_items": self.per_device_items}


def _oversubscribed(plat: Platform, cfg: SimConfig) -> bool:
    """Is there no idle core for the host thread to run on?"""
    cores = {"big": plat.n_big, "little": plat.n_little}
    used = {"big": cfg.n_big, "little": cfg.n_little}
    if cfg.host_pin == "little" and plat.n_little:
        return used["little"] >= cores["little"]
    return used["big"] >= cores["big"]


def _wake_delay(plat: Platform, cfg: SimConfig) -> float:
    """Host-thread dispatch latency after device completion (the O_td root
    cause, §4.2): under RR with no idle core and no priority boost the host
    waits ~a ready-queue slice; otherwise it dispatches in ~eps."""
    if cfg.priority:
        return plat.eps_ms
    if not _oversubscribed(plat, cfg):
        return plat.eps_ms
    if plat.os_policy == "fair":
        # Linux boosts awakened threads, but under full oversubscription a
        # small residual delay remains (the paper's Fig. 7: Pri still buys
        # ~4% at 7+1/8+1 on the Exynos)
        return plat.td_wait_fair_ms or plat.eps_ms
    return plat.td_wait_ms


def simulate(plat: Platform, cfg: SimConfig) -> SimResult:
    G = cfg.G or plat.G_opt
    lam_g = plat.accel(G)
    ledger = OverheadLedger()
    ledger.keep_records = False
    busy = {"accel": 0.0}
    items = {"accel": 0}
    threads: List[Tuple[str, float]] = []    # (class, per-thread λ)
    for i in range(cfg.n_big):
        threads.append(("big", plat.lam_big))
        busy.setdefault("big", 0.0)
        items.setdefault("big", 0)
    for i in range(cfg.n_little):
        threads.append(("little", plat.lam_little))
        busy.setdefault("little", 0.0)
        items.setdefault("little", 0)

    t_end = 0.0
    n_gpu_chunks = 0
    seq = itertools.count()

    for _ in range(cfg.timesteps):
        t0 = t_end
        if cfg.scheduler == "bulk":
            frac = plat.bulk_frac[cfg.label] if cfg.bulk_frac is None \
                else cfg.bulk_frac
            n_accel = int(cfg.n_iterations * frac)
            space = IterationSpace(0, cfg.n_iterations - n_accel)
            accel_done = t0
            if n_accel:
                lam_bulk = plat.accel(n_accel)
                tg1 = t0 + plat.sp_ms
                tg2 = tg1 + plat.t_hd_ms
                tg3 = tg2 + plat.t_kl_ms
                tg4 = tg3 + n_accel / lam_bulk
                tg5 = tg4 + plat.t_dh_ms
                rec = ChunkRecord(
                    Token(Chunk(0, n_accel, next(seq)), "accel",
                          DeviceKind.ACCEL),
                    tc1=t0 / 1e3, tc2=(t0 + plat.sp_ms) / 1e3,
                    tc3=(tg5 + _wake_delay(plat, cfg)) / 1e3,
                    tg1=tg1 / 1e3, tg2=tg2 / 1e3, tg3=tg3 / 1e3,
                    tg4=tg4 / 1e3, tg5=tg5 / 1e3)
                ledger.add(rec)
                busy["accel"] += (tg5 - tg1) / 1e3
                items["accel"] += n_accel
                n_gpu_chunks += 1
                accel_done = tg5
            # CPU threads dynamically share the rest (quantum = TBB-ish)
            quantum = max(64, (cfg.n_iterations - n_accel)
                          // max(1, 8 * len(threads)))
            tdone = t0
            clocks = [t0] * len(threads)
            while True:
                c = space.take(quantum)
                if c is None:
                    break
                i = min(range(len(threads)), key=lambda j: clocks[j])
                cls, lam = threads[i]
                dt = plat.sp_ms + c.size / lam
                clocks[i] += dt
                busy[cls] += (dt - plat.sp_ms) / 1e3
                items[cls] += c.size
            tdone = max(clocks) if threads else t0
            t_end = max(accel_done, tdone)
            continue

        # ---- dynamic (the paper's scheduler) --------------------------
        space = IterationSpace(0, cfg.n_iterations)
        lam_c_seen = {"big": plat.lam_big, "little": plat.lam_little}
        heap: List[Tuple[float, int, str, int]] = []
        # CPU threads bootstrap
        clocks = [t0] * len(threads)
        for i, (cls, lam) in enumerate(threads):
            heapq.heappush(heap, (t0, next(seq), "cpu", i))
        # accelerator host thread bootstraps
        heapq.heappush(heap, (t0, next(seq), "accel", -1))
        end_time = t0
        inflight_ready = t0    # when the device becomes free
        while heap:
            t, _, kind, idx = heapq.heappop(heap)
            if kind == "cpu":
                cls, lam = threads[idx]
                size = max(1, int(round(
                    G * lam / max(lam_g, 1e-9))))           # eq. (4)
                c = space.take(size)
                if c is None:
                    end_time = max(end_time, t)
                    continue
                dt = plat.sp_ms + c.size / lam
                busy[cls] += (dt - plat.sp_ms) / 1e3
                items[cls] += c.size
                heapq.heappush(heap, (t + dt, next(seq), "cpu", idx))
            else:
                c = space.take(G)
                if c is None:
                    end_time = max(end_time, t, inflight_ready)
                    continue
                tc1 = t
                tc2 = t + plat.sp_ms
                start = max(tc2, inflight_ready)
                tg1 = start
                tg2 = tg1 + plat.t_hd_ms
                tg3 = tg2 + plat.t_kl_ms
                tg4 = tg3 + c.size / plat.accel(c.size)
                tg5 = tg4 + plat.t_dh_ms
                inflight_ready = tg5
                wake = _wake_delay(plat, cfg)
                if cfg.async_depth >= 2:
                    # dispatch-ahead: the device never waits for the host;
                    # O_td measures device idle, which pipelining removes
                    tc1, tc2, wake = tg1, tg1, 0.0
                tc3 = tg5 + wake
                rec = ChunkRecord(
                    Token(c, "accel", DeviceKind.ACCEL),
                    tc1=tc1 / 1e3, tc2=tc2 / 1e3, tc3=tc3 / 1e3,
                    tg1=tg1 / 1e3, tg2=tg2 / 1e3, tg3=tg3 / 1e3,
                    tg4=tg4 / 1e3, tg5=tg5 / 1e3)
                ledger.add(rec)
                busy["accel"] += (tg5 - tg1) / 1e3
                items["accel"] += c.size
                n_gpu_chunks += 1
                # with dispatch-ahead the host enqueues the next chunk while
                # the device still runs; otherwise it redispatches after wake
                next_t = tg1 if cfg.async_depth >= 2 else tc3
                heapq.heappush(heap, (next_t, next(seq), "accel", -1))
        t_end = end_time

    total_s = t_end / 1e3
    # ---- energy -------------------------------------------------------
    # E_rail = idle_w·n_cores·T + (active_w − idle_w)·busy_core_seconds:
    # idle power burns on every core of the rail for the whole run; the
    # active-idle delta accrues per busy core-second (INA231 rail analogue).
    counts = {"big": plat.n_big, "little": plat.n_little, "accel": 1}
    per = {}
    for rail, spec in plat.power.items():
        n = counts.get(rail, 1)
        b = busy.get(rail, 0.0)                     # busy core-seconds
        per[rail] = spec.idle_w * n * total_s \
            + (spec.active_w - spec.idle_w) * b
    energy = EnergyReport(total_s, per, plat.base_w * total_s)
    ov = ledger.report(total_s, "accel")
    return SimResult(time_ms=t_end, energy=energy, overheads=ov,
                     per_device_items=items, n_gpu_chunks=n_gpu_chunks,
                     config=cfg)


# ---------------------------------------------------------------------------
# convenience runners for the paper's configurations
# ---------------------------------------------------------------------------

def run_config(plat: Platform, label: str, scheduler: str = "dynamic",
               priority: bool = False, host_pin: str = "big",
               timesteps: int = 15, async_depth: int = 1,
               bulk_frac: Optional[float] = None) -> SimResult:
    n_threads = int(label.split("+")[0])
    n_big = min(n_threads, plat.n_big)
    n_little = n_threads - n_big
    return simulate(plat, SimConfig(
        n_big=n_big, n_little=n_little, host_pin=host_pin,
        priority=priority, scheduler=scheduler, bulk_frac=bulk_frac,
        timesteps=timesteps, async_depth=async_depth))


def bulk_oracle(plat: Platform, label: str, timesteps: int = 15,
                step: float = 0.1) -> SimResult:
    """The paper's Bulk-Oracle: exhaustive offline sweep of the static split."""
    best = None
    f = 0.0
    while f <= 1.0001:
        r = run_config(plat, label, scheduler="bulk", bulk_frac=f,
                       timesteps=timesteps)
        if best is None or r.time_ms < best.time_ms:
            best = r
        f += step
    return best
