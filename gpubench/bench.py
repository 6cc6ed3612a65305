"""The benchmark harness: one run of one cell.

Everything is found by name. ``BENCHMARK.json`` at the checkout's root
names the cell's configuration, traffic mix and metrics; then

- ``gpubench/configs/<config>.json`` is the configuration, its ``family``
  naming ``gpubench/reference/<family>.py`` (the plain reference) and
  ``gpubench/work/<family>.py`` (its FLOPs and kernel launches);
- ``gpubench/traffic/<mix>.json`` is the traffic mix, its ``driver``
  naming ``gpubench/drivers/<driver>.py``, the general driver of the
  window that reads the mix's parameters;
- ``gpubench/metrics/<metric>.py`` reads one metric, end to end or per
  layer, from the run's ``Context``; it returns None where it finds
  nothing to read, and the metric is then left out of the line;
- ``gpubench/limits/<cell>.json`` holds the limits of the cell's
  correctness numbers.

A run: set-up (weights from the seed, the program's objects, warm-up of
this cell's shapes), the window (whole calls of the driver until
``seconds`` have passed, with the card's power sampled), with ``trace``
one more call under the profiler, then the correctness check against the
reference once the program's state is freed, and the result line.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

#: top-level module names that must never be loaded in a run: JAX and the
#: JAX package the program was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Call:
    """One whole call of a driver: the tokens it completed, its seconds on
    the host's clock (ended by a synchronise), and the program's report."""
    tokens: int
    seconds: float
    report: object
    items: int = 0


@dataclass
class Context:
    """What a metric's reader reads."""
    cell: Dict
    config: Dict
    mix: Dict
    driver: object
    setup_s: float
    calls: List[Call] = field(default_factory=list)
    window_s: float = 0.0
    energy_j: Optional[float] = None
    #: bytes the process reserved on the card at most: in set-up, and
    #: from the window's start
    setup_peak: Optional[int] = None
    peak_reserved: Optional[int] = None
    trace: object = None
    traced_calls: List[Call] = field(default_factory=list)
    power_limit_w: Optional[float] = None

    @property
    def tokens(self) -> int:
        return sum(c.tokens for c in self.calls)

    def log(self, text: str) -> None:
        print(f"gpubench: {text}", file=sys.stderr, flush=True)


class Benchmark:
    """The benchmark's files under ``root`` (the checkout)."""

    def __init__(self, root: Path):
        self.root = Path(root)
        self.doc = json.loads((self.root / "BENCHMARK.json").read_text())
        self.dir = self.root / "gpubench"

    def cell(self, name: str) -> Dict:
        for w in self.doc["workloads"]:
            if w["name"] == name:
                return w
        raise SystemExit(f"gpubench: no workload {name!r} in BENCHMARK.json")

    def _json(self, kind: str, name: str) -> Dict:
        return json.loads((self.dir / kind / f"{name}.json").read_text())

    def config(self, cell: Dict) -> Dict:
        return self._json("configs", cell["config"])

    def mix(self, cell: Dict) -> Dict:
        return self._json("traffic", cell["traffic"])

    def limits(self, cell: Dict) -> Dict:
        return self._json("limits", cell["name"])

    def metrics(self, cell: Dict, trace: bool) -> List[Dict]:
        """The cell's end-to-end metrics, or with ``trace`` its per-layer
        ones: those that list the cell, or that list no cells and move a
        metric the cell reports."""
        e2e = [m for m in self.doc["end_to_end"]
               if cell["name"] in m.get("workloads", [cell["name"]])]
        if not trace:
            return e2e
        names = {m["name"] for m in e2e}
        return [m for m in self.doc["per_layer"]
                if (cell["name"] in m["workloads"] if "workloads" in m
                    else m["moves"] in names)]

    def reader(self, metric: str):
        return load_file(self.dir / "metrics" / f"{metric}.py").read


def load_file(path: Path):
    """A module loaded from its file (names may hold dots)."""
    spec = importlib.util.spec_from_file_location(
        "gpubench_" + path.stem.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def family(config: Dict):
    return importlib.import_module(f"gpubench.reference.{config['family']}")


def work(config: Dict):
    return importlib.import_module(f"gpubench.work.{config['family']}")


def driver_class(mix: Dict):
    return importlib.import_module(f"gpubench.drivers.{mix['driver']}").Driver


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        device: str, t_start: float, power=None) -> Dict:
    """One run of cell ``workload``. ``device`` is ``cuda:0`` in a run;
    the tests run a tiny cell on ``cpu`` (with no power sampler). Returns
    the result line as a dict; its ``checks`` come last."""
    import torch
    from gpubench import check
    from gpubench import trace as tracing
    spec = Benchmark(root)
    cell = spec.cell(workload)
    config, mix = spec.config(cell), spec.mix(cell)
    dev = torch.device(device)
    drv = driver_class(mix)(config, mix, seed, dev)
    limit_w = None
    if power is not None:
        # the sampler starts before the warm-up, so that its own start
        # falls in set-up and not in the window
        limit_w = float(power.limit_w())
        power.start()
    try:
        drv.setup()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        # set-up's garbage is collected in set-up, and what it keeps is
        # left out of the window's collections: a full collection walks
        # every object the imports and the warm-up made, and the host
        # stalls the card meanwhile
        gc.collect()
        gc.freeze()
        ctx = Context(cell, config, mix, drv, time.monotonic() - t_start,
                      power_limit_w=limit_w)
        ctx.log(f"set-up {ctx.setup_s:.3f} s")

        # the window: whole calls until ``seconds`` have passed
        if dev.type == "cuda":
            ctx.setup_peak = torch.cuda.max_memory_reserved(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        w0, t0 = time.time(), time.perf_counter()
        while True:
            ctx.calls.append(drv.call())
            if time.perf_counter() - t0 >= seconds:
                break
        ctx.window_s = time.perf_counter() - t0
    finally:
        if power is not None:
            power.stop()
    if power is not None:
        ctx.energy_j = power.energy_j(w0, w0 + ctx.window_s)
        ctx.log("SM clock lowest %.0f, mean %.1f MHz over the window"
                % power.sm_mhz(w0, w0 + ctx.window_s))
    if dev.type == "cuda":
        ctx.peak_reserved = torch.cuda.max_memory_reserved(dev)
    ctx.log(f"window {ctx.window_s:.3f} s, {len(ctx.calls)} calls, "
            f"{ctx.tokens} tokens; calls "
            f"{' '.join(f'{c.seconds:.3f}' for c in ctx.calls)} s")
    if trace:
        ctx.traced_calls, ctx.trace = tracing.traced(drv.traced_call, dev)
        ctx.log(f"traced window {ctx.trace.window_s:.3f} s")
    device_line = {"platform": "cpu", "kind": "cpu", "count": 1,
                   "memory_peak_bytes": 0}
    if dev.type == "cuda":
        peak = max(ctx.setup_peak, torch.cuda.max_memory_reserved(dev))
        device_line = {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(dev),
                       "count": 1, "memory_peak_bytes": peak,
                       "power_limit_w": ctx.power_limit_w}

    # correctness, once the program's state is freed
    gc.unfreeze()
    drv.release()
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    limits = spec.limits(cell)
    t_check = time.perf_counter()
    attempted, failed, numbers = drv.check(ctx)
    ctx.log(f"check {time.perf_counter() - t_check:.1f} s")
    correct, checks = check.judge(attempted, failed, numbers, limits)

    metrics = {}
    for m in spec.metrics(cell, trace):
        value = spec.reader(m["name"])(ctx)
        if value is None:
            ctx.log(f"{m['name']}: nothing to read")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": device_line}
    if trace:
        device_line["busy_s"] = ctx.trace.busy_s
        device_line["window_s"] = ctx.trace.window_s
        line["breakdown"] = {
            "device_ops": [[n, s] for n, s in ctx.trace.device_ops],
            "idle_gaps": [[n, s] for n, s in ctx.trace.idle_gaps]}
    line["checks"] = checks
    return line
