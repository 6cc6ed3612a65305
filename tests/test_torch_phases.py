"""Phase spans inside the engine's chunk step and the trainer's step, on
the CPU: the phases a served call and a training step report, nothing
timed with telemetry off, O_dh from the fetch's own time at async depth
2 beside the ledger's (which admission reads, unchanged), the tracer's
offset to the profiler's clock, and the trainer's telemetry reaching its
scheduler.

On the CPU the host stamps stand in for the device's clock; the device's
own seconds are the card's (``tests/test_torch_gpu.py``).
"""
import copy
import statistics
import time

import pytest
import torch

from repro_torch import telemetry as telemetry_mod
from repro_torch.configs.registry import get_reduced_config
from repro_torch.core import dispatch
from repro_torch.core.overheads import OverheadLedger
from repro_torch.core.throughput import ThroughputTracker
from repro_torch.core.types import Chunk, ChunkRecord, DeviceKind, Token
from repro_torch.queue import AdmissionController, QueueManager
from repro_torch.serve.engine import GroupDef, HeteroServeEngine
from repro_torch.telemetry.spans import SpanTracer
from repro_torch.train import trainer as trainer_mod
from repro_torch.train.trainer import GroupDef as TrainGroup
from repro_torch.train.trainer import HeteroTrainer

SERVE_PHASES = ("serve.inputs", "serve.prefill", "serve.decode",
                "serve.gather", "serve.fetch_wait", "serve.fetch")
TRAIN_CHUNK_PHASES = ("train.inputs", "train.grad", "train.fetch_wait",
                      "train.fetch")
TRAIN_STEP_PHASES = ("train.combine", "train.update", "train.refresh")


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _cfg():
    return get_reduced_config("stablelm-1.6b").replace(n_layers=2,
                                                       dtype="float32")


def _engine(telemetry=None, decode_tokens=5):
    return HeteroServeEngine(
        _cfg(), [GroupDef("accel", DeviceKind.ACCEL, device="cpu",
                          fixed_chunk=4, async_depth=2)],
        prompt_len=8, decode_tokens=decode_tokens, telemetry=telemetry)


def _trainer(telemetry=None):
    return HeteroTrainer(
        _cfg(), [TrainGroup("accel", DeviceKind.ACCEL, device="cpu",
                            fixed_chunk=4, async_depth=2)],
        seq_len=16, global_batch=12, telemetry=telemetry)


@pytest.mark.parametrize("decode_tokens", [1, 5])
def test_a_served_call_has_every_serving_phase_once_a_chunk(decode_tokens):
    eng = _engine(telemetry_mod.Telemetry(), decode_tokens)
    rep = eng.serve(14)                    # chunks of 4, 4, 4, 2
    chunks = rep.overheads["accel"]["n_chunks"]
    assert chunks == 4
    assert tuple(rep.phases) == SERVE_PHASES
    for name, t in rep.phases.items():
        assert t["count"] == chunks, name
        assert t["device_s"] >= 0.0 and t["host_s"] >= 0.0
    assert rep.phases["serve.decode"]["steps"] == chunks * (decode_tokens - 1)
    assert sum(t["steps"] for t in rep.phases.values()) \
        == chunks * (decode_tokens - 1)
    assert rep.phases["serve.prefill"]["device_s"] > 0.0
    # the call's phases lie inside its time
    assert sum(t["device_s"] for t in rep.phases.values()) <= rep.time_s


def test_a_training_step_has_grad_per_chunk_and_its_own_phases_once():
    tel = telemetry_mod.Telemetry()
    tr = _trainer(tel)
    rep = tr.train_step()                  # chunks of 4, 4, 4
    chunks = rep.overheads["accel"]["n_chunks"]
    assert chunks == 3
    # the step's own phases join its report once they have run
    assert set(rep.phases) == set(TRAIN_CHUNK_PHASES)
    tr.resolve_phases()
    assert set(rep.phases) == set(TRAIN_CHUNK_PHASES + TRAIN_STEP_PHASES)
    for name in TRAIN_CHUNK_PHASES:
        assert rep.phases[name]["count"] == chunks, name
    for name in TRAIN_STEP_PHASES:
        assert rep.phases[name]["count"] == 1, name
        assert rep.phases[name]["device_s"] > 0.0, name
    assert rep.phases["train.grad"]["device_s"] > 0.0
    # the trainer's own phases are traced once resolved, as spans of the
    # step
    spans = [e for e in tel.tracer.chrome_events()
             if e["name"] in TRAIN_STEP_PHASES]
    assert sorted(e["name"] for e in spans) == sorted(TRAIN_STEP_PHASES)
    assert all(e["args"]["step"] == 1 for e in spans)
    # each chunk's phases are traced with its chunk span
    tel.snapshot()
    grads = [e for e in tel.tracer.chrome_events()
             if e["name"] == "train.grad"]
    assert len(grads) == chunks and all(e["cat"] == "phase" for e in grads)


def test_the_next_step_adds_the_last_steps_own_phases():
    """A step returns with its update queued; the next step, whose chunks
    wait for that update, adds its phases to the last step's report, and
    ``train`` leaves every report whole."""
    tr = _trainer(telemetry_mod.Telemetry())
    first = tr.train_step()
    second = tr.train_step()
    assert first.phases["train.update"]["count"] == 1
    assert "train.update" not in second.phases
    tr.resolve_phases()
    assert second.phases["train.update"]["count"] == 1
    reps = tr.train(2)
    assert all(set(r.phases) == set(TRAIN_CHUNK_PHASES + TRAIN_STEP_PHASES)
               for r in reps)


class _CountingMarks(dispatch.PhaseMarks):
    made = 0

    def __init__(self, *a, **kw):
        type(self).made += 1
        super().__init__(*a, **kw)


def test_telemetry_off_times_nothing_and_traces_nothing(monkeypatch):
    monkeypatch.setattr(dispatch, "PhaseMarks", _CountingMarks)
    monkeypatch.setattr(trainer_mod, "PhaseMarks", _CountingMarks)
    _CountingMarks.made = 0
    tracer = telemetry_mod.default().tracer
    emitted = tracer.emitted
    eng = _engine(telemetry_mod.OFF)
    rep = eng.serve(8)
    assert rep.phases == {}
    tr = _trainer(telemetry_mod.OFF)
    steps = [tr.train_step() for _ in range(2)]
    assert all(s.phases == {} for s in steps)
    assert _CountingMarks.made == 0
    assert tracer.emitted == emitted
    # and on: the same calls make marks
    _engine(telemetry_mod.Telemetry()).serve(8)
    assert _CountingMarks.made > 0


class _InOrderDevice:
    """Stands in for a CUDA stream: work runs in the order it is queued,
    each item from when it is queued or when the one before it ends."""

    def __init__(self):
        self.free_at = 0.0

    def run(self, seconds):
        self.free_at = max(time.monotonic(), self.free_at) + seconds

    def wait(self):
        time.sleep(max(0.0, self.free_at - time.monotonic()))


def test_o_dh_leaves_out_the_successor_chunks_run():
    """At async depth 2 a chunk's fetch is queued behind the next chunk's
    step (``_InOrderDevice``): the fetch's wait holds the successor's
    run, and O_dh reads the copy alone."""
    step_s, copy_s = 0.05, 0.002
    device = _InOrderDevice()

    def step(x):
        ex.mark("t.step")
        device.run(step_s)
        return x

    def fetch(outs):
        ex.settle("t.fetch_wait")
        device.wait()                  # the successor, queued ahead
        ex.mark("t.fetch")
        time.sleep(copy_s)
        return None

    ex = dispatch.TorchChunkExecutor(step, lambda tok: torch.zeros(2),
                                     fetch, device="cpu", async_depth=2,
                                     time_phases=True)
    recs = []
    for i in range(4):
        tok = Token(Chunk(i, i + 1, i), "accel", DeviceKind.ACCEL)
        recs += ex.execute(tok, ChunkRecord(tok))
    recs += ex.drain()
    waited = recs[:2]                  # each fetched behind a successor
    for rec in waited:
        assert rec.tg5 - rec.tg4 > 0.8 * step_s       # the Tg stamps absorb it
        assert copy_s <= dispatch.part_device_s(rec, "fetch") < 0.5 * step_s
        wait = [p for p in rec.meta["phases"] if p.name == "t.fetch_wait"]
        assert wait[0].host_s > 0.8 * step_s
        assert wait[0].part == "wait"
    total = 1.0
    fetch_s = sum(dispatch.part_device_s(r, "fetch") for r in recs)
    assert fetch_s < 4 * copy_s + 0.5 * step_s
    sound = dispatch.phase_fractions(recs, total)
    assert set(sound) == {"accel", "all"}
    assert sound["all"]["O_dh_dev"] == pytest.approx(fetch_s)
    assert sound["accel"]["kernel_dev_frac"] == pytest.approx(
        sum(dispatch.part_device_s(r, "step") for r in recs))
    # the ledger keeps the Tg stamps' terms
    ledger = OverheadLedger()
    ledger.add_many(recs)
    assert ledger.report(total)["O_dh"] == pytest.approx(
        sum(r.tg5 - r.tg4 for r in recs))
    assert ledger.report(total)["O_dh"] > 2 * 0.8 * step_s


def test_admission_capacity_is_the_same_with_phases_or_without():
    """Admission reads the ledger's Tg terms: the same chunks with their
    timed phases or without them give the same capacity."""
    device = _InOrderDevice()

    def step(x):
        ex.mark("t.step")
        device.run(0.01)
        return x

    def fetch(outs):
        ex.settle("t.fetch_wait")
        device.wait()
        ex.mark("t.fetch")
        return None

    ex = dispatch.TorchChunkExecutor(step, lambda tok: torch.zeros(2),
                                     fetch, device="cpu", async_depth=2,
                                     time_phases=True)
    recs = []
    for i in range(4):
        tok = Token(Chunk(i, i + 1, i), "accel", DeviceKind.ACCEL)
        recs += ex.execute(tok, ChunkRecord(tok))
    recs += ex.drain()
    bare = copy.deepcopy(recs)
    for rec in bare:
        del rec.meta["phases"]
    caps = []
    for chunks in (recs, bare):
        ledger = OverheadLedger()
        ledger.add_many(chunks)
        tracker = ThroughputTracker(0.5)
        tracker.seed("accel", 40.0)
        adm = AdmissionController(QueueManager(), tracker, ledger)
        adm.on_group_join("accel", 40.0)
        caps.append(adm.capacity_items_s())
    assert caps[0] == caps[1]


def test_a_span_lands_on_the_profilers_range_after_the_offset():
    """A main-thread region wrapped in a ``record_function`` range and a
    ``SpanTracer`` span: the span, moved by the exported offset, lies
    within 50 us of the range at both ends (median of 7 regions)."""
    tracer = SpanTracer()
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function("warm-up"):
            pass
        for i in range(7):
            t0 = time.monotonic()
            with torch.profiler.record_function(f"region{i}"):
                time.sleep(0.002)
            tracer.span(f"region{i}", "main", t0, time.monotonic())
    trace = tracer.chrome_trace()
    offset = trace["otherData"]["clock_offset_ns"]
    spans = {e["name"]: e for e in trace["traceEvents"]
             if e["name"].startswith("region")}
    errors = []
    for ev in prof.profiler.kineto_results.events():
        span = spans.get(ev.name())
        if span is None:
            continue
        start = span["ts"] * 1e3 + offset
        end = (span["ts"] + span["dur"]) * 1e3 + offset
        errors.append(max(abs(start - ev.start_ns()),
                          abs(end - (ev.start_ns() + ev.duration_ns()))))
    assert len(errors) == 7
    assert statistics.median(errors) < 50e3


def test_the_trainer_hands_its_telemetry_to_its_scheduler(monkeypatch):
    tel = telemetry_mod.Telemetry()
    tr = _trainer(tel)
    tr.train_step()
    counters = tel.registry.snapshot()["counters"]
    chunks = [v for k, v in counters.items() if k.startswith("sched.chunks")]
    assert chunks == [3]
    # under OFF, steps register no collector on the default registry
    added = []
    monkeypatch.setattr(telemetry_mod.default().registry, "add_collector",
                        added.append)
    off = _trainer(telemetry_mod.OFF)
    for _ in range(3):
        off.train_step()
    assert added == []
    assert off.telemetry is None
