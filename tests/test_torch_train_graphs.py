"""The trainer's per-bucket gradient step (``HeteroTrainer._grad_fn``) and
what a CUDA graph of it needs.

On the CPU: the ``_grad_fns`` cache, keyed by (executor, bucket), its CPU
executors eager and never capturing; a failed capture raising the step's
own error and counted, with no eager fallback, here and in the serving
engine's ``_fns_for``, which share the capture (``repro_torch.graphs``);
a capture without room dropping the
executor's other buckets first; the update and the refresh of the copies
keeping every tensor at its address, which a graph reads; ``load_state``
dropping the graphs; and ``GraphedGradStep`` itself, its CUDA graph
replaced by a stand-in whose replay runs the step again into the captured
outputs, as a replay overwrites them: each call's gradients equal the
eager step's, bit for bit, and survive the next call of the bucket.
Reduced stablelm-1.6b in fp32.

Marked ``gpu`` (each skips inside itself without a card): graphed
training equal to eager, bit for bit, over 2 steps on reduced configs of
four families in bf16; two chunks of a bucket in flight; ``load_state``
on the card. This module does not import JAX, so on the card

    python -m pytest -m gpu tests/test_torch_train_graphs.py

runs as it is.
"""
import contextlib
import gc
import threading
import weakref
from functools import partial

import numpy as np
import pytest
import torch

from repro_torch.configs.registry import get_reduced_config
from repro_torch.core.types import DeviceKind
from repro_torch.data.pipeline import for_model
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import launch_count
from repro_torch.kernels import ssd_scan as SSD
from repro_torch.graphs import GraphCounts, Recorded
from repro_torch.kernels.launch_count import CountedGraph
from repro_torch.models import model as TM
from repro_torch.serve.engine import HeteroServeEngine
from repro_torch.serve.graphs import GraphedStep
from repro_torch.train import graphs as train_graphs
from repro_torch.train import trainer as trainer_mod
from repro_torch.train.optimizer import OptConfig, tree_leaves, tree_map
from repro_torch.train.train_step import chunk_grad_step
from repro_torch.train.trainer import GroupDef, HeteroTrainer

CPU = torch.device("cpu")
CUDA0 = torch.device("cuda", 0)
SEQ = 32


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _cfg(arch="stablelm-1.6b"):
    return get_reduced_config(arch).replace(dtype="float32")


def _trainer(groups=None, **kw):
    groups = groups or [GroupDef("accel", DeviceKind.ACCEL, device="cpu",
                                 fixed_chunk=4, async_depth=2)]
    kw = dict(dict(seq_len=SEQ, global_batch=8, repeat_data=True,
                   oc=OptConfig(lr=1e-3, warmup_steps=1)), **kw)
    return HeteroTrainer(_cfg(), groups, **kw)


class StandInStream:
    def __init__(self, device):
        self.device, self.cuda_stream = device, id(self)
        self.synchronised = 0

    def synchronize(self):
        self.synchronised += 1


class StandInExecutor:
    """Stands in for a CUDA executor: what ``_grad_fn`` reads of one."""

    def __init__(self, name):
        self.device, self.stream, self.name = CUDA0, StandInStream(CUDA0), name


class RecordingStep:
    """Stands in for ``GraphedGradStep``: records its arguments."""
    made = []

    def __init__(self, cfg, params, bucket, seq_len, stream, counts, name):
        self.params, self.bucket, self.seq_len = params, bucket, seq_len
        self.stream, self.counts, self.name = stream, counts, name
        RecordingStep.made.append(self)


@pytest.fixture
def recording(monkeypatch):
    RecordingStep.made = []
    monkeypatch.setattr(trainer_mod, "GraphedGradStep", RecordingStep)
    return RecordingStep.made


def _batch(cfg, begin, end, pad_to, seq=SEQ):
    data = for_model(cfg, seq - cfg.prefix_len, 0)
    return {k: torch.from_numpy(v)
            for k, v in data.batch(begin, end, pad_to=pad_to).items()}


# ---------------------------------------------------------------------------
# (a) the trainer's cache of steps
# ---------------------------------------------------------------------------

def test_grad_fns_are_cached_per_executor_and_bucket(recording, monkeypatch):
    """A CUDA executor gets a graph of its own per bucket, captured once
    and built on its stream, the trainer's counts and the device's
    weights; every CPU executor shares the eager step of a bucket."""
    tr = _trainer([GroupDef("accel", DeviceKind.ACCEL, device="cpu"),
                   GroupDef("cpu0", DeviceKind.BIG, device="cpu")])
    monkeypatch.setattr(tr, "_weights", lambda device: tr.params)
    a, b = StandInExecutor("a"), StandInExecutor("b")
    fa4 = tr._grad_fn(a, 4)
    assert tr._grad_fn(a, 4) is fa4
    fa8, fb4 = tr._grad_fn(a, 8), tr._grad_fn(b, 4)
    assert len({id(fa4), id(fa8), id(fb4)}) == 3
    assert [(s.name, s.bucket) for s in recording] == [("a", 4), ("a", 8),
                                                       ("b", 4)]
    for s, ex in zip(recording, (a, a, b)):
        assert s.stream is ex.stream and s.counts is tr.graph_counts
        assert s.params is tr.params and s.seq_len == SEQ
    cpu0, cpu1 = (tr._executor_for(g) for g in tr.groups)
    eager = tr._grad_fn(cpu0, 4)
    assert tr._grad_fn(cpu1, 4) is eager
    assert eager.func is chunk_grad_step and eager.args == (tr.cfg,)
    assert set(tr._grad_fns) == {(a, 4), (a, 8), (b, 4), (None, 4)}
    assert len(recording) == 3


def test_a_cpu_group_never_builds_a_graph(monkeypatch):
    """Two CPU groups train two steps: every chunk runs the eager step,
    nothing is captured or replayed, and the executors (and so their
    graphs, on a card) last across steps."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU group built a graph")

    monkeypatch.setattr(trainer_mod, "GraphedGradStep", refuse)
    tr = _trainer([GroupDef("accel", DeviceKind.ACCEL, device="cpu",
                            fixed_chunk=4, async_depth=2),
                   GroupDef("cpu0", DeviceKind.BIG, device="cpu")],
                  global_batch=16)
    tr.train_step()
    executors = dict(tr._executors)
    rep = tr.train_step()
    assert rep.examples == 16 and np.isfinite(rep.loss)
    assert tr._executors == executors and set(executors) == {"accel",
                                                             "cpu0"}
    assert tr._grad_fns and all(ex is None for ex, _ in tr._grad_fns)
    snap = tr.graph_counts.snapshot()
    assert (snap["captures"], snap["replays"], snap["failures"]) == (0, 0, 0)


def test_a_groups_injected_failure_counts_the_chunks_of_each_step():
    """The JAX trainer builds its executors every step, so a group's
    ``fail_after_chunks`` counts that step's chunks; the port keeps its
    executors and counts the same: a group failing after one chunk runs
    one chunk in each step."""
    tr = _trainer([GroupDef("accel", DeviceKind.ACCEL, device="cpu",
                            fixed_chunk=4, fail_after_chunks=1),
                   GroupDef("cpu0", DeviceKind.BIG, device="cpu",
                            fixed_chunk=4)], global_batch=16)
    for _ in range(2):
        rep = tr.train_step()
        assert rep.examples == 16
        assert rep.per_group_items.get("accel", 0) == 4


@pytest.fixture
def stand_in_stream(monkeypatch):
    """``torch.cuda.stream``, ``current_stream`` and ``device`` for a
    stand-in stream on the CPU: entering it or its device does nothing,
    and it is the current stream."""
    stream = StandInStream(CPU)
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda d=None: stream)
    return stream


class LostCapture:
    """Stands in for ``torch.cuda.CUDAGraph`` on the CPU: while it
    captures, the step fails (``_fail_in_capture``), and ``capture_end``
    then raises an error of its own, as a real graph's does after a
    capture an error lost."""
    capturing = False

    def capture_begin(self, pool=None, capture_error_mode="global"):
        LostCapture.capturing = True

    def capture_end(self):
        LostCapture.capturing = False
        raise RuntimeError("CUDA error: operation failed due to a previous "
                           "error during capture")


def _fail_in_capture(monkeypatch, module, name, eager_calls):
    """``module.name`` raising an out-of-memory error inside a capture,
    and counting its eager calls outside one."""
    real = getattr(module, name)

    def step(*args, **kwargs):
        if LostCapture.capturing:
            raise torch.cuda.OutOfMemoryError("out of memory in the step")
        eager_calls.append(name)
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, step)


@pytest.mark.parametrize("owner", ["serve", "train"])
def test_a_failed_capture_raises_and_is_counted_without_falling_back(
        owner, monkeypatch, stand_in_stream):
    """A capture lost to the step's own error (out of memory) is ended and
    raises that error, not the one ``capture_end`` raises after it; it is
    counted a failure, by the step's graphs (the engine's
    ``GraphedStep``, the trainer's ``GraphedGradStep``) and through their
    owner (``_fns_for``, ``_grad_fn``), which caches nothing and runs no
    eager step in its place: the next chunk of the bucket tries the
    capture again, its warm-up first, and fails again."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", LostCapture)
    eager_calls = []
    ex = StandInExecutor("accel")
    ex.stream = stand_in_stream
    if owner == "serve":
        _fail_in_capture(monkeypatch, TM, "prefill", eager_calls)
        eng = HeteroServeEngine(
            _cfg(), [GroupDef("accel", DeviceKind.ACCEL, device="cpu",
                              fixed_chunk=4)], prompt_len=8, decode_tokens=2)
        eng._params[CUDA0] = params = eng._params[CPU]

        def capture(counts):
            return GraphedStep(eng.cfg, params, 4, eng.prompt_len,
                               eng.max_len, stand_in_stream, counts, "accel")

        again, cached, counts = (lambda: eng._fns_for(4, ex)), eng._fns, \
            eng.graph_counts
        warmup = 1
    else:
        _fail_in_capture(monkeypatch, train_graphs, "chunk_grad_step",
                         eager_calls)
        tr = _trainer()
        monkeypatch.setattr(tr, "_weights", lambda device: tr.params)

        def capture(counts):
            return train_graphs.GraphedGradStep(
                tr.cfg, tr.params, 4, SEQ, stand_in_stream, counts, "accel")

        again, cached, counts = (lambda: tr._grad_fn(ex, 4)), \
            tr._grad_fns, tr.graph_counts
        warmup = train_graphs.WARMUP_STEPS
    own = GraphCounts()
    with pytest.raises(torch.cuda.OutOfMemoryError, match="in the step"):
        capture(own)
    snap = own.snapshot()
    assert (snap["captures"], snap["failures"]) == (0, 1)
    assert len(eager_calls) == warmup                    # the warm-up
    assert stand_in_stream.synchronised == 1
    for failures in (1, 2):
        with pytest.raises(torch.cuda.OutOfMemoryError, match="in the step"):
            again()
        assert counts.snapshot()["failures"] == failures
        assert cached == {}
    assert len(eager_calls) == 3 * warmup
    assert not LostCapture.capturing


def test_a_capture_without_room_drops_the_executors_other_buckets(
        recording, monkeypatch):
    """A capture that runs out of device memory while the executor holds
    other buckets' graphs: those are dropped (after its stream is
    synchronised: their chunks may be in flight), counted, and the capture
    is tried once more; other executors keep theirs. With nothing of its
    own to drop, the error is raised."""
    tr = _trainer()
    monkeypatch.setattr(tr, "_weights", lambda device: tr.params)
    a, b = StandInExecutor("a"), StandInExecutor("b")
    for ex, bucket in ((a, 4), (a, 8), (b, 4)):
        tr._grad_fn(ex, bucket)
    full = {"left": 1}

    class TightStep(RecordingStep):
        def __init__(self, *args):
            if full["left"]:
                full["left"] -= 1
                raise torch.cuda.OutOfMemoryError("no room")
            super().__init__(*args)

    monkeypatch.setattr(trainer_mod, "GraphedGradStep", TightStep)
    step16 = tr._grad_fn(a, 16)
    assert step16.bucket == 16
    assert (a.stream.synchronised, b.stream.synchronised) == (1, 0)
    assert set(tr._grad_fns) == {(a, 16), (b, 4)}
    assert tr.graph_counts.snapshot()["drops"] == 2
    fresh = StandInExecutor("c")
    full["left"] = 1
    with pytest.raises(torch.cuda.OutOfMemoryError):
        tr._grad_fn(fresh, 4)
    assert set(tr._grad_fns) == {(a, 16), (b, 4)}


def test_adamw_update_and_refresh_keep_every_tensor_address():
    """A graph reads the weights at their capture-time addresses: two
    steps leave every parameter, AdamW leaf and device copy the same
    tensor at the same address, the copies equal to the parameters."""
    tr = _trainer()
    tr._copies = {"copy": tree_map(torch.clone, tr.params)}
    trees = [tr.params, tr.opt["master"], tr.opt["m"], tr.opt["v"],
             tr._copies["copy"]]
    before = [[(t, t.data_ptr()) for t in tree_leaves(tree)]
              for tree in trees]
    old = [t.clone() for t in tree_leaves(tr.params)]
    params = tr.params
    tr.train(2)
    assert tr.params is params
    after = [tr.params, tr.opt["master"], tr.opt["m"], tr.opt["v"],
             tr._copies["copy"]]
    for was, tree in zip(before, after):
        assert all(t is w and t.data_ptr() == p
                   for (w, p), t in zip(was, tree_leaves(tree)))
    assert any(not torch.equal(a, b)
               for a, b in zip(old, tree_leaves(tr.params)))
    assert all(torch.equal(c, p) for c, p in zip(
        tree_leaves(tr._copies["copy"]), tree_leaves(tr.params)))


def test_a_steps_gradients_are_freed_without_the_garbage_collector(
        monkeypatch):
    """Each chunk's gradients and the combined fp32 gradients are freed
    by the end of the step, with the garbage collector off: a graphed step
    makes few Python objects, so the collector seldom runs, and gradients
    that only it frees (a reference cycle's) pile up on the card, a
    combined gradient (6.6 GB at stablelm-1.6b) a step (ROADMAP C14)."""
    tr = _trainer()
    tr.train_step()                 # the first step's lazy imports
    seen = []
    real_update, real_step = trainer_mod.adamw_update, \
        trainer_mod.chunk_grad_step

    def update(oc, params, grads, opt):
        seen.extend(weakref.ref(t) for t in tree_leaves(grads))
        return real_update(oc, params, grads, opt)

    def step(cfg, params, batch):
        out = real_step(cfg, params, batch)
        seen.extend(weakref.ref(t) for t in tree_leaves(out[0]))
        return out

    monkeypatch.setattr(trainer_mod, "adamw_update", update)
    monkeypatch.setattr(trainer_mod, "chunk_grad_step", step)
    tr._grad_fns.clear()
    gc.collect()
    gc.disable()
    try:
        tr.train_step()
        alive = sum(r() is not None for r in seen)
    finally:
        gc.enable()
    assert len(seen) == 3 * len(tree_leaves(tr.params)) and alive == 0


def test_load_state_drops_every_graph(recording, monkeypatch):
    """``load_state`` takes other tensors, which no graph read: it drops
    the cached graphs, and the bucket's next chunk captures one on the
    new weights."""
    tr = _trainer()
    monkeypatch.setattr(tr, "_weights", lambda device: tr.params)
    a = StandInExecutor("a")
    tr._grad_fn(a, 4)
    tr._grad_fn(tr._executor_for(tr.groups[0]), 4)
    old = tr.params
    tr.load_state(tree_map(torch.clone, old),
                  {k: tree_map(torch.clone, v) if k != "step" else v
                   for k, v in tr.opt.items()}, 3)
    assert tr._grad_fns == {} and tr.params is not old
    step = tr._grad_fn(a, 4)
    assert step is recording[-1] and len(recording) == 2
    assert step.params is tr.params


def test_a_captures_tally_takes_other_threads_launches_on_its_stream():
    """The autograd engine runs a backward's kernels on a thread of its
    own: a launch on the capture's stream from another thread joins the
    capture's tally and is taken back with it; one on another stream
    stays counted."""
    saved = FA.launches
    FA.launches = 0
    capturing, other = StandInStream(CUDA0), StandInStream(CUDA0)
    try:
        with launch_count.uncounted(capturing) as tally:
            launch_count.launched("flash_attention", capturing)
            worker = threading.Thread(target=lambda: [
                launch_count.launched("flash_attention", s)
                for s in (capturing, capturing, other)])
            worker.start()
            worker.join(5)
            assert not worker.is_alive()
            assert FA.launches == 4
        assert tally == {"flash_attention": 3}
        assert FA.launches == 1
        launch_count.launched("flash_attention", capturing)
        assert FA.launches == 2 and tally == {"flash_attention": 3}
    finally:
        FA.launches = saved


# ---------------------------------------------------------------------------
# (b) GraphedGradStep, its graph a stand-in on the CPU
# ---------------------------------------------------------------------------

class ReplayedGraph:
    """Stands in for a captured CUDA graph: its capture runs the step
    once, and each replay runs it again on the static inputs and writes
    the results into the outputs the capture returned, as a replay
    overwrites its static outputs."""

    def __init__(self, fn):
        self.fn = fn
        self.out = fn()
        self.replays = 0

    @staticmethod
    def _flat(out):
        grads, loss_n, n = out
        return tree_leaves(grads) + [loss_n, n]

    def replay(self):
        with torch.enable_grad():
            fresh = self._flat(self.fn())
        with torch.no_grad():
            for dst, src in zip(self._flat(self.out), fresh):
                dst.copy_(src)
        self.replays += 1


def _stand_in_record(fn, stream, n=0, warm=None, pool=None):
    graph = ReplayedGraph(fn)
    return Recorded(CountedGraph(graph, {}), graph.out, 0, 0.0, 0.0)


def _flat(out):
    grads, loss_n, n = out
    return tree_leaves(grads) + [loss_n, n]


def test_each_call_keeps_its_gradients_after_the_next_of_the_bucket(
        monkeypatch, stand_in_stream):
    """Two chunks of bucket 4 (the second one padded) through one
    ``GraphedGradStep``: each call returns the eager step's gradients,
    loss * n and n bit for bit, and the first call's survive the second
    replay, which overwrote the graph's own outputs. One capture, two
    replays; other weights, or a batch of another bucket, are refused."""
    monkeypatch.setattr(train_graphs, "record", _stand_in_record)
    tr = _trainer()
    cfg, params = tr.cfg, tr.params
    counts = GraphCounts()
    step = train_graphs.GraphedGradStep(cfg, params, 4, SEQ,
                                        stand_in_stream, counts, "accel")
    first, second = _batch(cfg, 0, 4, 4), _batch(cfg, 4, 7, 4)
    got_first = step(params, first)
    got_second = step(params, second)
    for got, batch in ((got_first, first), (got_second, second)):
        want = chunk_grad_step(cfg, params, batch)
        assert all(torch.equal(g, w) for g, w in zip(_flat(got),
                                                     _flat(want)))
    assert float(got_first[2]) == 4.0 and float(got_second[2]) == 3.0
    assert all(torch.equal(s, g)
               for s, g in zip(_flat(step.out), _flat(got_second)))
    assert not torch.equal(tree_leaves(got_first[0])[0],
                           tree_leaves(got_second[0])[0])
    snap = counts.snapshot()
    assert (snap["captures"], snap["replays"], snap["failures"]) == (1, 2, 0)
    assert snap["replays_by_pair"] == {("accel", 4): 2}
    entry = snap["capture_log"][0]
    assert set(entry) == {"executor", "bucket", "warmup_s", "capture_s",
                          "launches", "pool_bytes"}
    with pytest.raises(ValueError, match="other weights"):
        step(tree_map(torch.clone, params), first)
    with pytest.raises(ValueError, match="the graph takes"):
        step(params, _batch(cfg, 0, 8, 8))
    assert counts.snapshot()["replays"] == 2


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "phi-3-vision-4.2b"])
def test_static_batch_is_shaped_as_the_pipelines(arch):
    """The static inputs have the keys, shapes and dtypes of the data
    pipeline's padded batch of the bucket, a modality prefix included."""
    cfg = get_reduced_config(arch)
    got = train_graphs.static_batch(cfg, 4, SEQ, CPU)
    want = _batch(cfg, 0, 3, 4)
    assert got.keys() == want.keys()
    for k, t in want.items():
        assert got[k].shape == t.shape and got[k].dtype == t.dtype, k


# ---------------------------------------------------------------------------
# (c) on the card
# ---------------------------------------------------------------------------

def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return CUDA0


class EagerTrainer(HeteroTrainer):
    """The trainer with every chunk's step eager, graphs or not."""

    def _grad_fn(self, ex, b):
        return partial(chunk_grad_step, self.cfg)


def _card_trainer(cls, cfg, params, dev, **kw):
    return cls(cfg, [GroupDef("accel", DeviceKind.ACCEL, device=dev,
                              fixed_chunk=4, async_depth=2)],
               seq_len=64, global_batch=8, repeat_data=True,
               oc=OptConfig(lr=1e-3, warmup_steps=1, total_steps=4),
               params=tree_map(torch.clone, params), **kw)


def _state(tr):
    return [t for tree in (tr.params, tr.opt["master"], tr.opt["m"],
                           tr.opt["v"]) for t in tree_leaves(tree)]


def _run(tr, steps):
    FA.launches = SSD.launches = 0
    losses = [tr.train_step().loss for _ in range(steps)]
    torch.cuda.synchronize()
    return losses, (FA.launches, SSD.launches)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "zamba2-1.2b",
                                  "granite-moe-1b-a400m", "xlstm-350m"])
def test_graphed_training_equals_eager_on_the_card(arch):
    """Reduced ``arch`` in bf16, ``accel:chunk=4:async=2``, 2 steps of 2
    chunks of 4 x 64: the graphed trainer's losses, weights and AdamW
    state equal the eager trainer's bit for bit, with the same kernel
    launches; one capture, a replay a chunk, no failure."""
    from repro_torch.models import model as M
    dev = _card()
    cfg = get_reduced_config(arch)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    eager = _card_trainer(EagerTrainer, cfg, params, dev)
    want_loss, want_launches = _run(eager, 2)
    graphed = _card_trainer(HeteroTrainer, cfg, params, dev)
    got_loss, got_launches = _run(graphed, 2)
    assert got_loss == want_loss and got_launches == want_launches
    assert all(torch.equal(a, b) for a, b in zip(_state(graphed),
                                                 _state(eager)))
    snap = graphed.graph_counts.snapshot()
    assert (snap["captures"], snap["replays"], snap["failures"]) == (1, 4, 0)
    per_replay = snap["capture_log"][0]["launches"]
    assert (4 * per_replay.get("flash_attention", 0),
            4 * per_replay.get("ssd_scan", 0)) == got_launches


@pytest.mark.gpu
def test_two_chunks_in_flight_keep_their_gradients_on_the_card():
    """Two chunks of bucket 4 replayed back to back on the executor's
    stream, nothing synchronised between: the first one's gradients are
    the eager step's on its batch, bit for bit."""
    from repro_torch.models import model as M
    dev = _card()
    cfg = get_reduced_config("stablelm-1.6b")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    tr = _card_trainer(HeteroTrainer, cfg, params, dev)
    ex = tr._executor_for(tr.groups[0])
    step = tr._grad_fn(ex, 4)
    first, second = (_batch(cfg, b, b + 4, 4, seq=64) for b in (0, 4))
    first, second = ({k: v.to(dev) for k, v in b.items()}
                     for b in (first, second))
    got = step(tr.params, first)
    step(tr.params, second)
    torch.cuda.synchronize()
    want = chunk_grad_step(cfg, tr.params, first)
    assert all(torch.equal(g, w) for g, w in zip(_flat(got), _flat(want)))


@pytest.mark.gpu
def test_load_state_recaptures_on_the_card():
    """One step, then ``load_state`` of the step's own state as new
    tensors, then one more: the trainer captures again and ends where the
    eager trainer given the same ``load_state`` ends, bit for bit."""
    from repro_torch.models import model as M
    dev = _card()
    cfg = get_reduced_config("stablelm-1.6b")
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(0),
                           dev)
    runs = []
    for cls in (EagerTrainer, HeteroTrainer):
        tr = _card_trainer(cls, cfg, params, dev)
        tr.train_step()
        tr.load_state(tree_map(torch.clone, tr.params),
                      {k: tree_map(torch.clone, v) if k != "step" else v
                       for k, v in tr.opt.items()}, tr.step_idx)
        runs.append((_run(tr, 1)[0], _state(tr), tr.graph_counts.snapshot()))
    (want_loss, want, _), (got_loss, got, snap) = runs
    assert got_loss == want_loss
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (snap["captures"], snap["failures"]) == (2, 0)
