"""HeteroTrainer: the paper's Dynamic scheduler driving real torch training
(torch counterpart of ``repro.train.trainer``).

Each optimizer step's global batch is the *iteration space* (sample indices);
device groups receive λ-proportional chunks of samples (the accelerator group
its tuned chunk G), compute gradients on them, and the trainer combines
gradients example-count-weighted before one AdamW update. This is synchronous
data parallelism with dynamic, heterogeneity-aware load balancing — stragglers
automatically receive smaller chunks; a failed group's chunk is re-queued.

Chunk sizes are bucketed to powers of two, as in the JAX package; padded
rows carry loss_mask=0 and do not bias the gradient (the combine weights use
*real* example counts).

Each group runs on one torch device (``GroupDef.device``, ``None`` = the
card): a CUDA group on its executor's stream, through the flash-attention
kernel, a CPU group eagerly. The parameters, the fp32 optimizer state and
the combine live on the first accelerator group's device; every other
device a group uses reads its own copy of the weights, refreshed after each
update. A chunk's gradients stay in the parameters' dtype; the update
(``adamw_update`` on a ``ChunkGrads``) moves them to that device and sums
them in fp32, each scaled by the chunk's real example count (what the JAX
package's fp32 promotion of ``g * n`` computes), inside its two passes
over the leaves: one hand-written kernel's on the card. The weights are
written on each device's current stream (the
update, the refresh of a copy); an event recorded there after the write
orders every later chunk's stream behind it.

``_grad_fn(executor, b)`` is the JAX trainer's ``_grad_fn``, which
``jax.jit``s the gradient step once per chunk size. On a CUDA group it
replays a CUDA graph of the step captured once per (executor, bucket) on
the executor's stream (``train.graphs``, on the capture that the engine
shares: ``repro_torch.graphs``); ``graph_counts`` counts the
captures, replays and failures. There is no eager path on CUDA: a capture
that fails raises. Each bucket's graph keeps a chunk's activations and
gradients in a pool of its own; where a capture finds no room, the
executor's other buckets' graphs are dropped (``graph_counts.dropped``)
and the capture is tried once more. A CPU group calls the step eagerly.
The executors are built once per group, so their graphs last across
steps.

With telemetry on (``telemetry=None``, the default instance, or one
passed), a step's phases are timed on the device (``core.dispatch.
PhaseMarks``): each chunk's inputs, gradient step and fetch on its
executor's stream, and the combine, the update and the refresh of the
copies on the stream they run on. ``StepReport.phases`` sums them. A step
returns with its update queued: its own three phases join its report,
and reach the tracer as spans, when the next step's chunks have run
(they wait for the update), or at ``resolve_phases()``.
``telemetry=OFF`` times nothing.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from functools import partial
from typing import Callable, Dict, List, Optional, Tuple

import torch

from repro_torch import telemetry as telemetry_mod
from repro_torch.configs.base import LMConfig
from repro_torch.core import (ChunkFailure, ChunkRecord, DeviceKind,
                              DynamicScheduler, GroupSpec, TorchChunkExecutor)
from repro_torch.core.chunk_search import search_chunk
from repro_torch.core.dispatch import (GroupDef, PhaseMarks, bucket,
                                       group_devices, phase_totals)
from repro_torch.data.pipeline import for_model
from repro_torch.graphs import GraphCounts
from repro_torch.models import model as M
from repro_torch.train.graphs import GraphedGradStep
from repro_torch.train.optimizer import (ChunkGrads, OptConfig,
                                         adamw_update, init_opt_state,
                                         tree_leaves, tree_map)
from repro_torch.train.train_step import chunk_grad_step


@dataclass
class StepReport:
    step: int
    loss: float
    examples: int
    time_s: float
    per_group_items: Dict[str, int]
    overheads: Dict[str, Dict[str, float]]
    throughput: Dict[str, float]
    failed_groups: List[str] = field(default_factory=list)
    #: the step's phases summed by name, as ``ServeReport.phases``: the
    #: accelerator groups' chunks' ``train.inputs``, ``train.update_wait``
    #: (the chunk's stream waiting for the last update), ``train.grad``,
    #: ``train.fetch_wait`` and ``train.fetch``, and the trainer's
    #: ``train.combine`` (the update's first pass: the chunks' gradients
    #: combined, their global norm and the clip scale), ``train.update``
    #: (its second: the combine again, the clip and AdamW) and
    #: ``train.refresh`` (the copies of the weights and the mark
    #: that orders later chunks behind them), which join it once they have
    #: run (``HeteroTrainer.resolve_phases``); empty with telemetry off
    phases: Dict[str, Dict[str, float]] = field(default_factory=dict)


class HeteroTrainer:
    def __init__(self, cfg: LMConfig, groups: List[GroupDef],
                 seq_len: int = 128, global_batch: int = 64,
                 oc: Optional[OptConfig] = None, seed: int = 0,
                 alpha: float = 0.5, repeat_data: bool = False,
                 params: Optional[Dict] = None, telemetry=None):
        if not groups:
            raise ValueError("no device groups")
        self.devices = group_devices(cfg, groups, "train")
        self.repeat_data = repeat_data
        self.cfg = cfg
        self.groups = groups
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.oc = oc or OptConfig()
        self.alpha = alpha
        self.telemetry = telemetry_mod.resolve(telemetry)
        self.data = for_model(cfg, seq_len - cfg.prefix_len, seed)
        accel = [g for g in groups if g.kind == DeviceKind.ACCEL]
        self.device = self.devices[(accel or groups)[0].name]
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = M.init_params(cfg, gen, self.device)
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.opt = init_opt_state(self.params)
        self._copies = {d: tree_map(lambda t: t.to(d), self.params)
                        for d in set(self.devices.values())
                        if d != self.device}
        self._written: Dict[torch.device, torch.cuda.Event] = {}
        self._mark_written()
        # the last step's report, its own phase marks and their closing
        # event, until those have run (resolve_phases)
        self._unresolved: Optional[Tuple[StepReport, PhaseMarks, object]] \
            = None
        self.step_idx = 0
        self.history: List[StepReport] = []
        # one executor per group, for the trainer's life; the chunks each
        # has run in the current step (or chunk-size search), which the
        # fault injection counts as the JAX trainer's executor of a step does
        self._executors: Dict[str, TorchChunkExecutor] = {}
        self._chunks_run: Dict[str, int] = {}
        # (executor or None, bucket) -> the chunk's step: None keys the
        # eager step every CPU executor shares; a CUDA executor has graphs
        # of its own
        self._grad_fns: Dict[Tuple[Optional[TorchChunkExecutor], int],
                             Callable] = {}
        self.graph_counts = GraphCounts()

    # ------------------------------------------------------------------
    def load_state(self, params: Dict, opt: Dict, step: int) -> None:
        """Take restored trees (a checkpoint's ``params`` and ``opt``) as
        the trainer's own, on its devices."""
        self.params = tree_map(lambda t: t.to(self.device), params)
        self.opt = {k: tree_map(lambda t: t.to(self.device), v)
                    for k, v in opt.items() if k != "step"}
        self.opt["step"] = torch.as_tensor(opt["step"],
                                           dtype=torch.int32).cpu()
        self._copies = {d: tree_map(lambda t: t.to(d), self.params)
                        for d in self._copies}
        # the graphs read the replaced tensors: drop them (between steps,
        # when no replay is in flight); each is captured again on the new
        # tensors at its bucket's next chunk
        self._grad_fns.clear()
        self._mark_written()
        self.step_idx = step

    def _mark_written(self) -> None:
        """Record, on each CUDA device's current stream, that the weights
        there are written; a chunk's step waits for it on its own stream."""
        self._written = {}
        for d in set(self.devices.values()) | {self.device}:
            if d.type == "cuda":
                self._written[d] = torch.cuda.Event()
                self._written[d].record(torch.cuda.current_stream(d))

    def _refresh_copies(self) -> None:
        with torch.no_grad():
            for copy in self._copies.values():
                for dst, src in zip(tree_leaves(copy),
                                    tree_leaves(self.params)):
                    dst.copy_(src)

    def _weights(self, device: torch.device) -> Dict:
        """The weights a chunk on ``device`` reads."""
        return self.params if device == self.device else self._copies[device]

    def _grad_fn(self, ex: TorchChunkExecutor, b: int) -> Callable:
        """The step of a chunk of bucket ``b`` on executor ``ex``, cached:
        ``fn(params, batch) -> (grads, loss * n, n)``. For a CPU executor
        it calls ``chunk_grad_step`` eagerly; for a CUDA executor it
        replays the executor's graph of the bucket, captured on its stream
        at the first call (``GraphedGradStep``)."""
        cuda = ex.device.type == "cuda"
        key = (ex if cuda else None, b)
        fn = self._grad_fns.get(key)
        if fn is not None:
            return fn
        if not cuda:
            fn = partial(chunk_grad_step, self.cfg)
        else:
            def capture():
                return GraphedGradStep(self.cfg, self._weights(ex.device), b,
                                       self.seq_len, ex.stream,
                                       self.graph_counts, ex.name)
            mine = [k for k in list(self._grad_fns) if k[0] is ex]
            try:
                fn = capture()
            except torch.cuda.OutOfMemoryError:
                if not mine:
                    raise
            if fn is None:
                # out of the handler, whose traceback held the failed
                # capture's tensors; chunks of the dropped buckets may
                # still be in flight
                ex.stream.synchronize()
                for k in mine:
                    del self._grad_fns[k]
                self.graph_counts.dropped(len(mine))
                torch.cuda.empty_cache()
                fn = capture()
        self._grad_fns[key] = fn
        return fn

    def _executor_for(self, g: GroupDef) -> TorchChunkExecutor:
        ex = self._executors.get(g.name)
        if ex is None:
            ex = self._executors[g.name] = self._make_executor(g)
        return ex

    def _make_executor(self, g: GroupDef) -> TorchChunkExecutor:
        data = self.data
        device = self.devices[g.name]
        slowdown = g.slowdown

        def make_inputs(token):
            ex.mark("train.inputs")         # this and the copy to the device
            # chunk bounds are absolute sample indices: any group can
            # materialize any range, and re-executed chunks are identical
            c = token.chunk
            return data.batch(c.begin, c.end, pad_to=bucket(c.size))

        def step(batch):
            if g.fail_after_chunks is not None:
                n = self._chunks_run[g.name] = \
                    self._chunks_run.get(g.name, 0) + 1
                if n > g.fail_after_chunks:
                    raise ChunkFailure(f"group {g.name} injected failure")
            b = batch["tokens"].shape[0]
            if slowdown > 1.0:
                time.sleep((slowdown - 1.0) * 0.001 * b)
            # this device's weights: the update writes them in place, on
            # another stream than this chunk's. The wait stays outside the
            # graph, before the batch is copied in.
            if device in self._written:
                ex.mark("train.update_wait", wait=True)
                torch.cuda.current_stream(device).wait_event(
                    self._written[device])
            ex.mark("train.grad")
            return self._grad_fn(ex, b)(self._weights(device), batch)

        def fetch(outs):
            grads, loss_n, n = outs
            # the copies run on the stream after the next chunk's step
            ex.settle("train.fetch_wait")
            ex.mark("train.fetch")
            return {"grads": grads, "loss_n": float(loss_n), "n": float(n)}

        ex = TorchChunkExecutor(step, make_inputs, fetch, device=device,
                                async_depth=g.async_depth,
                                priority_boost=g.priority_boost, name=g.name,
                                time_phases=self.telemetry is not None)
        return ex

    # ------------------------------------------------------------------
    def tune_accel_chunk(self, seed_chunk: int = 4, multiples: int = 6) -> int:
        """§3.2 G-search over real measured throughput of the accel group."""
        accel = [g for g in self.groups if g.kind == DeviceKind.ACCEL]
        if not accel:
            return seed_chunk
        g = accel[0]
        ex = self._executor_for(g)
        self._space_offset = 0
        self._chunks_run = {}

        def measure(c: int) -> float:
            c = min(c, self.global_batch)
            self._grad_fn(ex, bucket(c))   # a capture is not timed
            from repro_torch.core.types import Chunk, Token
            tok = Token(Chunk(0, c, 0), g.name, g.kind)
            rec = ChunkRecord(tok)
            t0 = time.monotonic()
            ex.execute(tok, rec)
            ex.drain()
            dt = time.monotonic() - t0
            return c / max(dt, 1e-9)

        measure(min(seed_chunk, self.global_batch))   # warm-up (kernel build)
        tr = search_chunk(measure, seed_chunk, multiples=multiples,
                          max_chunk=self.global_batch)
        g.fixed_chunk = tr.best_chunk
        return tr.best_chunk

    # ------------------------------------------------------------------
    def train_step(self) -> StepReport:
        specs = {}
        execs = {}
        for g in self.groups:
            specs[g.name] = GroupSpec(
                g.name, g.kind, fixed_chunk=g.fixed_chunk,
                min_chunk=1, max_chunk=self.global_batch,
                init_throughput=1.0)
            execs[g.name] = self._executor_for(g)
        self._chunks_run = {}
        sched = DynamicScheduler(
            specs, execs, alpha=self.alpha,
            telemetry=telemetry_mod.OFF if self.telemetry is None
            else self.telemetry)
        self._space_offset = 0 if self.repeat_data \
            else self.step_idx * self.global_batch
        res = sched.run(self._space_offset,
                        self._space_offset + self.global_batch)
        # the chunks waited for the last update: its marks have run
        self.resolve_phases()

        marks = None
        if self.telemetry is not None:
            marks = PhaseMarks(torch.cuda.current_stream(self.device)
                               if self.device.type == "cuda" else None)
            marks.mark("train.combine")
        # the chunks' gradients as they came, combined sum g n / sum n in
        # fp32 inside the update's two passes (a CPU group's moved to the
        # parameters' device first): the first, the global norm and the
        # clip scale, is this phase; the second, AdamW, the update's
        results = [r for r in (rec.meta.get("result") for rec in res.records)
                   if r]
        total_loss = sum(r["loss_n"] for r in results)
        total_n = sum(r["n"] for r in results)
        assert total_n > 0, "no gradients collected"
        grads = ChunkGrads([r.pop("grads") for r in results],
                           [r["n"] for r in results], self.device)
        grads.norm(self.oc)
        if marks is not None:
            marks.mark("train.update")
        self.params, self.opt, _ = adamw_update(
            self.oc, self.params, grads, self.opt)
        del grads
        if marks is not None:
            marks.mark("train.refresh")
        self._refresh_copies()
        self._mark_written()
        self.step_idx += 1
        rep = StepReport(
            step=self.step_idx, loss=total_loss / total_n,
            examples=int(total_n), time_s=res.total_time,
            per_group_items=res.per_group_items,
            overheads=res.overheads, throughput=res.throughput,
            failed_groups=res.failed_groups)
        if marks is not None:
            phase_totals((p for rec in res.records if rec.token.is_accel
                          for p in rec.meta.get("phases", ())), rep.phases)
            self._unresolved = (rep, marks, marks.close())
        self.history.append(rep)
        return rep

    def resolve_phases(self) -> None:
        """Add the last step's own phases (combine, update, refresh) to
        its report and trace them as spans, once they have run on the
        device (waiting for them where they have not)."""
        if self._unresolved is None:
            return
        rep, marks, end = self._unresolved
        self._unresolved = None
        if end is not None:
            end.synchronize()
        own = marks.resolve()
        for p in own:
            self.telemetry.tracer.span(p.name, "trainer", p.start,
                                       p.start + p.host_s, step=rep.step,
                                       device_ms=p.device_s * 1e3)
        phase_totals(own, rep.phases)

    def train(self, steps: int) -> List[StepReport]:
        reps = [self.train_step() for _ in range(steps)]
        self.resolve_phases()
        return reps
