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
update. A chunk's gradients stay in the parameters' dtype until the combine
moves them to that device and sums them in fp32, each scaled by the chunk's
real example count (what the JAX package's fp32 promotion of ``g * n``
computes). The weights are written on each device's current stream (the
update, the refresh of a copy); an event recorded there after the write
orders every later chunk's stream behind it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.core import (ChunkFailure, ChunkRecord, DeviceKind,
                              DynamicScheduler, GroupSpec, TorchChunkExecutor)
from repro_torch.core.chunk_search import search_chunk
from repro_torch.data.pipeline import for_model
from repro_torch.models import model as M
from repro_torch.serve.engine import resolve_device
from repro_torch.train.optimizer import (OptConfig, adamw_update,
                                         init_opt_state, tree_leaves,
                                         tree_map, tree_unflatten)
from repro_torch.train.train_step import grad_step


def bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


@dataclass
class GroupDef:
    name: str
    kind: DeviceKind
    device: object = None          # torch.device / str; None = cuda:0
    fixed_chunk: Optional[int] = None
    async_depth: int = 1
    priority_boost: bool = False
    slowdown: float = 1.0          # artificial slowdown for straggler tests
    fail_after_chunks: Optional[int] = None   # fault injection


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


class HeteroTrainer:
    def __init__(self, cfg: LMConfig, groups: List[GroupDef],
                 seq_len: int = 128, global_batch: int = 64,
                 oc: Optional[OptConfig] = None, seed: int = 0,
                 alpha: float = 0.5, repeat_data: bool = False,
                 params: Optional[Dict] = None):
        if not groups:
            raise ValueError("no device groups")
        self.devices = {g.name: resolve_device(g.device) for g in groups}
        cuda = sorted(n for n, d in self.devices.items() if d.type == "cuda")
        if cuda and cfg.activation_dtype != torch.bfloat16:
            raise ValueError(
                f"{cfg.arch_id} in {cfg.dtype} on CUDA (groups {cuda}): the "
                f"CUDA kernels take bfloat16; train {cfg.dtype} on the CPU")
        self.repeat_data = repeat_data
        self.cfg = cfg
        self.groups = groups
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.oc = oc or OptConfig()
        self.alpha = alpha
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
        self.step_idx = 0
        self.history: List[StepReport] = []

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

    def _make_executor(self, g: GroupDef) -> TorchChunkExecutor:
        cfg = self.cfg
        data = self.data
        device = self.devices[g.name]
        slowdown = g.slowdown

        def make_inputs(token):
            # chunk bounds are absolute sample indices: any group can
            # materialize any range, and re-executed chunks are identical
            c = token.chunk
            return data.batch(c.begin, c.end, pad_to=bucket(c.size))

        counter = {"n": 0}

        def step(batch):
            if g.fail_after_chunks is not None:
                counter["n"] += 1
                if counter["n"] > g.fail_after_chunks:
                    raise ChunkFailure(f"group {g.name} injected failure")
            if slowdown > 1.0:
                time.sleep((slowdown - 1.0) * 0.001 * batch["tokens"].shape[0])
            # this device's weights: the update writes them in place, on
            # another stream than this chunk's
            params = self.params if device == self.device \
                else self._copies[device]
            if device in self._written:
                torch.cuda.current_stream(device).wait_event(
                    self._written[device])
            grads, metrics = grad_step(cfg, params, batch)
            n = batch["loss_mask"][:, 0].sum()     # real examples in chunk
            return grads, metrics["loss"].detach() * n, n

        def fetch(outs):
            grads, loss_n, n = outs
            return {"grads": grads, "loss_n": float(loss_n), "n": float(n)}

        return TorchChunkExecutor(step, make_inputs, fetch, device=device,
                                  async_depth=g.async_depth,
                                  priority_boost=g.priority_boost)

    # ------------------------------------------------------------------
    def tune_accel_chunk(self, seed_chunk: int = 4, multiples: int = 6) -> int:
        """§3.2 G-search over real measured throughput of the accel group."""
        accel = [g for g in self.groups if g.kind == DeviceKind.ACCEL]
        if not accel:
            return seed_chunk
        g = accel[0]
        ex = self._make_executor(g)
        self._space_offset = 0

        def measure(c: int) -> float:
            c = min(c, self.global_batch)
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
            execs[g.name] = self._make_executor(g)
        sched = DynamicScheduler(specs, execs, alpha=self.alpha)
        self._space_offset = 0 if self.repeat_data \
            else self.step_idx * self.global_batch
        res = sched.run(self._space_offset,
                        self._space_offset + self.global_batch)

        # example-weighted gradient combine across groups, in fp32 on the
        # parameters' device, one leaf at a time; each chunk's leaf is
        # dropped once added. A CUDA leaf was made on its chunk's stream
        # and is read on this one: record_stream keeps its memory from that
        # stream's next allocations until the read is done
        results = [r for r in (rec.meta.get("result") for rec in res.records)
                   if r]
        total_loss = sum(r["loss_n"] for r in results)
        total_n = sum(r["n"] for r in results)
        assert total_n > 0, "no gradients collected"
        chunk_leaves = [tree_leaves(r.pop("grads")) for r in results]
        total = []
        for i in range(len(chunk_leaves[0])):
            acc = None
            for r, leaves in zip(results, chunk_leaves):
                term = leaves[i].to(self.device).float() * r["n"]
                if leaves[i].is_cuda:
                    leaves[i].record_stream(
                        torch.cuda.current_stream(leaves[i].device))
                leaves[i] = None
                acc = term if acc is None else acc.add_(term)
            total.append(acc.div_(total_n))
        del chunk_leaves
        total_g = tree_unflatten(self.params, total)
        self.params, self.opt, _ = adamw_update(
            self.oc, self.params, total_g, self.opt)
        del total_g, total
        self._refresh_copies()
        self._mark_written()
        self.step_idx += 1
        rep = StepReport(
            step=self.step_idx, loss=total_loss / total_n,
            examples=int(total_n), time_s=res.total_time,
            per_group_items=res.per_group_items,
            overheads=res.overheads, throughput=res.throughput,
            failed_groups=res.failed_groups)
        self.history.append(rep)
        return rep

    def train(self, steps: int) -> List[StepReport]:
        return [self.train_step() for _ in range(steps)]
