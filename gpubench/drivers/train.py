"""Training: whole calls of ``HeteroTrainer.train_step`` on one
accelerator group, each a step over a new global batch.

The mix's parameters: ``seq_len``, ``global_batch``, the group's
``chunk`` and ``async`` depth, the optimizer's settings (``opt``, the
program's ``OptConfig`` fields), ``check_steps`` followed by the
reference and ``check_rows`` it runs at once. Set-up builds the trainer
and drives it through its first ``check_steps`` steps by the window's own
call (the first captures the bucket's CUDA graph), reading each step's
loss, the optimizer's first gradient and, after the last, each weight's
change; the window goes on with the same trainer.
"""
from __future__ import annotations

import time
from typing import Dict, List

import torch

from gpubench import bench, check, weights
from gpubench.drivers.program import port_config
from gpubench.reference import training
from gpubench.reference.layers import Precision, float32_matmuls


def _norms(tree) -> Dict[str, float]:
    return {k: float(t.float().norm()) for k, t in weights.leaves(tree)}


class Driver:
    kind = "train"

    def __init__(self, config: Dict, mix: Dict, seed: int, device):
        self.config, self.mix, self.seed, self.device = \
            config, mix, seed, device
        self.family = bench.family(config)
        self.work = bench.work(config)
        self.steps = self.bad_steps = 0

    def setup(self) -> None:
        from repro_torch.core.types import DeviceKind
        from repro_torch.train.optimizer import OptConfig
        from repro_torch.train.trainer import GroupDef, HeteroTrainer
        mix = self.mix
        params = weights.make(self.family.param_specs(self.config),
                              self.seed, self.device)
        start = {k: t.to("cpu", copy=True) for k, t in weights.leaves(params)}
        self.trainer = HeteroTrainer(
            port_config(self.config),
            [GroupDef("accel", DeviceKind.ACCEL, device=self.device,
                      fixed_chunk=mix["chunk"], async_depth=mix["async"])],
            seq_len=mix["seq_len"], global_batch=mix["global_batch"],
            oc=OptConfig(**mix["opt"]), seed=self.seed, repeat_data=False,
            params=params)
        del params
        losses = []
        for step in range(1, mix["check_steps"] + 1):
            losses.append(self._step().report.loss)
            if step == 1:
                b1 = mix["opt"]["beta1"]
                grad = {k: v / (1 - b1)
                        for k, v in _norms(self.trainer.opt["m"]).items()}
        change = {k: float((t.float() - start[k].to(t.device).float()).norm())
                  for k, t in weights.leaves(self.trainer.opt["master"])}
        self.readings = {"loss": losses, "grad": grad, "change": change}

    def _step(self) -> bench.Call:
        t0 = time.perf_counter()
        rep = self.trainer.train_step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        return bench.Call(rep.examples * self.mix["seq_len"], dt, rep,
                          rep.examples)

    def call(self) -> bench.Call:
        c = self._step()
        self.steps += 1
        if c.items != self.mix["global_batch"] or c.report.failed_groups:
            self.bad_steps += 1
        return c

    def traced_call(self) -> List[bench.Call]:
        return [self._step() for _ in range(self.mix["traced_steps"])]

    def _chunks(self, calls: List[bench.Call]) -> int:
        n = sum(c.report.overheads["accel"]["n_chunks"] for c in calls)
        if sum(c.items for c in calls) != n * self.mix["chunk"]:
            raise RuntimeError("a step's chunks are not all of "
                               f"{self.mix['chunk']} examples")
        return n

    def model_flops(self, calls: List[bench.Call]) -> int:
        m = self.mix
        return self._chunks(calls) * self.work.train_flops(
            self.config, m["chunk"], m["seq_len"])

    def kernel_work(self, calls: List[bench.Call]) -> Dict[str, list]:
        one = self.work.train_kernels(self.config, self.mix["chunk"],
                                      self.mix["seq_len"])
        n = self._chunks(calls)
        return {k: v * n for k, v in one.items()}

    def release(self) -> None:
        del self.trainer

    def check(self, ctx):
        float32_matmuls()
        m = self.mix
        params = weights.make(self.family.param_specs(self.config),
                              self.seed, self.device)
        ref = training.readings(self.family, self.config, params, self.seed,
                                m["seq_len"], m["global_batch"], m["opt"],
                                m["check_steps"], self.device,
                                Precision("float32"), rows=m["check_rows"])
        numbers = check.training_numbers(self.readings, ref)
        ctx.log(f"worst leaves: gradient {numbers.pop('grad_leaf')}, "
                f"change {numbers.pop('change_leaf')}")
        return self.steps, self.bad_steps, numbers
