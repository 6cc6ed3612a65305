"""Offline batch serving: whole calls of ``HeteroServeEngine.serve`` over a
fixed batch of requests, on one accelerator group.

The mix's parameters: ``prompt_len`` and ``decode_tokens`` of every
request, ``requests`` a call, the group's ``chunk`` (the paper's G) and
``async`` depth, ``traced_requests`` served by the traced call (a
multiple of ``chunk``: the profiler's trace of a whole call of the decode
mix holds millions of kernels), ``check_requests`` compared a run and
``check_rows`` run through the reference at once. A call serves requests
0 .. n - 1, whose prompts the engine derives from the seed, so every call
of a size does the same work. The warm-up is one call of ``requests``.
"""
from __future__ import annotations

import time
from typing import Dict, List

import torch

from gpubench import bench, check, weights
from gpubench.drivers.program import port_config
from gpubench.reference.layers import Precision, float32_matmuls


class Driver:
    kind = "serve"

    def __init__(self, config: Dict, mix: Dict, seed: int, device):
        self.config, self.mix, self.seed, self.device = \
            config, mix, seed, device
        self.family = bench.family(config)
        self.work = bench.work(config)
        self.asked = self.served = 0

    def setup(self) -> None:
        from repro_torch.core.types import DeviceKind
        from repro_torch.serve.engine import GroupDef, HeteroServeEngine
        mix = self.mix
        self.params = weights.make(self.family.param_specs(self.config),
                                   self.seed, self.device)
        self.engine = HeteroServeEngine(
            port_config(self.config),
            [GroupDef("accel", DeviceKind.ACCEL, device=self.device,
                      fixed_chunk=mix["chunk"], async_depth=mix["async"])],
            prompt_len=mix["prompt_len"], decode_tokens=mix["decode_tokens"],
            seed=self.seed, params=self.params)
        # one whole call as the window makes them: the first captures the
        # bucket's graphs, and no call in the window is a process's first
        self.engine.serve(mix["requests"])

    def _serve(self, requests: int) -> bench.Call:
        t0 = time.perf_counter()
        rep = self.engine.serve(requests)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        per = self.mix["prompt_len"] + self.mix["decode_tokens"]
        return bench.Call(rep.requests * per, dt, rep, rep.requests)

    def call(self) -> bench.Call:
        c = self._serve(self.mix["requests"])
        self.last = c.report
        self.asked += self.mix["requests"]
        self.served += sum(len(t) == self.mix["decode_tokens"]
                           for t in c.report.tokens_out.values())
        return c

    def traced_call(self) -> List[bench.Call]:
        return [self._serve(self.mix["traced_requests"])]

    def chunks(self, call: bench.Call) -> int:
        n = call.report.overheads["accel"]["n_chunks"]
        if call.items != n * self.mix["chunk"]:
            raise RuntimeError(f"{call.items} requests in {n} chunks of "
                               f"{self.mix['chunk']}")
        return n

    def model_flops(self, calls: List[bench.Call]) -> int:
        m = self.mix
        one = self.work.serve_flops(self.config, m["chunk"], m["prompt_len"],
                                    m["decode_tokens"])
        return sum(self.chunks(c) for c in calls) * one

    def kernel_work(self, calls: List[bench.Call]) -> Dict[str, list]:
        m = self.mix
        one = self.work.serve_kernels(self.config, m["chunk"],
                                      m["prompt_len"], m["decode_tokens"])
        n = sum(self.chunks(c) for c in calls)
        return {k: v * n for k, v in one.items()}

    def release(self) -> None:
        self.tokens_out = self.last.tokens_out
        del self.engine, self.last

    def check(self, ctx):
        float32_matmuls()
        m = self.mix
        pick = check.sample_requests(self.seed, m["requests"],
                                     m["check_requests"])
        missing = [i for i in pick if i not in self.tokens_out]
        served = {i: self.tokens_out[i] for i in pick
                  if i in self.tokens_out}
        gaps = check.served_gaps(self.family, self.config, self.params,
                                 self.seed, m["prompt_len"], served,
                                 self.device, Precision("float32"),
                                 rows=m["check_rows"])
        failed = self.asked - self.served + len(missing)
        return self.asked, failed, check.gap_numbers(gaps)
