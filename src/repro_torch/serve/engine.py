"""HeteroServeEngine: the paper's scheduler applied to batched inference.

Torch counterpart of ``repro.serve.engine`` (the bare ``serve`` path). The
iteration space is the request queue; a chunk is a batch of requests. The
accelerator group's tuned chunk G is the throughput-optimal serving batch;
other groups get λ-proportional batches. Each chunk is prefill + a fixed
greedy decode burst; effective throughput is generated tokens / wall time,
which feeds eq. (4).

Each group runs on one torch device (``GroupDef.device``): a CUDA group
runs the model with the hand-written kernels on its executor's stream, a
CPU group runs the eager path. The kernels take bfloat16, so a CUDA group
with a config of another dtype is refused before any weight is placed.
The engine holds one copy of the weights per device that a group uses.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch import telemetry as telemetry_mod
from repro_torch.configs.base import LMConfig
from repro_torch.core import (ChunkFailure, DeviceKind, DynamicScheduler,
                              GroupSpec, TorchChunkExecutor)
from repro_torch.models import model as M


def bucket(n: int) -> int:
    b = 1
    while b < n:
        b *= 2
    return b


def resolve_device(device) -> torch.device:
    """``None`` means the card (``cuda:0``); with no CUDA device that
    raises instead of falling back to the CPU. The CPU is used only when
    asked for."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA GPU is available; pass device='cpu' to run on the "
                "CPU")
        return torch.device("cuda", 0)
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    return device


@dataclass
class GroupDef:
    name: str
    kind: DeviceKind
    device: Optional[object] = None   # torch.device / str; None = cuda:0
    fixed_chunk: Optional[int] = None
    async_depth: int = 1
    priority_boost: bool = False
    slowdown: float = 1.0          # artificial slowdown for straggler tests
    fail_after_chunks: Optional[int] = None   # fault injection


@dataclass
class ServeReport:
    requests: int
    new_tokens: int
    time_s: float
    per_group_items: Dict[str, int]
    overheads: Dict[str, Dict[str, float]]
    throughput: Dict[str, float]
    #: request index -> its generated tokens (decode_tokens,)
    tokens_out: Dict[int, np.ndarray] = field(default_factory=dict)


def _to_device(tree, device: torch.device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return tree.to(device)


class HeteroServeEngine:
    def __init__(self, cfg: LMConfig, groups: List[GroupDef],
                 prompt_len: int = 32, decode_tokens: int = 8,
                 max_len: Optional[int] = None, seed: int = 0,
                 chunk_mode: str = "range", telemetry=None,
                 params: Optional[Dict] = None):
        if not groups:
            raise ValueError("no device groups")
        self.cfg = cfg
        self.groups = groups
        self.devices = {g.name: resolve_device(g.device) for g in groups}
        cuda = sorted(n for n, d in self.devices.items() if d.type == "cuda")
        if cuda and cfg.activation_dtype != torch.bfloat16:
            raise ValueError(
                f"{cfg.arch_id} in {cfg.dtype} on CUDA (groups {cuda}): the "
                f"CUDA kernels take bfloat16; run {cfg.dtype} on the CPU")
        self.prompt_len = prompt_len
        self.decode_tokens = decode_tokens
        self.max_len = max_len or bucket(prompt_len + decode_tokens)
        self.seed = seed
        # "range": zero-contention dispatch (private λ-share ranges with
        # work stealing); "paper": the lock-per-token baseline
        self.chunk_mode = chunk_mode
        self.telemetry = telemetry_mod.resolve(telemetry)
        if params is None:
            dev = self.devices[groups[0].name]
            gen = torch.Generator(device=dev).manual_seed(seed)
            params = M.init_params(cfg, gen, dev)
        # one copy of the weights per device a group runs on
        self._params: Dict[torch.device, Dict] = {}
        for dev in self.devices.values():
            if dev not in self._params:
                self._params[dev] = _to_device(params, dev)
        # fail-injection counters persist across executors
        self._fail_counters: Dict[str, Dict[str, int]] = {}
        # executors are built once per group and reused across runs
        self._executors: Dict[str, TorchChunkExecutor] = {}

    # ------------------------------------------------------------------
    def _prompt(self, idx: int, rng_salt: int = 0) -> np.ndarray:
        rng = np.random.Generator(np.random.PCG64(
            (self.seed << 32) ^ (idx + rng_salt)))
        return rng.integers(0, self.cfg.vocab, self.prompt_len,
                            dtype=np.int32)

    def _make_executor(self, g: GroupDef) -> TorchChunkExecutor:
        cfg = self.cfg
        device = self.devices[g.name]
        params = self._params[device]

        def make_inputs(token):
            c = token.chunk
            pad = bucket(c.size)
            toks = np.stack([self._prompt(i) for i in range(c.begin, c.end)])
            if pad > c.size:
                toks = np.concatenate(
                    [toks, np.zeros((pad - c.size, self.prompt_len),
                                    np.int32)])
            out = {"tokens": toks}
            if cfg.prefix_len:
                rngp = np.random.Generator(np.random.PCG64(c.begin))
                out["prefix_emb"] = rngp.standard_normal(
                    (pad, cfg.prefix_len, cfg.d_model)).astype(np.float32) \
                    * 0.02
            return out

        counter = self._fail_counters.setdefault(g.name, {"n": 0})

        @torch.no_grad()
        def step(batch):
            if g.fail_after_chunks is not None:
                counter["n"] += 1
                if counter["n"] > g.fail_after_chunks:
                    raise ChunkFailure(f"group {g.name} injected failure")
            tokens = batch["tokens"]
            if g.slowdown > 1.0:
                time.sleep((g.slowdown - 1.0) * 0.001 * tokens.shape[0])
            # greedy decoding stays on the device: no token comes back to
            # the host before fetch()
            logits, cache = M.prefill(cfg, params, tokens,
                                      batch.get("prefix_emb"),
                                      max_len=self.max_len)
            tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
            toks = [tok]
            for _ in range(self.decode_tokens - 1):
                logits, cache = M.decode_step(cfg, params, cache, tok)
                tok = logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)
                toks.append(tok)
            return torch.cat(toks, dim=1)

        def fetch(outs):
            return {"tokens_out": outs.cpu().numpy()}

        return TorchChunkExecutor(step, make_inputs, fetch, device=device,
                                  async_depth=g.async_depth,
                                  priority_boost=g.priority_boost)

    def _executor_for(self, g: GroupDef) -> TorchChunkExecutor:
        ex = self._executors.get(g.name)
        if ex is None:
            ex = self._executors[g.name] = self._make_executor(g)
        return ex

    # ------------------------------------------------------------------
    def _build_scheduler(self, max_chunk: Optional[int] = None) \
            -> DynamicScheduler:
        specs, execs = {}, {}
        for g in self.groups:
            specs[g.name] = GroupSpec(g.name, g.kind,
                                      fixed_chunk=g.fixed_chunk,
                                      min_chunk=1, max_chunk=max_chunk,
                                      init_throughput=1.0)
            execs[g.name] = self._executor_for(g)
        return DynamicScheduler(specs, execs, alpha=0.5,
                                chunk_mode=self.chunk_mode,
                                telemetry=self._tel_arg())

    def _tel_arg(self):
        """Forward the engine's resolved telemetry (None after resolve
        means *uninstrumented*, so pass OFF, not None)."""
        return self.telemetry if self.telemetry is not None \
            else telemetry_mod.OFF

    def serve(self, n_requests: int) -> ServeReport:
        sched = self._build_scheduler(max_chunk=n_requests)
        res = sched.run(0, n_requests)
        tokens_out: Dict[int, np.ndarray] = {}
        for rec in res.records:
            result = rec.meta.get("result")
            if result is None:
                continue
            c = rec.token.chunk
            for i in range(c.size):
                tokens_out[c.begin + i] = result["tokens_out"][i]
        return ServeReport(
            requests=res.iterations,
            new_tokens=res.iterations * self.decode_tokens,
            time_s=res.total_time,
            per_group_items=res.per_group_items,
            overheads=res.overheads,
            throughput=res.throughput,
            tokens_out=tokens_out)
