"""The serving step as CUDA graphs: the torch counterpart of the JAX
engine's per-bucket ``jax.jit`` of ``prefill`` and ``decode_step``
(``HeteroServeEngine._fns_for``).

``GraphedStep`` captures, for one executor and one batch bucket,
``M.prefill`` and ``M.decode_step`` as two CUDA graphs, and replays them
after that; the host's decode loop stays around them, as in the JAX
engine.

- Capture and replay run on the executor's stream. K2's split tickets are
  kept per (device, stream), so the graphs of two executors never share
  them. One eager warm-up on that stream comes first: it builds the
  kernels, sets their attributes, and allocates the tickets, the RoPE
  table and cuBLAS's workspace outside the graphs' memory pool; the
  blocks it leaves cached go back to the card before the capture, whose
  private pool could not reuse them. A graph
  reads each of them at the address it had at capture, so they must live
  as long as the graph: the caches that hold the tickets
  (``flash_decode._counters``, one buffer per (device, stream, b * kv
  heads)) and the RoPE tables (``transformer._rope``) never drop one.
- The inputs are static buffers: ``tokens`` (b, prompt_len) int32, the
  modality ``prefix`` (b, prefix_len, d_model) fp32 where the config has
  one, and the decode step's token (b, 1) int32. A call copies its
  arguments into them on the stream.
- The prefill graph allocates the bucket's cache. The decode graph is
  captured on that cache (``decode_step`` updates every leaf in place) and
  shares the prefill graph's pool, so the two are replayed in capture
  order on one stream: a prefill, then decode steps.
- The outputs (logits, cache) are static too: the next replay overwrites
  them, so a caller reads them (the engine's argmax) before it replays
  again, in stream order.
- Captures run in ``thread_local`` mode and take turns on a device
  (``capture_lock``): other dispatcher threads may query events,
  synchronise their streams and allocate meanwhile.
- The weights are read at the addresses they had at capture; a call with
  other weight tensors is refused.

The launches of a capture (its warm-up included) are not counted; each
replay counts those its capture recorded (``kernels.launch_count``).
Nothing here falls back to eager: a failed capture or replay raises, and
``GraphCounts.failures`` counts it.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.kernels.launch_count import CountedGraph, uncounted
from repro_torch.models import model as M

_capture_locks: Dict[torch.device, threading.Lock] = {}
_capture_locks_guard = threading.Lock()


def capture_lock(device: torch.device) -> threading.Lock:
    """The lock that captures on ``device`` take in turn."""
    with _capture_locks_guard:
        return _capture_locks.setdefault(torch.device(device),
                                         threading.Lock())


def same_leaves(a, b) -> bool:
    """Whether two weight trees hold the same tensors."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            same_leaves(a[k], b[k]) for k in a)
    return a is b


def replay(graph: CountedGraph, stream: torch.cuda.Stream, inputs,
           counts: "GraphCounts", pair: Tuple[str, int], read=None):
    """Copy ``inputs`` ((static buffer, tensor) pairs) and replay ``graph``
    on ``stream``; then, still on ``stream``, ``read()`` what must be taken
    from the static outputs before the next replay overwrites them, and
    return it. A caller on another stream (the tests, chip_smoke.py) is
    ordered around it both ways; an executor's own step, on that stream,
    needs no ordering."""
    caller = torch.cuda.current_stream(stream.device)
    other = caller != stream
    if other:
        stream.wait_stream(caller)
    with torch.cuda.stream(stream):
        for buf, t in inputs:
            buf.copy_(t)
        try:
            graph.replay()
        except BaseException:
            counts.failed()
            raise
        out = read() if read is not None else None
    counts.replayed(pair)
    if other:
        caller.wait_stream(stream)
    return out


class GraphCounts:
    """An engine's or a trainer's graph counters, shared by its dispatcher
    threads: captures (one per executor and bucket), replays (of any of
    its graphs, per (executor, bucket) too), failures (a capture or replay
    that raised), graphs dropped to make room for another bucket's (the
    trainer's), and the seconds of each capture (``capture_end``
    instantiates the graph, so a capture's seconds include its
    instantiation)."""

    def __init__(self):
        self._lock = threading.Lock()
        self.captures = 0
        self.replays = 0
        self.failures = 0
        self.drops = 0
        self.replays_by_pair: Dict[Tuple[str, int], int] = {}
        self.capture_log: List[Dict] = []

    def captured(self, entry: Dict) -> None:
        with self._lock:
            self.captures += 1
            self.capture_log.append(entry)

    def replayed(self, pair: Tuple[str, int]) -> None:
        with self._lock:
            self.replays += 1
            self.replays_by_pair[pair] = self.replays_by_pair.get(pair, 0) + 1

    def failed(self) -> None:
        with self._lock:
            self.failures += 1

    def dropped(self, n: int) -> None:
        with self._lock:
            self.drops += n

    def snapshot(self) -> Dict:
        with self._lock:
            return {"captures": self.captures, "replays": self.replays,
                    "failures": self.failures, "drops": self.drops,
                    "replays_by_pair": dict(self.replays_by_pair),
                    "capture_log": [dict(e) for e in self.capture_log]}


class GraphedStep:
    """One executor's prefill and decode-step graphs for batch bucket
    ``batch``; ``name`` labels the executor in the counts."""

    def __init__(self, cfg: LMConfig, params: Dict, batch: int,
                 prompt_len: int, max_len: int, stream: torch.cuda.Stream,
                 counts: GraphCounts, name: str = ""):
        self.cfg, self.params, self.stream = cfg, params, stream
        self.counts = counts
        self.pair = (name, batch)
        device = stream.device
        with torch.cuda.stream(stream):
            self.tokens = torch.zeros((batch, prompt_len), dtype=torch.int32,
                                      device=device)
            self.prefix = torch.zeros(
                (batch, cfg.prefix_len, cfg.d_model), dtype=torch.float32,
                device=device) if cfg.prefix_len else None
            self.token = torch.zeros((batch, 1), dtype=torch.int32,
                                     device=device)
        try:
            with capture_lock(device), torch.no_grad():
                self._capture(max_len)
        except BaseException:
            counts.failed()
            raise

    def _capture(self, max_len: int) -> None:
        cfg, params, stream = self.cfg, self.params, self.stream
        t0 = time.perf_counter()
        with torch.cuda.stream(stream), uncounted(stream):
            _, cache = M.prefill(cfg, params, self.tokens, self.prefix,
                                 max_len=max_len)
            M.decode_step(cfg, params, cache, self.token)
            del cache
        stream.synchronize()
        # the capture takes about what the warm-up took, in a private pool
        # that cannot use the blocks the warm-up left cached: they go back
        # to the card first
        with torch.cuda.device(stream.device):
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        prefill = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream), uncounted(stream) as tally:
            prefill.capture_begin(capture_error_mode="thread_local")
            try:
                self.logits, self.cache = M.prefill(
                    cfg, params, self.tokens, self.prefix, max_len=max_len)
            finally:
                prefill.capture_end()
        self._prefill = CountedGraph(prefill, tally)
        t2 = time.perf_counter()
        leaves = {k: (t, t.data_ptr()) for k, t in self.cache.items()}
        decode = torch.cuda.CUDAGraph()
        with torch.cuda.stream(stream), uncounted(stream) as tally:
            decode.capture_begin(pool=prefill.pool(),
                                 capture_error_mode="thread_local")
            try:
                self.decode_logits, cache = M.decode_step(
                    cfg, params, self.cache, self.token)
            finally:
                decode.capture_end()
        self._decode = CountedGraph(decode, tally)
        t3 = time.perf_counter()
        if cache is not self.cache or any(
                self.cache[k] is not t or t.data_ptr() != p
                for k, (t, p) in leaves.items()):
            raise RuntimeError(f"{cfg.arch_id}: decode_step rebound a cache "
                               f"leaf; a replay would not see it")
        self.counts.captured({
            "executor": self.pair[0], "bucket": self.pair[1],
            "warmup_s": t1 - t0, "prefill_capture_s": t2 - t1,
            "decode_capture_s": t3 - t2,
            "prefill_launches": dict(self._prefill.launches),
            "decode_launches": dict(self._decode.launches)})

    def _check(self, params: Dict, name: str, got: torch.Tensor,
               want: torch.Tensor) -> None:
        if params is not self.params and not same_leaves(params,
                                                          self.params):
            raise ValueError("the graphs read the weights they were "
                             "captured with; other weights were given")
        if got.shape != want.shape:
            raise ValueError(f"{name} {tuple(got.shape)}: the graph takes "
                             f"{tuple(want.shape)}")

    def prefill(self, params: Dict, tokens: torch.Tensor,
                prefix: Optional[torch.Tensor] = None):
        """``M.prefill(cfg, params, tokens, prefix, max_len)`` replayed:
        (static logits (b, 1, vocab), the bucket's cache)."""
        self._check(params, "tokens", tokens, self.tokens)
        if (prefix is None) != (self.prefix is None):
            raise ValueError(f"{self.cfg.arch_id}: prefix "
                             f"{'missing' if prefix is None else 'given'}")
        inputs = [(self.tokens, tokens)]
        if prefix is not None:
            self._check(params, "prefix", prefix, self.prefix)
            inputs.append((self.prefix, prefix))
        replay(self._prefill, self.stream, inputs, self.counts, self.pair)
        return self.logits, self.cache

    def decode(self, params: Dict, cache: Dict, tokens: torch.Tensor):
        """``M.decode_step(cfg, params, cache, tokens)`` replayed on the
        bucket's cache: (static logits (b, 1, vocab), the cache)."""
        self._check(params, "tokens", tokens, self.token)
        if cache is not self.cache:
            raise ValueError("the decode graph runs on its bucket's cache, "
                             "the one its prefill returned")
        replay(self._decode, self.stream, [(self.token, tokens)],
               self.counts, self.pair)
        return self.decode_logits, self.cache
