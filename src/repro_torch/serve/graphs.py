"""The serving step as CUDA graphs: the torch counterpart of the JAX
engine's per-bucket ``jax.jit`` of ``prefill`` and ``decode_step``
(``HeteroServeEngine._fns_for``).

``GraphedStep`` captures, for one executor and one batch bucket,
``M.prefill`` and ``M.decode_step`` as two CUDA graphs on the executor's
stream (``repro_torch.graphs.record``), and replays them after that; the
host's decode loop stays around them, as in the JAX engine.

- One eager warm-up of a prefill and a decode step comes first. A graph
  reads the split tickets and the RoPE tables it allocates at the
  addresses they had at capture, so they must live as long as the graph:
  K2's tickets are kept per (device, stream), so the graphs of two
  executors never share them, and the caches that hold them
  (``flash_decode._counters``, one buffer per (device, stream, b * kv
  heads), and ``transformer._rope``) never drop one.
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
- The weights are read at the addresses they had at capture; a call with
  other weight tensors is refused.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.graphs import GraphCounts, capturing, record, replay, \
    same_leaves
from repro_torch.models import model as M


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
        with capturing(device, counts), torch.no_grad():
            self._capture(max_len)

    def _capture(self, max_len: int) -> None:
        cfg, params = self.cfg, self.params

        def prefill():
            return M.prefill(cfg, params, self.tokens, self.prefix,
                             max_len=max_len)

        def warm():
            _, cache = prefill()
            M.decode_step(cfg, params, cache, self.token)

        pre = record(prefill, self.stream, 1, warm)
        self._prefill, (self.logits, self.cache) = pre.graph, pre.out
        leaves = {k: (t, t.data_ptr()) for k, t in self.cache.items()}
        dec = record(lambda: M.decode_step(cfg, params, self.cache,
                                           self.token),
                     self.stream, pool=pre.graph.graph.pool())
        self._decode, (self.decode_logits, cache) = dec.graph, dec.out
        if cache is not self.cache or any(
                self.cache[k] is not t or t.data_ptr() != p
                for k, (t, p) in leaves.items()):
            raise RuntimeError(f"{cfg.arch_id}: decode_step rebound a cache "
                               f"leaf; a replay would not see it")
        self.counts.captured({
            "executor": self.pair[0], "bucket": self.pair[1],
            "warmup_s": pre.warmup_s, "prefill_capture_s": pre.capture_s,
            "decode_capture_s": dec.capture_s,
            "prefill_launches": dict(self._prefill.launches),
            "decode_launches": dict(self._decode.launches),
            "pool_bytes": pre.pool_bytes + dec.pool_bytes})

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
