"""The trainer's gradient step as a CUDA graph: the torch counterpart of
the JAX trainer's per-chunk-size ``jax.jit`` of its gradient step
(``HeteroTrainer._grad_fn``).

``GraphedGradStep`` captures, for one executor and one batch bucket,
``chunk_grad_step`` (the forward with remat, ``torch.autograd.grad``, the
chunk's loss times n and n) as one CUDA graph, and replays it for every
chunk of that bucket.

- The inputs are static buffers shaped as the data pipeline's batch of
  the bucket (``static_batch``). A call copies the chunk's batch into them
  on the executor's stream.
- The capture (``repro_torch.graphs.record``) comes after
  ``WARMUP_STEPS`` eager steps on the executor's stream.
- The weights are read at their capture-time addresses. The trainer
  updates them in place (``adamw_update``, ``_refresh_copies``) and drops
  its graphs when it takes other tensors (``load_state``); a call with
  other weight tensors is refused.
- The outputs (the gradients, loss times n, n) are static: the next replay
  overwrites them. A call clones them on the stream right after its
  replay, so a chunk still in flight keeps its gradients until the
  trainer's combine reads them, with ``async_depth`` of 2 or more.
- The pool holds a whole chunk's activations and gradients for the
  graph's life; each capture's entry in ``GraphCounts.capture_log`` has
  the bytes it reserved (``pool_bytes``).
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs.base import LMConfig
from repro_torch.graphs import GraphCounts, capturing, record, replay, \
    same_leaves
from repro_torch.train.optimizer import tree_map
from repro_torch.train.train_step import chunk_grad_step

#: eager steps before a capture: PyTorch's notes on CUDA graphs warm a
#: captured backward up three times on a side stream
WARMUP_STEPS = 3


def static_batch(cfg: LMConfig, bucket: int, seq_len: int,
                 device) -> Dict[str, torch.Tensor]:
    """Zeros shaped as ``data.pipeline``'s batch of ``bucket`` rows of a
    trainer with ``seq_len``: ``tokens`` and ``labels`` (b, text length)
    int32, ``loss_mask`` (b, text length) fp32 and, where the config has a
    modality prefix, ``prefix_emb`` (b, prefix_len, d_model) fp32."""
    text = (bucket, seq_len - cfg.prefix_len)
    batch = {"tokens": torch.zeros(text, dtype=torch.int32, device=device),
             "labels": torch.zeros(text, dtype=torch.int32, device=device),
             "loss_mask": torch.zeros(text, dtype=torch.float32,
                                      device=device)}
    if cfg.prefix_len:
        batch["prefix_emb"] = torch.zeros(
            (bucket, cfg.prefix_len, cfg.d_model), dtype=torch.float32,
            device=device)
    return batch


class GraphedGradStep:
    """One executor's captured ``chunk_grad_step`` for batch bucket
    ``bucket``; ``name`` labels the executor in the counts. Called as
    ``chunk_grad_step(cfg, params, batch)`` is: (grads, loss * n, n)."""

    def __init__(self, cfg: LMConfig, params: Dict, bucket: int,
                 seq_len: int, stream: torch.cuda.Stream,
                 counts: GraphCounts, name: str = ""):
        self.cfg, self.params, self.stream = cfg, params, stream
        self.counts = counts
        self.pair = (name, bucket)
        with torch.cuda.stream(stream):
            self.batch = static_batch(cfg, bucket, seq_len, stream.device)
        with capturing(stream.device, counts), torch.enable_grad():
            rec = record(lambda: chunk_grad_step(cfg, params, self.batch),
                         stream, WARMUP_STEPS)
        self._graph, self.out = rec.graph, rec.out
        counts.captured({
            "executor": name, "bucket": bucket, "warmup_s": rec.warmup_s,
            "capture_s": rec.capture_s, "launches": dict(rec.graph.launches),
            "pool_bytes": rec.pool_bytes})

    def _clone(self):
        grads, loss_n, n = self.out
        return tree_map(torch.clone, grads), loss_n.clone(), n.clone()

    def __call__(self, params: Dict, batch: Dict[str, torch.Tensor]):
        if params is not self.params and not same_leaves(params,
                                                         self.params):
            raise ValueError("the graph reads the weights it was captured "
                             "with; other weights were given")
        if batch.keys() != self.batch.keys() or any(
                batch[k].shape != t.shape or batch[k].dtype != t.dtype
                for k, t in self.batch.items()):
            raise ValueError(
                f"batch {_described(batch)}: the graph takes "
                f"{_described(self.batch)}")
        return replay(self._graph, self.stream,
                      [(t, batch[k]) for k, t in self.batch.items()],
                      self.counts, self.pair, read=self._clone)


def _described(batch: Dict[str, torch.Tensor]) -> Dict:
    return {k: (tuple(t.shape), str(t.dtype)) for k, t in batch.items()}
