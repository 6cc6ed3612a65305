"""Exact kernel launch counts when the kernels run inside CUDA graphs.

Each kernel module keeps ``launches``, the kernel launches its wrapper
made, and ``_launches_lock``; the wrapper calls ``launched(name)`` where it
launches its kernel. A CUDA graph breaks the one-to-one: while a graph is
captured the wrappers run but launch nothing, and when it is replayed the
kernels launch but no wrapper runs. So:

- ``uncounted()`` tallies, per thread, the launches counted inside the
  block and takes them back when the block ends (a capture, and the eager
  warm-up before it);
- ``CountedGraph.replay()`` replays a graph and adds the tally of its
  capture, under the same locks.

The tally is the capturing thread's own: launches that other threads make
meanwhile (other executors' replays, say) are counted as usual.
"""
from __future__ import annotations

import contextlib
import importlib
import threading
from typing import Dict, Iterator, Optional

_tls = threading.local()


def _add(name: str, n: int) -> None:
    mod = importlib.import_module(f"repro_torch.kernels.{name}")
    with mod._launches_lock:        # exact under concurrent callers
        mod.launches += n


def launched(name: str) -> None:
    """Count one launch of kernel ``name``: called by its wrapper right
    after the launch (or, inside a capture, its recording)."""
    _add(name, 1)
    tally: Optional[Dict[str, int]] = getattr(_tls, "tally", None)
    if tally is not None:
        tally[name] = tally.get(name, 0) + 1


@contextlib.contextmanager
def uncounted() -> Iterator[Dict[str, int]]:
    """Yields the tally (kernel name -> launches) of this thread's
    launches inside the block; at its end, even on an error, they are
    taken back from the counts."""
    outer = getattr(_tls, "tally", None)
    tally: Dict[str, int] = {}
    _tls.tally = tally
    try:
        yield tally
    finally:
        _tls.tally = outer
        for name, n in tally.items():
            _add(name, -n)


class CountedGraph:
    """A captured graph (anything with ``replay()``) and the launches its
    capture tallied: each replay adds them to the counts."""

    def __init__(self, graph, launches: Dict[str, int]):
        self.graph = graph
        self.launches = dict(launches)

    def replay(self) -> None:
        self.graph.replay()
        for name, n in self.launches.items():
            _add(name, n)
