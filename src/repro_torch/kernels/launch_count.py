"""Exact kernel launch counts when the kernels run inside CUDA graphs.

Each kernel module keeps ``launches``, the kernel launches its wrapper
made, and ``_launches_lock``; the wrapper calls ``launched(name)`` where it
launches its kernel. A CUDA graph breaks the one-to-one: while a graph is
captured the wrappers run but launch nothing, and when it is replayed the
kernels launch but no wrapper runs. So:

- ``uncounted(stream)`` tallies the launches counted inside the block and
  takes them back when the block ends (a capture, and the eager warm-up
  before it);
- ``CountedGraph.replay()`` replays a graph and adds the tally of its
  capture, under the same locks.

The tally is the capturing thread's own, and takes the launches other
threads make on the capture's stream: the autograd engine runs a
backward's operators (a recomputed block's kernels among them) on a
thread of its own, on the stream of their forward. Launches that other
threads make on other streams meanwhile (other executors' replays, say)
are counted as usual.
"""
from __future__ import annotations

import contextlib
import importlib
import threading
from typing import Dict, Iterator, Optional

_tls = threading.local()
#: a stream's ``cuda_stream`` -> the tally of the block ``uncounted`` holds
#: on it; the lock guards this map and every tally's updates
_stream_tallies: Dict[int, Dict[str, int]] = {}
_tally_lock = threading.Lock()


def _add(name: str, n: int) -> None:
    mod = importlib.import_module(f"repro_torch.kernels.{name}")
    with mod._launches_lock:        # exact under concurrent callers
        mod.launches += n


def launched(name: str, stream=None) -> None:
    """Count one launch of kernel ``name`` on ``stream`` (a
    ``torch.cuda.Stream``): called by its wrapper right after the launch
    (or, inside a capture, its recording)."""
    _add(name, 1)
    with _tally_lock:
        tally: Optional[Dict[str, int]] = getattr(_tls, "tally", None)
        if tally is None and stream is not None:
            tally = _stream_tallies.get(stream.cuda_stream)
        if tally is not None:
            tally[name] = tally.get(name, 0) + 1


@contextlib.contextmanager
def uncounted(stream=None) -> Iterator[Dict[str, int]]:
    """Yields the tally (kernel name -> launches) of this thread's
    launches inside the block and, where ``stream`` is given, of other
    threads' launches on it while the block lasts; at its end, even on an
    error, they are taken back from the counts."""
    outer = getattr(_tls, "tally", None)
    tally: Dict[str, int] = {}
    key = None if stream is None else stream.cuda_stream
    with _tally_lock:
        _tls.tally = tally
        if key is not None:
            outer_on_stream = _stream_tallies.get(key)
            _stream_tallies[key] = tally
    try:
        yield tally
    finally:
        with _tally_lock:
            _tls.tally = outer
            if key is not None:
                if outer_on_stream is None:
                    del _stream_tallies[key]
                else:
                    _stream_tallies[key] = outer_on_stream
            taken = list(tally.items())
        for name, n in taken:
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
