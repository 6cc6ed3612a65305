"""Journal replication: each runtime's JSONL journal mirrored to a peer.

The single-runtime journal already gives crash recovery *if the file
survives*; federation needs recovery when the runtime (and, in a real
deployment, its disk) is gone. The scheme is ring replication: runtime
``i``'s journal is mirrored, line by line, to a replica file owned by
peer ``(i+1) % N`` (``ReplicaSink`` attached via
``JournalStore.attach_mirror`` — every durable primary write is forwarded
under the journal lock, so the replica is always an ordered prefix of
the primary). On ``kill_runtime`` the federation replays the replica
through the survivor's ``JobService.recover``, which rewinds RUNNING →
REQUEUED and re-gates PENDING — conserving work and deadline/tier
metadata, deduplicated by job id.

Compaction coherence: when the primary compacts, the sink rewrites the
replica to the same compacted line set (temp file + atomic rename, like
the primary), so a replica never diverges past one in-flight record.
"""
from __future__ import annotations

import os
import threading
from typing import Dict, List, Sequence


class ReplicaSink:
    """Mirror target for one runtime's journal (see
    ``JournalStore.attach_mirror``): ``append`` forwards one record line,
    ``rewrite`` replaces the replica with a compacted line set."""

    def __init__(self, path: str):
        self.path = str(path)
        directory = os.path.dirname(self.path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        self._lock = threading.Lock()
        self._fh = open(self.path, "a", encoding="utf-8")

    def append(self, line: str) -> None:
        with self._lock:
            self._fh.write(line + "\n")
            self._fh.flush()

    def rewrite(self, lines: Sequence[str]) -> None:
        with self._lock:
            self._fh.close()
            tmp = self.path + ".compact"
            with open(tmp, "w", encoding="utf-8") as fh:
                for line in lines:
                    fh.write(line + "\n")
                fh.flush()
            os.replace(tmp, self.path)
            self._fh = open(self.path, "a", encoding="utf-8")

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()


class ReplicationRing:
    """The who-holds-whose-replica layout: runtime ``i``'s journal is
    mirrored to peer ``(i+1) % N``. Pure bookkeeping — paths and peer
    ids — so the federation service and tests agree on where a victim's
    replica lives after any subset of kills."""

    def __init__(self, runtime_ids: Sequence[str], directory: str):
        self.runtime_ids = list(runtime_ids)
        self.directory = str(directory)
        os.makedirs(self.directory, exist_ok=True)
        self._peer: Dict[str, str] = {}
        n = len(self.runtime_ids)
        for i, rid in enumerate(self.runtime_ids):
            self._peer[rid] = self.runtime_ids[(i + 1) % n] if n > 1 \
                else rid

    def journal_path(self, rid: str) -> str:
        return os.path.join(self.directory, f"{rid}.journal.jsonl")

    def replica_path(self, rid: str) -> str:
        """Where ``rid``'s mirror lives (owned by its peer)."""
        return os.path.join(self.directory, f"{rid}.replica.jsonl")

    def peer_of(self, rid: str) -> str:
        return self._peer[rid]

    def make_sink(self, rid: str) -> ReplicaSink:
        return ReplicaSink(self.replica_path(rid))

    def recovery_source(self, rid: str) -> str:
        """The journal to replay for a dead ``rid``: the replica its peer
        holds when present, else the primary (single-runtime rings, or a
        mirror that never attached)."""
        replica = self.replica_path(rid)
        if os.path.exists(replica):
            return replica
        return self.journal_path(rid)

    def recovery_sources(self, rid: str) -> List[str]:
        """Every journal worth consulting for a dead ``rid``, replica
        first. The two can disagree in both directions: after a mirror
        detach the replica is a stale prefix of the primary, and after a
        torn/corrupted primary write the replica holds the true record
        the primary lost. Failover merges them (terminal verdicts win)
        instead of trusting either alone."""
        out: List[str] = []
        replica = self.replica_path(rid)
        if os.path.exists(replica):
            out.append(replica)
        primary = self.journal_path(rid)
        if os.path.exists(primary):
            out.append(primary)
        return out or [primary]
