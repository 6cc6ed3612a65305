"""Append-only JSONL journal: durability + crash recovery for the queue.

Every state transition appends one line ``{"ts", "event", "job", "crc"}``
where ``crc`` is the CRC-32 of the canonical (sorted-keys) JSON of the
other three fields; the file is the source of truth after a crash.
Replay is last-write-wins per job id, with two hardening layers flushed
out by the chaos soak:

  * a torn final line (crash mid-write) is *truncated on open* — the
    classic artifact must not poison the next process's appends by
    gluing its first record onto the fragment; and
  * a line whose checksum does not match (bit rot, a corrupted flush)
    is skipped and counted, never trusted.

``recover()`` re-materializes the queue: jobs that were in flight
(ADMITTED / RUNNING / PENDING / REQUEUED) when the process died come back
as re-queueable jobs; terminal jobs come back as history.
"""
from __future__ import annotations

import json
import logging
import os
import threading
import time
import zlib
from typing import Callable, Dict, List, Optional, Tuple

from repro_torch.queue.job import Job, JobState

logger = logging.getLogger(__name__)

# how far back from EOF we look for the last newline when truncating a
# torn tail; a journal line is well under this
_TAIL_SCAN_BYTES = 65536


def _entry_line(job: Job, event: str, ts: Optional[float] = None) -> str:
    """One canonical journal line, checksum included.

    The crc covers the sorted-keys JSON of the payload *without* the crc
    field, so verification is: pop "crc", re-dump sorted, compare.
    (json round-trips float repr exactly, so re-dumping a parsed payload
    reproduces the original bytes.)
    """
    payload = {"ts": time.time() if ts is None else ts,
               "event": event, "job": job.to_dict()}
    body = json.dumps(payload, sort_keys=True)
    payload["crc"] = zlib.crc32(body.encode("utf-8")) & 0xFFFFFFFF
    return json.dumps(payload, sort_keys=True)


class JournalStore:
    def __init__(self, path: str, fsync: bool = False,
                 auto_compact_lines: Optional[int] = None,
                 write_filter: Optional[Callable[[str],
                                                Optional[str]]] = None):
        """``auto_compact_lines``: when set, record() triggers compact()
        once the journal holds at least that many lines — a long-lived
        daemon's journal stays O(live+finished jobs) instead of O(state
        transitions) with no operator cron job. None disables it.

        ``write_filter``: fault-injection seam (repro_torch.chaos). Called with
        each canonical line; a non-None return is written to the primary
        file *verbatim* in its place (torn / corrupted bytes). The mirror
        always receives the true line — the filter models a bad local
        disk, not a bad wire.
        """
        self.path = str(path)
        self.fsync = fsync
        self.auto_compact_lines = auto_compact_lines
        self.compactions = 0                 # observability / tests
        self.torn_truncations = 0            # torn tails cut on open
        self.mirror_detaches = 0             # sinks dropped on write error
        self._write_filter = write_filter
        self._lock = threading.Lock()
        directory = os.path.dirname(self.path)
        if directory:
            os.makedirs(directory, exist_ok=True)
        self._truncate_torn_tail()
        self._lines = 0
        # the line count only feeds the auto-compaction trigger; don't
        # pay an O(journal) scan on open when the feature is off
        if auto_compact_lines is not None and os.path.exists(self.path):
            with open(self.path, "r", encoding="utf-8") as fh:
                self._lines = sum(1 for _ in fh)
        # moving trigger: after a compaction that keeps k lines the next
        # one fires at max(threshold, 2k), so a journal whose *live* set
        # exceeds the threshold cannot thrash a full rewrite per record
        self._next_compact = auto_compact_lines
        self._mirror = None
        self._fh = open(self.path, "a", encoding="utf-8")

    def _truncate_torn_tail(self) -> None:
        """Cut an unterminated final line before opening for append.

        A crash mid-write leaves a fragment with no trailing newline;
        appending after it would weld the next record onto the fragment
        and lose *that* record too. Truncating back to the last newline
        confines the damage to the torn line itself.
        """
        if not os.path.exists(self.path):
            return
        with open(self.path, "rb+") as fh:
            fh.seek(0, os.SEEK_END)
            size = fh.tell()
            if size == 0:
                return
            fh.seek(size - 1)
            if fh.read(1) == b"\n":
                return
            scan = min(size, _TAIL_SCAN_BYTES)
            fh.seek(size - scan)
            tail = fh.read(scan)
            cut = tail.rfind(b"\n")
            keep = size - scan + cut + 1 if cut >= 0 else 0
            fh.truncate(keep)
        self.torn_truncations += 1
        logger.warning("journal %s: truncated torn final line "
                       "(%d bytes dropped)", self.path, size - keep)

    # -- replication ---------------------------------------------------
    def attach_mirror(self, mirror) -> None:
        """Attach a replication sink (duck-typed: ``append(line)`` plus
        optional ``rewrite(lines)`` applied on compaction). Each record
        is forwarded after its local write under the journal lock, so the
        sink always holds an ordered prefix of the primary — the
        guarantee federation failover replays against. A failing sink is
        detached rather than taking journaling (and the drain daemon
        above it) down."""
        self._mirror = mirror

    def has_mirror(self) -> bool:
        return self._mirror is not None

    def resync_mirror(self, mirror) -> int:
        """Re-attach a (replacement) sink after a detach: rewrite it from
        the primary's current per-job final state so it again holds a
        replayable copy, then resume forwarding. Returns lines synced."""
        with self._lock:
            jobs = self.replay(self.path)
            lines = [_entry_line(j, j.state.value)
                     for j in sorted(jobs.values(),
                                     key=lambda j: (j.created_at,
                                                    j.job_id))]
            mirror.rewrite(lines)
            self._mirror = mirror
            return len(lines)

    def _mirror_call(self, method: str, arg) -> None:
        mirror = self._mirror
        if mirror is None:
            return
        fn = getattr(mirror, method, None)
        if fn is None:
            return
        try:
            fn(arg)
        except Exception:
            logger.exception("journal mirror %s failed; detaching", method)
            self._mirror = None
            self.mirror_detaches += 1

    # -- write path ----------------------------------------------------
    def record(self, job: Job, event: Optional[str] = None) -> None:
        line = _entry_line(job, event or job.state.value)
        out = None
        if self._write_filter is not None:
            out = self._write_filter(line)
        with self._lock:
            self._fh.write(line + "\n" if out is None else out)
            self._fh.flush()
            if self.fsync:
                os.fsync(self._fh.fileno())
            self._lines += 1
            self._mirror_call("append", line)
            over = self._next_compact is not None \
                and self._lines >= self._next_compact
        if over:
            # outside the lock: compact() re-acquires it; a concurrent
            # second trigger just runs a cheap no-op rewrite. The record
            # itself is already durable — a failing compaction must not
            # take journaling (and the drain daemon above it) down with
            # it, so the trigger is disabled and appends continue
            try:
                self.compact()
            except OSError:
                logger.exception("journal auto-compaction failed; "
                                 "disabling the trigger")
                with self._lock:
                    self._next_compact = None

    def tear_tail(self) -> None:
        """Simulate a crash mid-write: append a partial record with no
        trailing newline (fault-injection hook used by ``kill_runtime``
        under a ``torn_write`` event). The next open truncates it."""
        with self._lock:
            self._fh.write('{"ts": 0, "event": "torn')
            self._fh.flush()

    def close(self) -> None:
        with self._lock:
            if not self._fh.closed:
                self._fh.close()

    # -- compaction ----------------------------------------------------
    def compact(self) -> int:
        """Rewrite the journal keeping only the latest record per job.

        A long-lived daemon's journal grows by one line per transition;
        replay only ever uses the last line per job id, so everything
        before it is dead weight. The rewrite goes to a temp file that is
        atomically renamed over the journal (a crash mid-compaction leaves
        either the old or the new file, never a mix); the append handle is
        reopened on the compacted file — or, if the rewrite fails, on the
        untouched original, so journaling survives a failed compaction
        (e.g. ENOSPC on the temp file). Returns the number of jobs kept.
        """
        with self._lock:
            if not self._fh.closed:
                self._fh.close()
            try:
                jobs = self.replay(self.path)
                lines = [_entry_line(job, job.state.value)
                         for job in sorted(jobs.values(),
                                           key=lambda j: (j.created_at,
                                                          j.job_id))]
                tmp = self.path + ".compact"
                with open(tmp, "w", encoding="utf-8") as fh:
                    for line in lines:
                        fh.write(line + "\n")
                    fh.flush()
                    if self.fsync:
                        os.fsync(fh.fileno())
                os.replace(tmp, self.path)
                self._mirror_call("rewrite", lines)
            finally:
                self._fh = open(self.path, "a", encoding="utf-8")
            self._lines = len(jobs)
            if self.auto_compact_lines is not None:
                self._next_compact = max(self.auto_compact_lines,
                                         2 * len(jobs))
            self.compactions += 1
            return len(jobs)

    def __enter__(self) -> "JournalStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- read path -----------------------------------------------------
    @classmethod
    def replay_stats(cls, path: str) \
            -> Tuple[Dict[str, Job], Dict[str, int]]:
        """replay() plus integrity counters.

        Returns ``(jobs, {"lines", "skipped", "crc_failures"})``.
        ``skipped`` counts every rejected line (unparseable or bad
        checksum); ``crc_failures`` counts the subset that parsed but
        failed verification. Lines without a "crc" field (journals from
        before checksumming) are accepted as-is.
        """
        jobs: Dict[str, Job] = {}
        stats = {"lines": 0, "skipped": 0, "crc_failures": 0}
        if not os.path.exists(path):
            return jobs, stats
        with open(path, "r", encoding="utf-8") as fh:
            for raw in fh:
                raw = raw.strip()
                if not raw:
                    continue
                stats["lines"] += 1
                try:
                    entry = json.loads(raw)
                    crc = entry.pop("crc", None)
                    if crc is not None:
                        body = json.dumps(entry, sort_keys=True)
                        if zlib.crc32(body.encode("utf-8")) \
                                & 0xFFFFFFFF != crc:
                            stats["crc_failures"] += 1
                            raise ValueError("journal crc mismatch")
                    job = Job.from_dict(entry["job"])
                except (json.JSONDecodeError, KeyError, TypeError,
                        ValueError, AttributeError):
                    stats["skipped"] += 1
                    continue
                jobs[job.job_id] = job
        if stats["skipped"]:
            logger.warning(
                "journal %s: skipped %d corrupt line(s) of %d "
                "(%d checksum failure(s))", path, stats["skipped"],
                stats["lines"], stats["crc_failures"])
        return jobs, stats

    @classmethod
    def replay(cls, path: str) -> Dict[str, Job]:
        """Reconstruct the final state of every journaled job.

        Corrupt / torn lines are skipped, not fatal: an append-only log's
        only legal corruption is a truncated tail or a bad flush, and
        checksums catch the latter.
        """
        jobs, _ = cls.replay_stats(path)
        return jobs

    @classmethod
    def recover(cls, path: str) -> Tuple[List[Job], Dict[str, Job]]:
        """Crash recovery: (jobs to re-admit, full final-state map).

        In-flight jobs are rewound to a re-queueable state: a RUNNING job
        becomes REQUEUED (its attempt died with the process); ADMITTED and
        REQUEUED jobs keep their state; PENDING jobs are returned as-is
        for a fresh admission decision.
        """
        jobs = cls.replay(path)
        to_requeue: List[Job] = []
        for job in jobs.values():
            if job.terminal:
                continue
            if job.state == JobState.RUNNING:
                job.transition(JobState.REQUEUED)
            to_requeue.append(job)
        to_requeue.sort(key=lambda j: (j.priority, j.created_at))
        return to_requeue, jobs
