"""Offload-overhead ledger — the paper's §3.3, eqs. (5)–(9).

Given the per-chunk timestamps of ChunkRecord:

  O_sp = Σ (Tc2 − Tc1) / T_total            scheduling + partitioning
  O_hd = Σ (Tg2 − Tg1) / T_total            host→device transfer
  O_kl = Σ (Tg3 − Tg2) / T_total            kernel launch
  O_dh = Σ (Tg5 − Tg4) / T_total            device→host transfer
  O_td = Σ ((Tc3 − Tc2) − (Tg5 − Tg1)) / T_total   host-thread dispatch

All terms are fractions of total wall time, accumulated over accelerator
chunks only (the paper measures the offload path).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional

from repro_torch.core.types import ChunkRecord, DeviceKind


@dataclass
class OverheadTotals:
    sp: float = 0.0
    hd: float = 0.0
    kl: float = 0.0
    dh: float = 0.0
    td: float = 0.0
    kernel: float = 0.0       # pure device-execute time (Tg4 − Tg3)
    n_chunks: int = 0

    def fractions(self, total_time: float) -> Dict[str, float]:
        t = max(total_time, 1e-12)
        return {"O_sp": self.sp / t, "O_hd": self.hd / t,
                "O_kl": self.kl / t, "O_dh": self.dh / t,
                "O_td": self.td / t, "kernel_frac": self.kernel / t,
                "n_chunks": self.n_chunks}


class OverheadLedger:
    def __init__(self):
        self._lock = threading.Lock()
        self._per_group: Dict[str, OverheadTotals] = {}
        self.records: List[ChunkRecord] = []
        self.keep_records: bool = True

    def add(self, rec: ChunkRecord) -> None:
        with self._lock:
            self._add_locked(rec)

    def add_many(self, recs) -> None:
        """Batched accumulate: one lock acquisition for a whole completion
        batch (the scheduler's per-worker finalize buffer)."""
        with self._lock:
            for rec in recs:
                self._add_locked(rec)

    def _add_locked(self, rec: ChunkRecord) -> None:
        tot = self._per_group.setdefault(rec.token.group,
                                         OverheadTotals())
        tot.sp += rec.tc2 - rec.tc1
        tot.hd += rec.tg2 - rec.tg1
        tot.kl += rec.tg3 - rec.tg2
        tot.dh += rec.tg5 - rec.tg4
        tot.td += max((rec.tc3 - rec.tc2) - (rec.tg5 - rec.tg1), 0.0)
        tot.kernel += rec.tg4 - rec.tg3
        tot.n_chunks += 1
        if self.keep_records:
            self.records.append(rec)

    def totals(self, group: Optional[str] = None) -> OverheadTotals:
        with self._lock:
            if group is not None:
                tot = self._per_group.get(group)
                # copy under the lock: handing out the live accumulator
                # would expose torn field pairs during a concurrent add
                return OverheadTotals() if tot is None else replace(tot)
            agg = OverheadTotals()
            for t in self._per_group.values():
                agg.sp += t.sp; agg.hd += t.hd; agg.kl += t.kl
                agg.dh += t.dh; agg.td += t.td; agg.kernel += t.kernel
                agg.n_chunks += t.n_chunks
            return agg

    def report(self, total_time: float, group: Optional[str] = None) \
            -> Dict[str, float]:
        return self.totals(group).fractions(total_time)

    def groups(self):
        with self._lock:
            return list(self._per_group)
