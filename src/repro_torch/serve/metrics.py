"""Serving metrics: per-op latency quantiles, batch occupancy, QPS.

Latency is measured enqueue→completion (queueing + padding + device
time), which is what a client of the engine actually observes.  Samples
are kept in bounded reservoirs so a long-running engine never grows
unboundedly; p50/p99 come from the retained sample.
"""

from __future__ import annotations

import collections
from typing import Deque, Dict

import numpy as np

from repro_torch.serve.request import Op


class ServeMetrics:
    def __init__(self, *, reservoir: int = 16384):
        self._lat: Dict[Op, Deque[float]] = {
            op: collections.deque(maxlen=reservoir) for op in Op}
        self._count: Dict[Op, int] = {op: 0 for op in Op}
        self._batches: Dict[Op, int] = {op: 0 for op in Op}
        self._occupancy: Dict[Op, int] = {op: 0 for op in Op}
        self._t_start: float | None = None
        self._t_last: float | None = None
        #: the coalescing window each op is currently running under —
        #: with adaptive batch shaping this tracks the arrival-rate EMA
        #: (DESIGN.md §10); static configs just echo their constants
        self.windows: Dict[Op, float] = {op: 0.0 for op in Op}
        self.snapshot_resolves = 0
        self.maintenance_runs: Dict[str, int] = {
            "compact": 0, "reorder": 0, "consolidate": 0, "checkpoint": 0,
            "tier": 0}
        #: WAL accounting (zero when the engine runs without a WAL):
        #: records appended vs group commits actually fsync'd — the
        #: ratio is the group-commit amortization the config bought
        self.wal_records = 0
        self.wal_commits = 0
        #: deletes the engine dropped host-side as duplicates of an
        #: already-deleted external id or as never-allocated ids
        #: (relaxed coalescing can double-submit); the device-side
        #: count of absent-id no-ops lives on the backend stats surface
        #: (`VectorBackend.stats().delete_noops`)
        self.delete_noops = 0
        #: pumps that withheld pending write batches because an
        #: overlapped repair was in flight (relaxed mode; DESIGN.md §13)
        self.write_holds = 0

    def record_batch(self, op: Op, n: int, latencies, now: float) -> None:
        self._count[op] += n
        self._batches[op] += 1
        self._occupancy[op] += n
        self._lat[op].extend(latencies)
        if self._t_start is None:
            self._t_start = now
        self._t_last = now

    def _quantiles(self, op: Op):
        lat = np.asarray(self._lat[op], np.float64)
        if lat.size == 0:
            return {"p50_ms": 0.0, "p99_ms": 0.0}
        return {"p50_ms": float(np.percentile(lat, 50) * 1e3),
                "p99_ms": float(np.percentile(lat, 99) * 1e3)}

    def snapshot(self) -> dict:
        wall = 0.0
        if self._t_start is not None and self._t_last is not None:
            wall = max(self._t_last - self._t_start, 1e-9)
        out: dict = {"wall_s": round(wall, 4),
                     "snapshot_resolves": self.snapshot_resolves,
                     "delete_noops": self.delete_noops,
                     "write_holds": self.write_holds,
                     "maintenance": dict(self.maintenance_runs),
                     "wal": {"records": self.wal_records,
                             "commits": self.wal_commits}}
        for op in Op:
            nb = self._batches[op]
            out[op.value] = {
                "count": self._count[op],
                "batches": nb,
                "mean_batch": round(self._occupancy[op] / nb, 2) if nb else 0.0,
                "ops_per_s": round(self._count[op] / wall, 1) if wall else 0.0,
                "window_ms": round(self.windows[op] * 1e3, 4),
                **{k: round(v, 3) for k, v in self._quantiles(op).items()},
            }
        return out
