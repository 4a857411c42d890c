"""Online serving on PyTorch: the counterpart of `repro.serve`.

Continuous micro-batching over the port's `VectorBackend` (DESIGN.md §8,
§10): an interleaved query/insert/delete stream becomes fixed-shape
micro-batches with snapshot-cached reads and threshold-driven
maintenance.  Everything here is host code (numpy id maps, the WAL,
queues, metrics); the only device work is the backend's, so the engine,
its WAL segments and its checkpoints match the reference's byte for
byte on the same stream.

- request    — Op/Request/Ticket plumbing
- queue      — arrival-ordered coalescing queue (strict/relaxed modes)
- scheduler  — ServeEngine: pad-and-mask dispatch, snapshot lifecycle,
  external-id ownership, adaptive batch shaping
- metrics    — p50/p99 latency, occupancy, QPS, chosen windows
- maintenance— tombstone/heat thresholds -> consolidate()/compact()/
  reorder(), applied per shard (lazy-delete consolidation: DESIGN.md §9)
- wal        — group-committed write-ahead log; with `ServeConfig.wal`
  set, acks imply durability and `ServeEngine.recover` restores the
  latest covering checkpoint + replays the tail (DESIGN.md §11)
"""

from repro_torch.serve.maintenance import MaintenanceManager, MaintenancePolicy
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.queue import CoalescingQueue
from repro_torch.serve.request import Op, QueryResult, Request, Ticket
from repro_torch.serve.scheduler import ServeConfig, ServeEngine
from repro_torch.serve.wal import WalConfig, WalRecord, WriteAheadLog

__all__ = [
    "Op", "QueryResult", "Request", "Ticket", "CoalescingQueue",
    "ServeMetrics", "MaintenancePolicy", "MaintenanceManager",
    "ServeConfig", "ServeEngine", "WalConfig", "WalRecord",
    "WriteAheadLog",
]
