"""The index's protocol, typed results and search knobs (copied from
`repro.core.backend`, numpy only).

`VectorBackend` is what a serving layer requires of an index, and
`LSMVecIndex` (`core/index.py`) implements it.  Search is two-phase:
`dispatch_search` returns a `SearchHandle` whose `collect()` brings back
a `SearchResult`; `insert_batch`/`delete_batch` return an
`UpdateResult`; `SearchParams` is the one place search defaults are
resolved from a config; `maintain` returns a `MaintenanceReport`, and
`begin_maintain`/`poll_maintain` run a consolidation beside serving.
`stats()` returns `BackendStats` (one `ShardStats` a shard, with a
`MemoryBreakdown`).  `merge_topk` and `shard_of_seq` are the host-side
merge and routing of a sharded backend.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Protocol, Sequence, runtime_checkable

import numpy as np


@dataclass(frozen=True)
class SearchResult:
    """Batched ANN search result in the backend's internal id space.

    `ids` int [B, k] (-1 pads under-full rows), `dists` f32 [B, k]
    (squared L2, +inf on pads).
    """

    ids: np.ndarray
    dists: np.ndarray


@dataclass(frozen=True)
class UpdateResult:
    """Result of a batched mutation.

    For inserts, `ids` holds the new internal ids in submission order;
    for deletes, the internal ids the batch targeted (−1 = masked pad).
    `n_applied` counts items the backend dispatched (inserts allocated;
    deletes with a routable non-negative id).  Dispatched deletes that
    turn out to be device-side no-ops (absent/already-dead ids) are NOT
    subtracted here — they are reported once, in
    `stats().delete_noops`, so the two counts never drift.
    """

    ids: np.ndarray
    n_applied: int


@dataclass(frozen=True)
class SearchParams:
    """Typed search knobs — the one place defaults are resolved.

    A `None` field means "use the backend config default" (resolved via
    `resolve(cfg)` at the dispatch boundary, nowhere else).
    `record_heat=None` defers to the caller's policy: `LSMVecIndex`
    resolves it to True, `ServeEngine` resolves it from its tier policy.
    `use_snapshot` selects the cached dense-read snapshot (serving
    path); `pad_to` pads the query batch to a fixed traced width.
    """

    rho: Optional[float] = None
    ef: Optional[int] = None
    use_filter: Optional[bool] = None
    n_expand: Optional[int] = None
    record_heat: Optional[bool] = None
    use_snapshot: bool = False
    pad_to: Optional[int] = None

    def resolve(self, cfg) -> "SearchParams":
        """Fill `None` knobs from an `HNSWConfig` — the single
        config-derived-defaults site for the whole stack."""
        return SearchParams(
            rho=float(cfg.rho if self.rho is None else self.rho),
            ef=int(cfg.ef_search if self.ef is None else self.ef),
            use_filter=bool(cfg.use_filter if self.use_filter is None
                            else self.use_filter),
            n_expand=int(cfg.n_expand if self.n_expand is None
                         else self.n_expand),
            record_heat=(True if self.record_heat is None
                         else bool(self.record_heat)),
            use_snapshot=bool(self.use_snapshot),
            pad_to=self.pad_to,
        )

    def replace(self, **kw) -> "SearchParams":
        return dataclasses.replace(self, **kw)


@dataclass(frozen=True)
class MaintenanceReport:
    """Uniform result of one `maintain(op)` invocation.

    `applied` is False when the op's own trigger rule declined to run
    (e.g. consolidate below the tombstone-ratio threshold).
    `reclaimed` — tombstone slots spliced out (consolidate);
    `perm` — internal-id permutation applied (reorder), else None;
    `demoted`/`promoted` — tier lane moves (tier).  `detail` carries
    op-specific extras (per-shard counts etc.).
    """

    op: str
    applied: bool
    reclaimed: int = 0
    perm: Optional[np.ndarray] = None
    demoted: int = 0
    promoted: int = 0
    detail: dict = field(default_factory=dict)


@runtime_checkable
class SearchHandle(Protocol):
    """An in-flight search: device work dispatched, host read deferred.

    `collect()` returns the final `SearchResult`; it is called exactly
    once.  `is_ready()` is a non-blocking poll (True once the search's
    device work has finished — advisory, collect() is always safe).
    """

    def collect(self) -> SearchResult: ...

    def is_ready(self) -> bool: ...


@dataclass(frozen=True)
class MemoryBreakdown:
    """Per-component resident-byte accounting (DESIGN.md §12).

    Every field is bytes except the trailing lane counts.  `hot_vectors`
    is the dense f32 lane (with tiering off, every routable node is in
    it — the dense baseline fig6 compares against); `cold_codes` is the
    int8 + per-row-scale lane.  The serving-state components the old
    accounting omitted — tombstone lane, insert-overlay staging buffers,
    and the ext↔int id maps a serving layer must hold 1:1 with backend
    capacity — are included so fig6 numbers are honest about the full
    stack, not just the index arrays.  Adding two breakdowns adds
    componentwise (shard aggregation).
    """

    hot_vectors: int = 0     # dense-lane f32 rows
    cold_codes: int = 0      # int8 rows + f32 per-row scales
    upper_graph: int = 0     # upper-layer adjacency arrays
    upper_vec_cache: int = 0  # upper-node f32 rows cached for descent
    simhash_codes: int = 0   # per-node simhash codes (both lanes)
    memtable: int = 0        # LSM memtable (keys + rows + valid lane)
    tombstones: int = 0      # lazy-delete bitmap (capacity-sized)
    insert_overlay: int = 0  # insert_batch staging overlay (rows + valid)
    id_maps: int = 0         # serving ext↔int int64 maps (2 x cap)
    misc: int = 0            # entry/counters/rng etc.
    n_hot: int = 0           # dense-lane row count (not bytes)
    n_cold: int = 0          # cold-lane row count (not bytes)

    _BYTE_FIELDS = ("hot_vectors", "cold_codes", "upper_graph",
                    "upper_vec_cache", "simhash_codes", "memtable",
                    "tombstones", "insert_overlay", "id_maps", "misc")

    @property
    def total(self) -> int:
        return sum(getattr(self, f) for f in self._BYTE_FIELDS)

    def __add__(self, other: "MemoryBreakdown") -> "MemoryBreakdown":
        kw = {f: getattr(self, f) + getattr(other, f)
              for f in self._BYTE_FIELDS + ("n_hot", "n_cold")}
        return MemoryBreakdown(**kw)

    def as_dict(self) -> dict:
        d = {f: int(getattr(self, f)) for f in
             self._BYTE_FIELDS + ("n_hot", "n_cold")}
        d["total"] = int(self.total)
        return d


@dataclass(frozen=True)
class ShardStats:
    """Per-shard slice of `BackendStats`."""

    size: int            # live (returnable) nodes
    n_tombstones: int    # lazily deleted, not yet consolidated
    delete_noops: int    # device-counted deletes of absent/dead ids
    n_hot: int = 0       # dense-lane rows (== size+tombstones, tier off)
    n_cold: int = 0      # quantized-lane rows

    @property
    def tombstone_ratio(self) -> float:
        return self.n_tombstones / max(self.size + self.n_tombstones, 1)


@dataclass(frozen=True)
class BackendStats:
    """The backend stats surface, the single source for serving metrics
    (the device-side delete no-op count is read here and nowhere else).
    `max_tombstone_ratio` is the per-shard maximum: the maintenance
    trigger fires when any shard crosses the threshold."""

    size: int
    n_tombstones: int
    delete_noops: int
    max_tombstone_ratio: float
    shards: tuple = ()     # tuple[ShardStats, ...], one entry per shard
    # per-component resident bytes, aggregated across shards
    memory: Optional[MemoryBreakdown] = None


@runtime_checkable
class VectorBackend(Protocol):
    """What a serving layer requires of an index.

    Reads: `dispatch_search(queries, k, params=...)` starts the search
    and returns a `SearchHandle`; `search` is dispatch + collect.
    Mutations: `insert_batch` / `delete_batch` take `pad_to`, a fixed
    micro-batch width.  Maintenance: `maintain(op, **params)` covers
    consolidate/compact/reorder/tier and returns a `MaintenanceReport`;
    `begin_maintain`/`poll_maintain` run a consolidation beside serving
    (repair on a copy of the state, cutover at once).  `initial_ids`
    seeds an external-id map: internal ids in allocation order.
    """

    @property
    def cap(self) -> int: ...                 # total internal id space

    @property
    def lazy_delete(self) -> bool: ...

    @property
    def snapshot_stale(self) -> bool: ...     # next snapshot read re-resolves

    def search(self, queries, k: Optional[int] = None, *,
               params: Optional[SearchParams] = None) -> SearchResult: ...

    def dispatch_search(self, queries, k: Optional[int] = None, *,
                        params: Optional[SearchParams] = None
                        ) -> SearchHandle: ...

    def insert_batch(self, xs, *,
                     pad_to: Optional[int] = None) -> UpdateResult: ...

    def delete_batch(self, ids, *,
                     pad_to: Optional[int] = None) -> UpdateResult: ...

    def maintain(self, op: str, **params) -> MaintenanceReport: ...

    # `begin_maintain("consolidate", ...)` starts a repair against a copy
    # of the live state and returns True iff one was started (False:
    # trigger declined, or a repair is already in flight).  Queries keep
    # serving from the live state; `poll_maintain()` cuts over once the
    # repair is done and returns its report (None while it runs or when
    # nothing is in flight; `block=True` waits for it).  Mutations wait
    # for an in-flight repair first, so the cutover always lands on a
    # write-batch boundary.
    def begin_maintain(self, op: str, **params) -> bool: ...

    def poll_maintain(self, *, block: bool = False
                      ) -> Optional[MaintenanceReport]: ...

    def stats(self) -> BackendStats: ...

    def memory_bytes(self) -> int: ...        # MemoryBreakdown total

    def heat_total(self) -> int: ...

    def reset_heat(self) -> None: ...

    def initial_ids(self) -> np.ndarray: ...

    def trace_counts(self) -> dict: ...

    def sync(self) -> None: ...               # block until device work done

    # `save` writes an atomic full-state checkpoint (staged directory +
    # rename) whose manifest records `lsn`, the log position it covers.
    # `extra` carries caller-owned arrays and `meta` caller scalars; both
    # come back from the implementation's classmethod
    #   restore(cfg, ckpt_dir, ...) -> (backend, metadata, extras)
    # which refuses a layout mismatch (cap, dim) rather than load it.
    def save(self, ckpt_dir: str, *, lsn: int = 0,
             extra: Optional[dict] = None, meta: Optional[dict] = None,
             keep: int = 3, _pre_publish=None) -> str: ...


def merge_topk(gids: Sequence[np.ndarray], dists: Sequence[np.ndarray],
               k: int) -> SearchResult:
    """Host-side top-k merge of per-shard results.

    Each shard contributes its local top-k (`gids[s]` int [B, k_s] in
    the global id space, -1 pads; `dists[s]` f32 with +inf on pads).
    Rows are distance-sorted per shard, so the stable sort is a
    deterministic P-way merge: ties go to the lower shard, and with one
    shard the merge is the identity.
    """
    flat_i = np.concatenate(gids, axis=1)
    flat_d = np.concatenate(dists, axis=1)
    flat_d = np.where(flat_i >= 0, flat_d, np.inf)
    order = np.argsort(flat_d, axis=1, kind="stable")[:, :k]
    return SearchResult(
        ids=np.take_along_axis(flat_i, order, axis=1),
        dists=np.take_along_axis(flat_d, order, axis=1))


def shard_of_seq(seq, n_shards: int):
    """Hash-partitioned routing: allocation sequence number -> shard.

    Fibonacci (multiplicative) hashing of the global allocation counter:
    deterministic, balanced for any arrival pattern and independent of
    the vectors.  `seq` may be an int or an int array; one shard always
    routes to 0.
    """
    if n_shards == 1:
        return np.zeros_like(np.asarray(seq)) if np.ndim(seq) else 0
    x = np.asarray(seq, np.uint64) * np.uint64(0x9E3779B97F4A7C15)
    return ((x >> np.uint64(33)) % np.uint64(n_shards)).astype(np.int64)
