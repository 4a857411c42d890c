"""Typed results and search knobs of the port (copied from
`repro.core.backend`, numpy only).

`search` returns a `SearchResult`; `insert_batch`/`delete_batch` return
an `UpdateResult`; `SearchParams` is the one place search defaults are
resolved from a config; `maintain` returns a `MaintenanceReport`.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional

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
