"""LSMVecIndex on PyTorch — the counterpart of `repro.core.index`.

Wraps the functional core (hnsw/lsm/traversal/simhash) behind the
interface a vector database exposes: build, insert, delete, search,
maintenance (consolidation, compaction, reordering, tiering), plus the
I/O statistics the paper reports, and the ground-truth helpers
`brute_force_knn` / `recall_at_k`.

The index lives on one device, CUDA unless the caller passes
``device="cpu"``.  Its randomness (SimHash projections, level draws)
comes from a CPU `torch.Generator` seeded at construction, so one seed
gives the same index on either device.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from repro_torch._device import resolve
from repro_torch.core import hnsw, lsm, reorder
from repro_torch.core.backend import (
    MaintenanceReport,
    SearchParams,
    SearchResult,
    UpdateResult,
)
from repro_torch.core.iostats import IOStats
from repro_torch.core.traversal import stable_topk_asc
from repro_torch.kernels.l2_distance.ops import l2_distance
from repro_torch.tier import policy as tier_policy


def brute_force_knn(vectors, queries, k: int, live=None, block: int = 1024,
                    device=None) -> np.ndarray:
    """Exact ground-truth ids [Q, k] (for Recall K@K evaluation), through
    the `l2_distance` kernel; ties go to the lower id."""
    dev = resolve(device)
    v = torch.as_tensor(vectors, dtype=torch.float32, device=dev).contiguous()
    q = torch.as_tensor(queries, dtype=torch.float32, device=dev).contiguous()
    if live is not None:
        live = torch.as_tensor(live, dtype=torch.bool, device=dev)
    outs = []
    for s in range(0, q.shape[0], block):
        d = l2_distance(q[s:s + block], v)
        if live is not None:
            d = torch.where(live[None, :], d, torch.inf)
        outs.append(stable_topk_asc(d, k)[1].cpu().numpy())
    return np.concatenate(outs, axis=0)


def recall_at_k(found_ids: np.ndarray, true_ids: np.ndarray,
                block: int = 4096) -> float:
    """Recall K@K (Eq. 3): |found ∩ truth| / K averaged over queries.
    Truth ids are distinct and -1 pads in `found` never match."""
    f = np.asarray(found_ids)
    t = np.asarray(true_ids)
    k = t.shape[1]
    f = f[:, :k]
    hits = 0
    for s in range(0, len(t), block):
        fb, tb = f[s:s + block], t[s:s + block]
        hits += int((fb[:, :, None] == tb[:, None, :]).any(axis=1).sum())
    return hits / (k * len(t))


class DispatchedSearch:
    """A finished search's device tensors; `collect()` copies them to the
    host and slices the padded batch to [nq, k].  (The beam loop reads
    one flag per trip on the host, so the search itself is not yet
    asynchronous.)"""

    __slots__ = ("_ids", "_dists", "_nq", "_k")

    def __init__(self, ids, dists, nq: int, k: int):
        self._ids, self._dists = ids, dists
        self._nq, self._k = nq, k

    def collect(self) -> SearchResult:
        # sync-ok: collect() is the declared result sync point
        ids = np.asarray(self._ids.cpu())
        # sync-ok: collect() is the declared result sync point
        dists = np.asarray(self._dists.cpu())
        return SearchResult(ids=ids[:self._nq, :self._k],
                            dists=dists[:self._nq, :self._k])


class LSMVecIndex:
    """Dynamic disk-based vector index (LSM-VEC) on one device."""

    #: below this many live nodes, insert_batch falls back to per-item
    #: inserts: the batched pipeline searches the pre-batch graph snapshot,
    #: which must exist for the new nodes to link into
    BATCH_MIN_GRAPH = 64

    def __init__(self, cfg: hnsw.HNSWConfig, seed: int = 0,
                 state: Optional[hnsw.HNSWState] = None, device=None):
        self.cfg = cfg
        self.device = resolve(device)
        if state is None:
            proj = torch.randn((cfg.m_bits, cfg.dim),
                               generator=torch.Generator().manual_seed(seed))
            state = hnsw.init(cfg, proj, self.device)
        self._rng = torch.Generator().manual_seed(seed + 1)
        self.state = state
        self.io_stats = IOStats.zero(self.device)
        # host mirror of state.count: id allocation never syncs
        self._count = int(state.count)
        # write-epoch counter + cached dense read snapshot: every graph
        # write bumps _version; a snapshot read re-resolves on mismatch
        self._version = 0
        self._snap = None
        self._snap_version = -1

    def _uniforms(self, n: int) -> torch.Tensor:
        """Level uniforms in [1e-7, 1), drawn on the host generator."""
        u = torch.rand((n,), generator=self._rng)
        return (1e-7 + (1.0 - 1e-7) * u).to(self.device)

    # -- construction ---------------------------------------------------------

    @classmethod
    def build(cls, cfg: hnsw.HNSWConfig, vectors, seed: int = 0,
              device=None) -> "LSMVecIndex":
        """Bulk-build an index over `vectors` [n, dim]."""
        dev = resolve(device)
        rng = torch.Generator().manual_seed(seed)
        proj = torch.randn((cfg.m_bits, cfg.dim), generator=rng)
        u01 = 1e-7 + (1.0 - 1e-7) * torch.rand((len(vectors),), generator=rng)
        state = hnsw.bulk_build(cfg, vectors, proj.to(dev), u01, device=dev)
        return cls(cfg, seed=seed, state=state, device=dev)

    # -- updates --------------------------------------------------------------

    def insert(self, x) -> int:
        """Insert one vector; returns its id."""
        new_id = self._count
        self.state, st = hnsw.insert(self.cfg, self.state,
                                     torch.as_tensor(x, dtype=torch.float32),
                                     self._uniforms(1)[0])
        self._count += 1
        self._version += 1
        self.io_stats = self.io_stats + st
        return new_id

    def insert_batch(self, xs, *, pad_to: Optional[int] = None
                     ) -> UpdateResult:
        """Insert a batch; returns the new ids as an `UpdateResult`.

        While the graph holds fewer than BATCH_MIN_GRAPH live nodes the
        leading items go in one by one, so the batched pipeline always
        has a graph to search.  `pad_to` pads each chunk to a fixed width
        with masked tail items.
        """
        xs = np.asarray(xs, np.float32)
        if xs.size == 0:
            return UpdateResult(ids=np.zeros((0,), np.int64), n_applied=0)
        xs = np.atleast_2d(xs)
        n_seed = max(0, min(len(xs), self.BATCH_MIN_GRAPH - self.size))
        ids = [self.insert(x) for x in xs[:n_seed]]
        rest = xs[n_seed:]
        width = pad_to if pad_to else len(rest)
        for s in range(0, len(rest), width):
            chunk = rest[s:s + width]
            n = len(chunk)
            padded = np.zeros((width, rest.shape[1]), np.float32)
            padded[:n] = chunk
            valid = torch.arange(width) < n
            ids.extend(range(self._count, self._count + n))
            self.state, st = hnsw.insert_batch(
                self.cfg, self.state, torch.from_numpy(padded).to(self.device),
                self._uniforms(width), valid=valid.to(self.device))
            self._count += n
            self._version += 1
            self.io_stats = self.io_stats + st
        return UpdateResult(ids=np.asarray(ids, np.int64),
                            n_applied=len(ids))

    def delete(self, node_id: int) -> None:
        """Delete one id.  Lazy (the default) sets the tombstone bit only,
        so the cached read snapshot stays valid; eager relinks the
        neighbors (Algorithm 2), a graph write."""
        self.state, st = hnsw.delete(self.cfg, self.state, node_id)
        if not self.cfg.lazy_delete:
            self._version += 1
        self.io_stats = self.io_stats + st

    def delete_batch(self, ids, *, pad_to: Optional[int] = None
                     ) -> UpdateResult:
        """Delete a batch of ids: lazy tombstones (no graph write, so the
        cached read snapshot stays valid) or, under `lazy_delete=False`,
        the eager Algorithm-2 relink.  `pad_to` pads with -1, a masked
        no-op."""
        ids = np.atleast_1d(np.asarray(ids, np.int32))
        if len(ids) == 0:
            return UpdateResult(ids=np.zeros((0,), np.int64), n_applied=0)
        width = pad_to or len(ids)
        for s in range(0, len(ids), width):
            chunk = ids[s:s + width]
            padded = np.full((width,), -1, np.int32)
            padded[:len(chunk)] = chunk
            self.state, st = hnsw.delete_batch(
                self.cfg, self.state, torch.from_numpy(padded).to(self.device))
            if not self.cfg.lazy_delete:
                self._version += 1
            self.io_stats = self.io_stats + st
        return UpdateResult(ids=ids.astype(np.int64),
                            n_applied=int((ids >= 0).sum()))

    # -- search ---------------------------------------------------------------

    def dispatch_search(self, queries, k: Optional[int] = None, *,
                        params: Optional[SearchParams] = None
                        ) -> DispatchedSearch:
        """Run a batched ANN search and return a `DispatchedSearch`
        whose `collect()` brings back the `SearchResult` (ids [B, k],
        dists [B, k]).  All knobs ride in `params`; `None` fields resolve
        from the config here.

        `params.use_snapshot` (or `pad_to`) serves bottom-layer adjacency
        from the cached dense LSM view instead of per-hop LSM probes —
        identical results; with `cfg.fused_beam` that route runs the
        whole bottom beam as one kernel launch.  `params.record_heat` adds
        the fetched edges to `state.heat` (False also drops the heat
        lanes from the fused route).
        """
        p = (params or SearchParams()).resolve(self.cfg)
        k = k or self.cfg.k
        qs_np = np.atleast_2d(np.asarray(queries, np.float32))
        nq = len(qs_np)
        kw = dict(rho=p.rho, use_filter=p.use_filter, ef=p.ef,
                  n_expand=p.n_expand)
        if p.use_snapshot or p.pad_to is not None:
            width = p.pad_to if p.pad_to else nq
            if nq > width:
                raise ValueError(f"batch {nq} exceeds pad width {width}")
            padded = np.zeros((width, qs_np.shape[1]), np.float32)
            padded[:nq] = qs_np
            res = hnsw.search_batch(
                self.cfg, self.state, torch.from_numpy(padded).to(self.device),
                snapshot=self.snapshot(),
                active=(torch.arange(width) < nq).to(self.device),
                record_heat=p.record_heat, **kw)
        else:
            res = hnsw.search_batch(
                self.cfg, self.state, torch.from_numpy(qs_np).to(self.device),
                **kw)
        if p.record_heat:
            nodes = res.heat_nodes.reshape(-1)
            mask = res.heat_mask.reshape(-1, self.cfg.M)
            contrib = (mask & (nodes >= 0)[:, None]).to(torch.int32)
            # integer adds: the order atomics apply them in cannot change
            # the sum
            self.state.heat.index_add_(0, nodes.clamp_min(0).long(), contrib)
        self.io_stats = self.io_stats + res.stats.total()
        return DispatchedSearch(res.ids, res.dists, nq, k)

    def search(self, queries, k: Optional[int] = None, *,
               params: Optional[SearchParams] = None) -> SearchResult:
        """Batched ANN search: dispatch + collect in one call."""
        return self.dispatch_search(queries, k, params=params).collect()

    # -- maintenance ----------------------------------------------------------

    def maintain(self, op: str, **params) -> MaintenanceReport:
        """Maintenance entry point.  ops: "consolidate" (`ratio=`: skip
        below that tombstone share), "compact" (major LSM compaction),
        "reorder" (`window=`, `lam=`: connectivity-aware relayout, §3.4)
        and "tier" (`policy=`: a `TierPolicy`)."""
        if op == "consolidate":
            n = self.consolidate(ratio=params.get("ratio"))
            return MaintenanceReport(op=op, applied=n > 0, reclaimed=n)
        if op == "compact":
            self.compact()
            return MaintenanceReport(op=op, applied=True)
        if op == "reorder":
            perm, secs = self._reorder(window=int(params.get("window", 8)),
                                       lam=float(params.get("lam", 1.0)))
            return MaintenanceReport(op=op, applied=True, perm=perm,
                                     detail={"gorder_seconds": secs})
        if op == "tier":
            moved = self.tier_maintain(params["policy"])
            return MaintenanceReport(
                op=op, applied=(moved["demoted"] + moved["promoted"]) > 0,
                demoted=moved["demoted"], promoted=moved["promoted"])
        raise ValueError(f"unknown maintenance op {op!r}")

    def compact(self) -> None:
        """Major LSM compaction: every run merged into the last level."""
        self.state = self.state._replace(
            store=lsm.compact_all(self.cfg.lsm_cfg, self.state.store))
        self._version += 1

    def reorder(self, *, window: int = 8, lam: float = 1.0) -> np.ndarray:
        """Connectivity-aware relayout (§3.4), applied at a major
        compaction: the gorder placement of the allocated ids on the host
        from the bottom-layer rows and the recorded edge heat, then every
        lane renumbered on the device.  Returns perm (perm[old] = new);
        internal ids change, so callers map ids they hold through it."""
        return self._reorder(window=window, lam=lam)[0]

    def _reorder(self, *, window: int, lam: float):
        """`reorder`, returning (perm, seconds of the host placement)."""
        n = self._count
        live, rows = lsm.resolve_all(self.cfg.lsm_cfg, self.state.store, n)
        live_np = (live.cpu().numpy() > 0) \
            & (self.state.levels[:n].cpu().numpy() >= 0)
        t0 = time.perf_counter()
        perm = reorder.gorder_permutation(
            rows.cpu().numpy(), self.state.heat[:n].cpu().numpy(),
            window=window, lam=lam, live=live_np)
        secs = time.perf_counter() - t0
        self.state = reorder.apply_permutation(self.cfg, self.state, perm)
        self._version += 1
        return perm, secs

    def tier_maintain(self, policy: "tier_policy.TierPolicy") -> dict:
        """One batched demote/promote pass of the tier policy.  Returns
        {"demoted": n, "promoted": n}; no moves when the hot fraction
        already sits inside the hysteresis band.  The graph is not
        written, so the cached read snapshot stays valid."""
        self.state, st, moved = tier_policy.tier_maintain(
            self.cfg, self.state, policy)
        self.io_stats = self.io_stats + st
        return {k: int(v) for k, v in moved.items()}

    def consolidate(self, *, ratio: Optional[float] = None) -> int:
        """Splice tombstoned nodes out of the graph and reclaim their
        slots; returns the number reclaimed.  Ids are never reused."""
        n = self.n_tombstones
        if n == 0:
            return 0
        if ratio is not None and n / max(self.size + n, 1) < ratio:
            return 0
        self.state, st = hnsw.consolidate(self.cfg, self.state)
        self.io_stats = self.io_stats + st
        self._version += 1
        return n

    def snapshot(self) -> torch.Tensor:
        """Dense bottom-layer adjacency view int32[cap, M], cached and
        re-resolved from the LSM tree after any graph write."""
        if self._snap is None or self._snap_version != self._version:
            self._snap = lsm.snapshot_rows(self.cfg.lsm_cfg, self.state.store,
                                           self.cfg.cap)
            self._snap_version = self._version
        return self._snap

    def sync(self) -> None:
        """Block until the device has finished the work enqueued so far."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @property
    def cap(self) -> int:
        """Total internal id space."""
        return self.cfg.cap

    @property
    def lazy_delete(self) -> bool:
        return self.cfg.lazy_delete

    @property
    def size(self) -> int:
        """Live (returnable) nodes; one scalar read."""
        return int(self.state.n_live)  # sync-ok: declared accessor

    @property
    def n_tombstones(self) -> int:
        """Nodes lazily deleted but not yet consolidated; one scalar read."""
        return int(self.state.n_tombstones)  # sync-ok: declared accessor
