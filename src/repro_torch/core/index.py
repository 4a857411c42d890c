"""LSMVecIndex on PyTorch — the counterpart of `repro.core.index`.

Wraps the functional core (hnsw/lsm/traversal/simhash) behind the
interface a vector database exposes, the whole `VectorBackend` protocol
(`core/backend.py`): build, insert, delete, search, maintenance
(consolidation, compaction, reordering, tiering) and a consolidation
overlapped with serving, stats and memory accounting, checkpoints, plus
the I/O statistics the paper reports, and the ground-truth helpers
`brute_force_knn` / `recall_at_k`.

The index lives on one device, CUDA unless the caller passes
``device="cpu"``.  Its randomness (SimHash projections, level draws)
comes from a CPU `torch.Generator` seeded at construction, so one seed
gives the same index on either device.
"""

from __future__ import annotations

import threading
import time
from contextlib import nullcontext
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch._device import resolve, upload
from repro_torch.checkpoint import ckpt
from repro_torch.core import hnsw, iostats, lsm, reorder
from repro_torch.core.backend import (
    BackendStats,
    MaintenanceReport,
    MemoryBreakdown,
    SearchParams,
    SearchResult,
    ShardStats,
    UpdateResult,
)
from repro_torch.core.iostats import CostModel, IOStats
from repro_torch.core.sentinel import declared_sync
from repro_torch.core.traversal import stable_topk_asc
from repro_torch.kernels import _build
from repro_torch.kernels.l2_distance.ops import l2_distance
from repro_torch.tier import policy as tier_policy

#: the entry points `trace_counts` reports, the reference's jitted ones
TRACED = ("insert", "insert_batch", "insert_batch_snapshot", "delete",
          "delete_batch", "search", "search_snapshot", "consolidate_bg")


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


def build_draws(cfg: hnsw.HNSWConfig, n: int, seed: int):
    """The randomness of a bulk build of `n` rows: SimHash projections
    f32[m_bits, dim] and level uniforms in [1e-7, 1), in that order from
    one CPU generator seeded with `seed`."""
    rng = torch.Generator().manual_seed(seed)
    proj = torch.randn((cfg.m_bits, cfg.dim), generator=rng)
    u01 = 1e-7 + (1.0 - 1e-7) * torch.rand((n,), generator=rng)
    return proj, u01


def patch_snapshot(snap: torch.Tensor, overlay_rows: torch.Tensor,
                   overlay_valid: torch.Tensor) -> torch.Tensor:
    """The dense snapshot int32[cap, M] after an `insert_batch`: its
    staged rows (`hnsw.insert_batch(return_overlay=True)`) over the
    pre-batch rows."""
    cap = snap.shape[0]
    return torch.where(overlay_valid[:cap, None], overlay_rows[:cap], snap)


def clone_state(state: hnsw.HNSWState) -> hnsw.HNSWState:
    """A deep copy of an index state, every tensor cloned."""
    return lsm.hydrate(state, {k: t.clone()
                               for k, t in lsm.dehydrate(state).items()})


class DispatchedSearch:
    """A search's device tensors; `collect()` copies them to the host and
    slices the padded batch to [nq, k].  (The beam loop reads one flag
    per trip on the host, so the search is mostly done by the time this
    exists; `is_ready` polls the event recorded after its last kernel.)"""

    __slots__ = ("_ids", "_dists", "_nq", "_k", "_done")

    def __init__(self, ids, dists, nq: int, k: int, done=None):
        self._ids, self._dists = ids, dists
        self._nq, self._k = nq, k
        self._done = done

    def is_ready(self) -> bool:
        """Non-blocking: True once the search's device work has finished
        (always on the CPU, where it ran to its end)."""
        return self._done is None or self._done.query()

    def collect(self) -> SearchResult:
        with declared_sync("search result materialization"):
            # sync-ok: search result materialization, collect()'s read
            ids = np.asarray(self._ids.cpu())
            # sync-ok: search result materialization, collect()'s read
            dists = np.asarray(self._dists.cpu())
        return SearchResult(ids=ids[:self._nq, :self._k],
                            dists=dists[:self._nq, :self._k])


class _Repair:
    """One consolidation beside serving, on a copy of the live state.

    On the CPU the repair runs at once.  On the card the copy is made on
    the serving stream, and a worker thread runs `hnsw.consolidate` on it
    on a second stream that waits for the copy; the thread does the
    repair's own host reads, so the caller goes on serving.  `finish`
    waits for the thread, makes the serving stream wait for the second
    one, and marks the repaired tensors as used by the serving stream so
    that the caching allocator does not hand their memory out early.
    """

    def __init__(self, cfg: hnsw.HNSWConfig, state: hnsw.HNSWState,
                 n: int, variants: set):
        self.n = n
        self.src = clone_state(state)
        self.out = self.error = self.thread = None
        if state.vectors.device.type != "cuda":
            with _build.variants(variants), \
                    declared_sync("repair worker reads"):
                self.out = hnsw.consolidate(cfg, self.src)
            return
        dev = state.vectors.device
        self.serving = torch.cuda.current_stream(dev)
        self.side = torch.cuda.Stream(dev)
        self.side.wait_stream(self.serving)
        self.done = torch.cuda.Event()
        self.thread = threading.Thread(
            target=self._run, args=(cfg, dev, variants), daemon=True,
            name="lsmvec-consolidate")
        self.thread.start()

    def _run(self, cfg, dev, variants) -> None:
        try:
            with torch.cuda.device(dev), torch.cuda.stream(self.side), \
                    _build.variants(variants), \
                    declared_sync("repair worker reads"):
                self.out = hnsw.consolidate(cfg, self.src)
                self.done.record(self.side)
        except BaseException as e:      # re-raised by finish()
            self.error = e

    def ready(self) -> bool:
        """True once the repair's host and device work are done."""
        if self.thread is None:
            return True
        return not self.thread.is_alive() and (
            self.error is not None or self.done.query())

    def finish(self) -> Tuple[hnsw.HNSWState, IOStats]:
        if self.thread is not None:
            self.thread.join()
            if self.error is not None:
                raise self.error
            self.serving.wait_event(self.done)
            state, st = self.out
            # sync-ok: walks the state's tensors, reads none of their values
            for t in list(lsm.dehydrate(state).values()) + list(st):
                t.record_stream(self.serving)
        self.src = None
        return self.out


class LSMVecIndex:
    """Dynamic disk-based vector index (LSM-VEC) on one device: the
    port's `VectorBackend` implementation."""

    #: below this many live nodes, insert_batch falls back to per-item
    #: inserts: the batched pipeline searches the pre-batch graph snapshot,
    #: which must exist for the new nodes to link into
    BATCH_MIN_GRAPH = 64

    def __init__(self, cfg: hnsw.HNSWConfig, seed: int = 0,
                 state: Optional[hnsw.HNSWState] = None, device=None):
        self.cfg = cfg
        self.device = resolve(device)
        self._seed = seed
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
        #: insert_batch chunks patched into the snapshot (vs re-resolves)
        self.snap_patches = 0
        # overlapped consolidation: the repair in flight, and the report
        # of the last one a write barrier finished, awaiting its claim
        self._pending_repair: Optional[_Repair] = None
        self._done_report: Optional[MaintenanceReport] = None
        # (kernel, shape class) pairs each entry point has launched
        self._variants = {name: set() for name in TRACED}

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
        proj, u01 = build_draws(cfg, len(vectors), seed)
        state = hnsw.bulk_build(cfg, vectors, proj.to(dev), u01, device=dev)
        return cls(cfg, seed=seed, state=state, device=dev)

    # -- updates --------------------------------------------------------------

    def _barrier_repair(self) -> None:
        """Write barrier: finish an overlapped repair in flight first.

        Every mutation calls this first, so a consolidation's cutover
        always lands on a write-batch boundary.  The finished report is
        kept for the next `poll_maintain` to claim."""
        if self._pending_repair is not None:
            self._finish_repair()

    def _finish_repair(self) -> None:
        """Cut over to the repaired state.  Edge heat recorded by searches
        served during the repair is dropped with the old state, as in the
        reference: consolidation zeroes heat on every changed row anyway,
        and heat only advises the tier and reorder passes."""
        repair, self._pending_repair = self._pending_repair, None
        self.state, st = repair.finish()
        self.io_stats = self.io_stats + st
        self._version += 1
        self._done_report = MaintenanceReport(
            op="consolidate", applied=True, reclaimed=repair.n,
            detail={"overlapped": True})

    def insert(self, x) -> int:
        """Insert one vector; returns its id."""
        self._barrier_repair()
        new_id = self._count
        with _build.variants(self._variants["insert"]), \
                declared_sync("insert_batch host loop"):
            self.state, st = hnsw.insert(
                self.cfg, self.state, torch.as_tensor(x, dtype=torch.float32),
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

        When the cached read snapshot is fresh, each chunk's staged rows
        (the overlay) are patched into it instead of invalidating it, so
        the next snapshot search skips the whole-table re-resolve
        (counted in `snap_patches`).
        """
        self._barrier_repair()
        xs = np.asarray(xs, np.float32)
        if xs.size == 0:
            return UpdateResult(ids=np.zeros((0,), np.int64), n_applied=0)
        xs = np.atleast_2d(xs)
        n_seed = max(0, min(len(xs), self.BATCH_MIN_GRAPH - self.size))
        ids = [self.insert(x) for x in xs[:n_seed]]
        rest = xs[n_seed:]
        patch = self._snap is not None and self._snap_version == self._version
        width = pad_to if pad_to else len(rest)
        name = "insert_batch_snapshot" if patch else "insert_batch"
        for s in range(0, len(rest), width):
            chunk = rest[s:s + width]
            n = len(chunk)
            padded = np.zeros((width, rest.shape[1]), np.float32)
            padded[:n] = chunk
            valid = torch.arange(width) < n
            ids.extend(range(self._count, self._count + n))
            with _build.variants(self._variants[name]), \
                    declared_sync("insert_batch host loop"):
                out = hnsw.insert_batch(
                    self.cfg, self.state,
                    torch.from_numpy(padded).to(self.device),
                    self._uniforms(width), valid=valid.to(self.device),
                    return_overlay=patch)
                self.state, st = out[:2]
                if patch:
                    self._snap = patch_snapshot(self._snap, *out[2])
                    self.snap_patches += 1
            self._count += n
            self._version += 1
            if patch:
                self._snap_version = self._version
            self.io_stats = self.io_stats + st
        return UpdateResult(ids=np.asarray(ids, np.int64),
                            n_applied=len(ids))

    def _eager_scope(self):
        """The eager relink reads the host item by item; a lazy delete
        only sets tombstone bits on the device and reads nothing."""
        return nullcontext() if self.cfg.lazy_delete \
            else declared_sync("eager delete host loop")

    def delete(self, node_id: int) -> None:
        """Delete one id.  Lazy (the default) sets the tombstone bit only,
        so the cached read snapshot stays valid; eager relinks the
        neighbors (Algorithm 2), a graph write."""
        self._barrier_repair()
        with _build.variants(self._variants["delete"]), self._eager_scope():
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
        self._barrier_repair()
        ids = np.atleast_1d(np.asarray(ids, np.int32))
        if len(ids) == 0:
            return UpdateResult(ids=np.zeros((0,), np.int64), n_applied=0)
        width = pad_to or len(ids)
        for s in range(0, len(ids), width):
            chunk = ids[s:s + width]
            padded = np.full((width,), -1, np.int32)
            padded[:len(chunk)] = chunk
            with _build.variants(self._variants["delete_batch"]), \
                    self._eager_scope():
                self.state, st = hnsw.delete_batch(
                    self.cfg, self.state, upload(padded, self.device))
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
            with _build.variants(self._variants["search_snapshot"]):
                res = hnsw.search_batch(
                    self.cfg, self.state, upload(padded, self.device),
                    snapshot=self.snapshot(),
                    active=upload(torch.arange(width) < nq, self.device),
                    record_heat=p.record_heat, **kw)
        else:
            with _build.variants(self._variants["search"]):
                res = hnsw.search_batch(
                    self.cfg, self.state, upload(qs_np, self.device), **kw)
        if p.record_heat:
            nodes = res.heat_nodes.reshape(-1)
            mask = res.heat_mask.reshape(-1, self.cfg.M)
            contrib = (mask & (nodes >= 0)[:, None]).to(torch.int32)
            # integer adds: the order atomics apply them in cannot change
            # the sum
            self.state.heat.index_add_(0, nodes.clamp_min(0).long(), contrib)
        self.io_stats = self.io_stats + res.stats.total()
        done = None
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        return DispatchedSearch(res.ids, res.dists, nq, k, done)

    def search(self, queries, k: Optional[int] = None, *,
               params: Optional[SearchParams] = None) -> SearchResult:
        """Batched ANN search: dispatch + collect in one call."""
        return self.dispatch_search(queries, k, params=params).collect()

    # -- maintenance ----------------------------------------------------------

    def maintain(self, op: str, **params) -> MaintenanceReport:
        """Maintenance entry point.  ops: "consolidate" (`ratio=`: skip
        below that tombstone share; a repair in flight or finished by a
        write barrier is this consolidation, and is claimed instead),
        "compact" (major LSM compaction), "reorder" (`window=`, `lam=`:
        connectivity-aware relayout, §3.4) and "tier" (`policy=`: a
        `TierPolicy`)."""
        if op == "consolidate":
            rep = self.poll_maintain(block=True)
            if rep is not None and rep.applied:
                return rep
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

    def begin_maintain(self, op: str, **params) -> bool:
        """Start a consolidation overlapped with serving.

        The repair runs on a copy of the live state (`_Repair`: on the
        card, a second stream driven by a worker thread; on the CPU at
        once), so searches keep running on `self.state` meanwhile.
        Returns True iff a repair was started (False: another op, one
        already in flight, or the tombstone-ratio trigger declined).  The
        cutover happens in `poll_maintain`, or earlier, at the next
        mutation's write barrier.
        """
        if op != "consolidate" or self._pending_repair is not None:
            return False
        with declared_sync("maintenance cadence scalar"):
            # sync-ok: maintenance cadence scalar, one read up front
            n = int(self.state.n_tombstones)
        if n == 0:
            return False
        ratio = params.get("ratio")
        if ratio is not None and n / max(self.size + n, 1) < ratio:
            return False
        self._pending_repair = _Repair(self.cfg, self.state, n,
                                       self._variants["consolidate_bg"])
        return True

    def poll_maintain(self, *, block: bool = False
                      ) -> Optional[MaintenanceReport]:
        """Cut over to a finished repair and return its report.

        Non-blocking by default: None while the repair is still running.
        Also returns (and clears) the report of a repair that a write
        barrier already finished; None when there is nothing to claim.
        `block=True` waits for the repair in flight.
        """
        repair = self._pending_repair
        if repair is not None:
            # sync-ok: ready() polls the worker thread and a CUDA event
            if not (block or repair.ready()):
                return None
            self._finish_repair()
        rep, self._done_report = self._done_report, None
        return rep

    @property
    def maintenance_pending(self) -> bool:
        """A repair is in flight or a finished report awaits its claim."""
        return (self._pending_repair is not None
                or self._done_report is not None)

    def compact(self) -> None:
        """Major LSM compaction: every run merged into the last level."""
        self._barrier_repair()
        with declared_sync("LSM compaction host reads"):
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
        self._barrier_repair()
        n = self._count
        live, rows = lsm.resolve_all(self.cfg.lsm_cfg, self.state.store, n)
        with declared_sync("reorder host relayout"):
            live_np = (live.cpu().numpy() > 0) \
                & (self.state.levels[:n].cpu().numpy() >= 0)
            t0 = time.perf_counter()
            perm = reorder.gorder_permutation(
                rows.cpu().numpy(), self.state.heat[:n].cpu().numpy(),
                window=window, lam=lam, live=live_np)
            secs = time.perf_counter() - t0
            self.state = reorder.apply_permutation(self.cfg, self.state,
                                                   perm)
        self._version += 1
        return perm, secs

    def tier_maintain(self, policy: "tier_policy.TierPolicy") -> dict:
        """One batched demote/promote pass of the tier policy.  Returns
        {"demoted": n, "promoted": n}; no moves when the hot fraction
        already sits inside the hysteresis band.  The graph is not
        written, so the cached read snapshot stays valid."""
        self._barrier_repair()
        with declared_sync("tier pass counts"):
            self.state, st, moved = tier_policy.tier_maintain(
                self.cfg, self.state, policy)
            moved = {k: int(v) for k, v in moved.items()}
        self.io_stats = self.io_stats + st
        return moved

    def consolidate(self, *, ratio: Optional[float] = None) -> int:
        """Splice tombstoned nodes out of the graph and reclaim their
        slots; returns the number reclaimed.  Ids are never reused."""
        self._barrier_repair()
        with declared_sync("maintenance cadence scalar"):
            # sync-ok: maintenance cadence scalar, one read up front
            n = int(self.state.n_tombstones)
        if n == 0:
            return 0
        if ratio is not None and n / max(self.size + n, 1) < ratio:
            return 0
        with declared_sync("consolidation host reads"):
            self.state, st = hnsw.consolidate(self.cfg, self.state)
        self.io_stats = self.io_stats + st
        self._version += 1
        return n

    def snapshot(self) -> torch.Tensor:
        """Dense bottom-layer adjacency view int32[cap, M], cached:
        re-resolved from the LSM tree after any other graph write, and
        patched in place of that after an `insert_batch`."""
        if self._snap is None or self._snap_version != self._version:
            self._snap = lsm.snapshot_rows(self.cfg.lsm_cfg, self.state.store,
                                           self.cfg.cap)
            self._snap_version = self._version
        return self._snap

    def sync(self) -> None:
        """Block until the device has finished the work enqueued so far."""
        with declared_sync("explicit barrier"):
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)

    # -- backend protocol surface ---------------------------------------------

    @property
    def cap(self) -> int:
        """Total internal id space."""
        return self.cfg.cap

    @property
    def lazy_delete(self) -> bool:
        return self.cfg.lazy_delete

    @property
    def snapshot_stale(self) -> bool:
        """True when the next snapshot read will re-resolve the tree."""
        return self._snap is None or self._snap_version != self._version

    def stats(self) -> BackendStats:
        """The backend stats surface, in one host read."""
        st = self.state
        counts = torch.stack(
            [st.n_live.long(), st.n_tombstones.long(),
             st.n_delete_noops.long()]
            + [c.long() for c in hnsw.memory_counts(st)])
        with declared_sync("stats surface fetch"):
            live, nt, noops, *mem_counts = counts.tolist()
        mem = hnsw.memory_breakdown(self.cfg, st, mem_counts)
        shard = ShardStats(size=live, n_tombstones=nt, delete_noops=noops,
                           n_hot=mem.n_hot, n_cold=mem.n_cold)
        return BackendStats(size=live, n_tombstones=nt, delete_noops=noops,
                            max_tombstone_ratio=shard.tombstone_ratio,
                            shards=(shard,), memory=mem)

    def heat_total(self) -> int:
        """Accumulated edge-heat counts (one scalar read)."""
        with declared_sync("heat trigger scalar"):
            # sync-ok: heat trigger scalar, read at the heat cadence
            return int(self.state.heat.sum())

    def initial_ids(self) -> np.ndarray:
        """Internal ids in allocation order, for seeding an external-id
        map: the j-th vector ever allocated holds internal id j."""
        return np.arange(self._count, dtype=np.int64)

    def clone(self) -> "LSMVecIndex":
        """Deep-copy the state into a fresh index on the same device.  The
        insert generator's stream carries over, so a clone inserts with
        the randomness the original would have."""
        self._barrier_repair()
        other = LSMVecIndex(self.cfg, seed=self._seed,
                            state=clone_state(self.state), device=self.device)
        other._rng.set_state(self._rng.get_state())
        return other

    # -- durability -----------------------------------------------------------

    def save(self, ckpt_dir: str, *, lsn: int = 0,
             extra: Optional[dict] = None, meta: Optional[dict] = None,
             keep: int = 3, _pre_publish=None) -> str:
        """Atomic full-state checkpoint; returns its directory.

        Everything a bit-exact resume needs: the whole `HNSWState`
        (vectors, codes, upper layers, LSM store, tombstone lane, heat,
        tier lanes), the insert generator's state (so later inserts draw
        the same levels), and the caller's `extra` arrays.  `lsn` is the
        log position the checkpoint covers and its step number.
        """
        self._barrier_repair()
        self.sync()
        tree = lsm.dehydrate(self.state, "state")
        tree["rng"] = self._rng.get_state()
        for k, v in (extra or {}).items():
            tree[f"extra/{k}"] = np.asarray(v)
        metadata = {"lsn": int(lsn), "count": self._count,
                    "version": self._version, "seed": self._seed,
                    "cap": self.cfg.cap, "dim": self.cfg.dim,
                    **(meta or {})}
        with declared_sync("checkpoint state fetch"):
            return ckpt.save_checkpoint(ckpt_dir, step=int(lsn), tree=tree,
                                        metadata=metadata, keep=keep,
                                        _pre_publish=_pre_publish)

    @classmethod
    def restore(cls, cfg: hnsw.HNSWConfig, ckpt_dir: str, *,
                step: Optional[int] = None, device=None
                ) -> Tuple["LSMVecIndex", dict, dict]:
        """Rebuild an index from its latest (or `step`-th) checkpoint, on
        the card unless `device` says otherwise.

        Structure comes from `cfg`, values from the checkpoint; every
        leaf the config requires must be there with its exact shape, or
        the restore refuses: a checkpoint of another cap/dim/M never
        loads silently.  Returns (index, metadata, extras), extras being
        the arrays passed to `save(extra=...)`, keys unprefixed.  A
        checkpoint of the reference's index restores too (same layout,
        SimHash words widened to int64); only its insert generator
        differs, seeded from the reference's key.
        """
        dev = resolve(device)
        arrays, metadata, _ = ckpt.load_arrays(ckpt_dir, step)
        if (int(metadata["cap"]) != cfg.cap
                or int(metadata["dim"]) != cfg.dim):
            raise ValueError(
                f"checkpoint cap/dim ({metadata['cap']}/{metadata['dim']}) "
                f"!= config ({cfg.cap}/{cfg.dim})")
        seed = int(metadata.get("seed", 0))
        # shapes and dtypes only: nothing is allocated on the meta device
        template = hnsw.init(cfg, torch.zeros((cfg.m_bits, cfg.dim)), "meta")
        leaves = {}
        for k, tmpl in lsm.dehydrate(template, "state").items():
            if k not in arrays:
                raise KeyError(f"checkpoint missing state leaf {k!r}")
            arr = arrays[k]
            if tuple(arr.shape) != tuple(tmpl.shape):
                raise ValueError(
                    f"{k}: checkpoint shape {tuple(arr.shape)} != "
                    f"config-derived {tuple(tmpl.shape)}")
            leaves[k] = torch.from_numpy(np.array(arr)).to(dev, tmpl.dtype)
        state = lsm.hydrate(template, leaves, "state")
        idx = cls(cfg, seed=seed, state=state, device=dev)
        rng = np.array(arrays["rng"])
        if rng.dtype == np.uint8:
            idx._rng.set_state(torch.from_numpy(rng))
        else:
            # a reference checkpoint holds its key's words (uint32), whose
            # stream no torch generator replays: they seed this one
            idx._rng.manual_seed(int.from_bytes(
                rng.astype("<u4").tobytes(), "little") % 2 ** 64)
        idx._count = int(metadata["count"])
        idx._version = int(metadata["version"])
        extras = {k[len("extra/"):]: v for k, v in arrays.items()
                  if k.startswith("extra/")}
        return idx, metadata, extras

    # -- accounting -----------------------------------------------------------

    def reset_stats(self) -> None:
        self.io_stats = IOStats.zero(self.device)

    def reset_heat(self) -> None:
        """Zero the edge-heat accumulator (after a heat-driven relayout)."""
        self._barrier_repair()
        self.state = self.state._replace(heat=torch.zeros_like(self.state.heat))

    def trace_counts(self) -> dict:
        """Kernel variants per entry point, what stands in for a jit's
        traced variants: the distinct (kernel, shape class) pairs the
        entry point's calls have launched on the card (none on the CPU,
        which launches no kernel).  The classes are finite, so with fixed
        pad widths every count reaches a constant after warm-up."""
        return {name: len(v) for name, v in self._variants.items()}

    def io_cost(self, model: CostModel = iostats.DISK) -> float:
        return float(iostats.search_cost(self.io_stats, model))

    def memory_breakdown(self) -> MemoryBreakdown:
        """Per-component resident bytes (`hnsw.memory_breakdown`)."""
        return hnsw.memory_breakdown(self.cfg, self.state)

    def memory_bytes(self) -> int:
        with declared_sync("memory accounting scalar"):
            return int(self.memory_breakdown().total)

    @property
    def size(self) -> int:
        """Live (returnable) nodes; one scalar read."""
        with declared_sync("live-count scalar"):
            return int(self.state.n_live)  # sync-ok: live-count scalar

    @property
    def n_tombstones(self) -> int:
        """Nodes lazily deleted but not yet consolidated; one scalar read."""
        with declared_sync("tombstone-count scalar"):
            # sync-ok: tombstone-count scalar
            return int(self.state.n_tombstones)
