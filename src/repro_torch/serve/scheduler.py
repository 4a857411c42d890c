"""The continuous micro-batching engine over a `VectorBackend`
(DESIGN.md §8, §10).

`ServeEngine` accepts an interleaved stream of query/insert/delete
requests and executes it as fixed-shape micro-batches:

  queue → coalesce (per-op caps + adaptive windows) → pad-and-mask
        dispatch → snapshot-cached reads → threshold-driven maintenance

The engine programs against the `VectorBackend` protocol only (the
port's `LSMVecIndex` on one card).  Every op dispatches through one
padded shape (`pad_to` on the backend's batch entry points), so after
warm-up steady-state serving launches no new kernel variant
(`trace_counts` stays put) however ragged the arrival pattern is.  Query batches read bottom-layer adjacency from the
backend's cached dense snapshot, re-resolved lazily after each write
batch (lazy deletes are tombstone-bit-only and leave the snapshot
valid).  Maintenance (tombstone consolidation, LSM compaction,
heat-driven reordering) runs from thresholds between batches — sharded
backends apply them per shard.

**External ids** are owned here, uniformly for every backend: the engine
allocates them sequentially in insert order (build rows first), keeps an
external↔internal map over the backend's global id space, and folds
every reorder permutation into it.  Consolidation retires internal ids
without reuse, so the same map needs no rewrite (DESIGN.md §9).

**Adaptive coalescing windows** (Quake-style, DESIGN.md §10): instead of
static per-op windows, the engine keeps an EMA of each op's inter-
arrival gap and sizes the window to a fraction of the expected
batch-fill time — heavy arrival mixes shrink the wait toward zero
(batches fill anyway), sparse mixes stop burning latency waiting for
stragglers that aren't coming.  The chosen windows are visible in
`ServeMetrics`.

The engine is single-threaded at heart — `pump()` executes at most one
micro-batch and is the unit the tests drive deterministically (with an
injectable clock).  `start()`/`stop()` wrap it in a background thread
for live serving; `drain()` pumps until the queue is empty.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import latest_step
from repro_torch.core.backend import SearchParams
from repro_torch.serve.maintenance import MaintenanceManager, MaintenancePolicy
from repro_torch.serve.metrics import ServeMetrics
from repro_torch.serve.queue import CoalescingQueue
from repro_torch.serve.request import Op, QueryResult, Request, Ticket
from repro_torch.serve.wal import KIND_INSERT, NO_LSN, WalConfig, WalRecord, WriteAheadLog

#: The engine's locking contract, machine-checked by the
#: `lock-discipline` rule of `tools.repro_lint`: every listed attribute
#: may only be touched with its lock held (`__init__` and the
#: single-threaded `recover` path excepted).  `_lock` is the cheap
#: submit-side lock — `submit_*` never waits behind a device dispatch;
#: `_pump_lock` serializes batch execution, the id maps it mutates, and
#: the deferred-ack/checkpoint bookkeeping.
_GUARDED_BY = {
    "_lock": ("queue", "_seq", "_gap_ema", "_last_arrival"),
    "_pump_lock": (
        "_int2ext", "_ext2int", "_next_ext", "_deleted_ext",
        "_pending_acks", "_oldest_pending_t", "_covering_lsn",
        "_has_ckpt", "_ckpt_seq", "batch_log",
    ),
}
#: permitted nesting order, outermost first: a pump takes `_pump_lock`
#: then briefly `_lock` to pop the batch; taking them the other way
#: round is the ABBA deadlock the LK202 rule rejects
_LOCK_ORDER = ("_pump_lock", "_lock")


@dataclass
class ServeConfig:
    """Engine knobs. Batch caps are also the fixed pad widths."""

    query_batch: int = 32
    insert_batch: int = 32
    delete_batch: int = 32
    #: per-op coalescing windows (seconds).  With `adaptive_windows`
    #: these are only the starting values used until the arrival-rate
    #: EMA has a sample; without it they are the static windows.
    query_window: float = 0.002
    insert_window: float = 0.005
    delete_window: float = 0.005
    #: Quake-style arrival-shaped windows: EMA the per-op inter-arrival
    #: gap and wait `window_fill` of the expected time to fill the
    #: batch cap, clamped to [window_min, window_max]
    adaptive_windows: bool = True
    window_min: float = 0.0
    window_max: float = 0.02
    window_fill: float = 0.5
    window_alpha: float = 0.2         # EMA smoothing of arrival gaps
    #: strict = serializable in arrival order (parity mode); relaxed =
    #: same-op coalescing across op boundaries (throughput mode)
    strict_order: bool = False
    k: Optional[int] = None           # result width; None = backend config
    #: typed per-query knobs (`SearchParams`): None fields resolve from
    #: the backend config at dispatch — the engine adds only its own
    #: serving-path fields (use_snapshot, pad_to = query_batch) and, when
    #: `record_heat` is left None, records edge heat only when the
    #: maintenance policy consumes it (heat_budget or tier_policy set);
    #: the per-batch heat scatter is pure cost otherwise
    search: SearchParams = field(default_factory=SearchParams)
    maintenance: MaintenancePolicy = field(default_factory=MaintenancePolicy)
    #: durability spine (DESIGN.md §11).  `wal` turns on write-ahead
    #: logging of every insert/delete micro-batch: tickets defer until
    #: the covering group commit, so an acknowledged write survives any
    #: crash.  `ckpt_dir` enables covering checkpoints (manual via
    #: `checkpoint()`, automatic via `maintenance.checkpoint_every`).
    wal: Optional[WalConfig] = None
    ckpt_dir: Optional[str] = None
    ckpt_keep: int = 3


class ServeEngine:
    def __init__(self, backend, cfg: Optional[ServeConfig] = None,
                 clock=time.monotonic):
        self.backend = backend
        self.cfg = cfg or ServeConfig()
        self.clock = clock
        self.metrics = ServeMetrics()
        self.maintenance = MaintenanceManager(backend, self.cfg.maintenance)
        self.queue = CoalescingQueue(
            batch_caps={Op.QUERY: self.cfg.query_batch,
                        Op.INSERT: self.cfg.insert_batch,
                        Op.DELETE: self.cfg.delete_batch},
            windows={Op.QUERY: self.cfg.query_window,
                     Op.INSERT: self.cfg.insert_window,
                     Op.DELETE: self.cfg.delete_window},
            strict_order=self.cfg.strict_order)
        self._seq = 0
        self._lock = threading.RLock()       # submit side; see _GUARDED_BY
        self._pump_lock = threading.RLock()  # execution side; see _GUARDED_BY
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # stable external ids across reorder permutations and shards:
        # the engine allocates external ids sequentially in insert order
        # (build rows seed the map via backend.initial_ids()), every
        # relayout perm is folded into this pair of maps, and -1 marks
        # the unallocated region of either space
        cap = backend.cap
        self._int2ext = np.full(cap, -1, dtype=np.int64)
        self._ext2int = np.full(cap, -1, dtype=np.int64)
        born = np.asarray(backend.initial_ids(), np.int64)
        self._int2ext[born] = np.arange(len(born))
        self._ext2int[:len(born)] = born
        self._next_ext = len(born)
        # external ids already deleted through this engine: a repeat
        # delete (relaxed coalescing can double-submit one client retry)
        # is dropped host-side as a counted no-op instead of reaching the
        # device.  Internal ids are never reused (consolidation retires
        # them, DESIGN.md §9), so entries are never removed.
        self._deleted_ext: set = set()
        # adaptive-window state: per-op EMA of inter-arrival gaps
        self._gap_ema: Dict[Op, Optional[float]] = {op: None for op in Op}
        self._last_arrival: Dict[Op, Optional[float]] = {
            op: None for op in Op}
        self._caps = {Op.QUERY: self.cfg.query_batch,
                      Op.INSERT: self.cfg.insert_batch,
                      Op.DELETE: self.cfg.delete_batch}
        for op, w in self.queue.windows().items():
            self.metrics.windows[op] = w
        self.batch_log: List[tuple] = []   # (op, size) per executed batch
        # durability spine (DESIGN.md §11): opening the WAL scans its
        # segments and truncates any torn tail; write-op tickets are
        # staged in _pending_acks and resolve only once a group commit
        # covers their record (ack => record fsync'd)
        self.wal: Optional[WriteAheadLog] = \
            WriteAheadLog(self.cfg.wal) if self.cfg.wal is not None else None
        self._pending_acks: List[Tuple[Ticket, Any]] = []
        self._oldest_pending_t: Optional[float] = None
        self._covering_lsn = NO_LSN       # lsn of the last checkpoint
        self._has_ckpt = False
        self._ckpt_seq = 0                # checkpoint step when no WAL
        #: crash-recovery harness gate (ft/elastic.FailureInjector);
        #: None in production — every injection point is then free
        self.injector = None
        self.maintenance.checkpoint_fn = self.checkpoint
        self.maintenance.crash_hook = self._crash

    # -- submission -----------------------------------------------------------

    def _submit(self, op: Op, payload) -> Ticket:
        with self._lock:
            now = self.clock()
            req = Request(op=op, payload=payload, seq=self._seq,
                          t_enqueue=now)
            self._seq += 1
            self.queue.push(req)
            if self.cfg.adaptive_windows:
                last = self._last_arrival[op]
                if last is not None:
                    gap = now - last
                    ema = self._gap_ema[op]
                    a = self.cfg.window_alpha
                    self._gap_ema[op] = gap if ema is None \
                        else a * gap + (1 - a) * ema
                self._last_arrival[op] = now
            return req.ticket

    def submit_query(self, q) -> Ticket:
        """Query one vector; ticket resolves to QueryResult."""
        return self._submit(Op.QUERY, np.asarray(q, np.float32))

    def submit_insert(self, x) -> Ticket:
        """Insert one vector; ticket resolves to its stable external id."""
        return self._submit(Op.INSERT, np.asarray(x, np.float32))

    def submit_delete(self, ext_id: int) -> Ticket:
        """Delete by external id; ticket resolves to True, or False when
        the delete is a counted no-op (`metrics.delete_noops`) — the id
        was already deleted through this engine, or was never allocated.

        Rejects ids outside [0, cap) up front: -1 (the search-result pad
        value) would otherwise wrap through the numpy id map and delete
        an unrelated node.
        """
        ext_id = int(ext_id)
        if not 0 <= ext_id < self.backend.cap:
            raise ValueError(f"external id {ext_id} outside [0, "
                             f"{self.backend.cap})")
        return self._submit(Op.DELETE, ext_id)

    # -- adaptive batch shaping (Quake-style) ---------------------------------

    def _shape_windows(self) -> None:
        """Re-derive each op's coalescing window from the arrival EMA:
        wait `window_fill` of the expected time for the batch cap to
        fill, clamped to [window_min, window_max].  Ops with no gap
        sample yet keep their configured starting window."""
        for op in Op:
            ema = self._gap_ema[op]
            if ema is None:
                continue
            w = self.cfg.window_fill * self._caps[op] * ema
            w = min(max(w, self.cfg.window_min), self.cfg.window_max)
            self.queue.set_window(op, w)
            self.metrics.windows[op] = w

    # -- execution ------------------------------------------------------------

    def _exec_query(self, reqs: List[Request]) -> None:
        qs = np.stack([r.payload for r in reqs])
        if self.backend.snapshot_stale:
            self.metrics.snapshot_resolves += 1
        p = self.cfg.search
        if p.record_heat is None:
            # both heat consumers need the traversal signal: the reorder
            # trigger and the tier demotion policy (DESIGN.md §12)
            p = p.replace(record_heat=(
                self.cfg.maintenance.heat_budget is not None
                or self.cfg.maintenance.tier_policy is not None))
        res = self.backend.search(
            qs, k=self.cfg.k,
            params=p.replace(use_snapshot=True,
                             pad_to=self.cfg.query_batch))
        ext = np.where(res.ids >= 0,
                       self._int2ext[np.maximum(res.ids, 0)], -1)
        for row_ids, row_d, req in zip(ext, res.dists, reqs):
            req.ticket._complete(QueryResult(ids=row_ids, dists=row_d))

    def _exec_insert(self, reqs: List[Request]) -> None:
        xs = np.stack([r.payload for r in reqs])
        n = len(reqs)
        # external ids are pre-assigned (allocation is sequential and
        # deterministic) so the WAL record carries them *before* the
        # backend dispatch: replaying the record reproduces the same
        # ext->int binding the original acks promised
        ext_ids = np.arange(self._next_ext, self._next_ext + n,
                            dtype=np.int64)
        pre_lsn = self.wal.last_lsn if self.wal is not None else NO_LSN
        try:
            self._log_batch(
                lambda: self.wal.append_insert(ext_ids, xs))
            res = self.backend.insert_batch(xs, pad_to=self.cfg.insert_batch)
        except BaseException:
            if self.wal is not None and self.wal.last_lsn > pre_lsn:
                # the record is in the log but the batch failed: burn
                # its ext ids so the next batch can't log them again —
                # a replay of the orphaned record then lands on ids no
                # acked batch owns (an at-least-once ghost the client
                # retries), instead of rebinding ids a later acked
                # batch was granted
                self._next_ext += n
            raise
        gids = np.asarray(res.ids, np.int64)
        self._next_ext += n
        self._ext2int[ext_ids] = gids
        self._int2ext[gids] = ext_ids
        # one batched host conversion for the whole ack run, not one
        # numpy-scalar unboxing per request
        for ext, req in zip(ext_ids.tolist(), reqs):
            self._stage_ack(req.ticket, ext)

    def _apply_delete(self, ext: np.ndarray) -> np.ndarray:
        """Dedup + dispatch one delete batch; returns the fresh mask.

        Drops repeats and never-allocated ids host-side: the ticket
        still resolves (False), but nothing reaches the device for
        them — a double delete must be a counted no-op, not a write,
        and an unallocated ext id must not be poisoned against the
        day an insert hands it out.  WAL replay re-enters here with the
        *as-submitted* batch: the same dedup against the restored
        deleted-set absorbs duplicates, which is what makes replay
        idempotent.
        """
        internal = self._ext2int[ext]
        fresh = np.ones(len(ext), bool)
        batch_seen: set = set()
        # two batched host conversions up front instead of a
        # numpy-scalar unboxing per element
        dead = (internal < 0).tolist()
        for j, e in enumerate(ext.tolist()):
            if e in self._deleted_ext or e in batch_seen or dead[j]:
                fresh[j] = False
            else:
                batch_seen.add(e)
        n_noop = int((~fresh).sum())
        if n_noop:
            self.metrics.delete_noops += n_noop
        gids = np.where(fresh, internal, -1)
        if fresh.any():
            self.backend.delete_batch(gids, pad_to=self.cfg.delete_batch)
        # record only after the device call succeeded: a raised dispatch
        # must not poison the ids as 'already deleted' (the client will
        # retry the failed tickets)
        self._deleted_ext.update(batch_seen)
        self.maintenance.note_deletes(int(fresh.sum()))
        return fresh

    def _exec_delete(self, reqs: List[Request]) -> None:
        ext = np.asarray([r.payload for r in reqs], np.int64)
        self._log_batch(lambda: self.wal.append_delete(ext))
        fresh = self._apply_delete(ext)
        for req, f in zip(reqs, fresh.tolist()):
            self._stage_ack(req.ticket, f)

    # -- WAL group commit + failure injection (DESIGN.md §11) -----------------

    def _log_batch(self, append: Callable[[], int]) -> int:
        """Append one write batch's WAL record, then pass the two ingest
        injection points.  Returns the record's LSN (NO_LSN without a
        WAL).  `pre_commit` crashes lose the (unsynced) record along
        with its unacked tickets; `post_commit_pre_apply` first forces
        the record durable, modelling a crash after the group commit but
        before the in-memory apply — recovery must replay it."""
        if self.wal is None:
            return NO_LSN
        lsn = append()
        self.metrics.wal_records += 1
        if self._oldest_pending_t is None:
            self._oldest_pending_t = self.clock()
        self._crash("pre_commit")
        self._crash("post_commit_pre_apply")
        return lsn

    def _stage_ack(self, ticket: Ticket, value) -> None:
        """Resolve now (no WAL) or defer until the covering commit."""
        if self.wal is None:
            ticket._complete(value)
        else:
            self._pending_acks.append((ticket, value))

    def _commit_wal(self, *, force: bool = False) -> None:
        """Group commit: fsync once `group_commit_n` records are pending
        or the oldest has waited `group_commit_ms`, then resolve every
        staged ticket — the invariant is ack => record durable."""
        if self.wal is None or self.wal.n_unsynced == 0:
            if self.wal is not None and self._pending_acks:
                # records already durable (e.g. a forced sync at an
                # injection point); release the acks they cover
                self._release_acks()
            return
        wcfg = self.wal.cfg
        age_ms = 0.0
        if self._oldest_pending_t is not None:
            age_ms = (self.clock() - self._oldest_pending_t) * 1e3
        if not (force or self.wal.n_unsynced >= wcfg.group_commit_n
                or (wcfg.group_commit_ms > 0
                    and age_ms >= wcfg.group_commit_ms)):
            return
        self.wal.sync()
        self.metrics.wal_commits += 1
        self._release_acks()

    def _release_acks(self) -> None:
        acks, self._pending_acks = self._pending_acks, []
        self._oldest_pending_t = None
        for ticket, value in acks:
            ticket._complete(value)

    def _crash(self, point: str) -> None:
        """Failure-injection gate.  `point` is one of the matrix in
        DESIGN.md §11: pre_commit, post_commit_pre_apply,
        mid_checkpoint, mid_consolidation.  No-op without an injector.
        """
        inj = self.injector
        if inj is None:
            return
        if (point == "post_commit_pre_apply" and self.wal is not None
                and inj.armed(point)):
            self.wal.sync()   # the record must survive this crash
        inj.at(point)

    def _apply_perm(self, perm: np.ndarray) -> None:
        """Fold a reorder permutation (perm[old_int] = new_int, identity
        outside the permuted region) into the external id maps; internal
        ids allocated after the perm are untouched, unallocated entries
        stay -1."""
        perm = np.asarray(perm, np.int64)
        n = len(perm)
        old_ext = self._int2ext[:n].copy()
        self._int2ext[perm] = old_ext
        alloc = old_ext >= 0
        self._ext2int[old_ext[alloc]] = perm[alloc]

    @property
    def delete_noops(self) -> int:
        """Total no-op deletes: engine-level repeats/unallocated dropped
        host-side, plus the backend stats surface's device-side count of
        deletes that hit absent/dead internal ids."""
        return self.metrics.delete_noops + self.backend.stats().delete_noops

    def _claim_overlap(self, *, block: bool = False) -> None:
        """Book a finished overlapped consolidation (DESIGN.md §13)."""
        if self.maintenance.poll_overlap(block=block):
            self.metrics.maintenance_runs["consolidate"] += 1

    def pump(self, *, force: bool = False) -> Optional[Op]:
        """Execute at most one micro-batch; returns its op, or None.

        `force` releases under-full runs immediately (drain semantics).
        Pumps are serialized against each other by `_pump_lock`, but the
        queue lock is held only to pop the batch — submit_* never waits
        behind a device dispatch.

        While an overlapped repair is in flight (relaxed mode), write
        batches are held back — their write barrier would force the
        cutover early and stall on the repair — and queries keep
        flowing against the live state; the hold lifts as soon as the
        repair lands (polled here every pump).  Under `force` (drain
        semantics) a held write forces the cutover instead of waiting.
        """
        with self._pump_lock:
            self._claim_overlap()   # book a landed repair promptly
            hold = (self.maintenance.overlap_inflight
                    and not self.cfg.strict_order)
            with self._lock:
                if self.cfg.adaptive_windows:
                    self._shape_windows()
                got = self.queue.next_batch(self.clock(), force=force,
                                            hold_writes=hold)
                held_writes = hold and (
                    self.queue.has_pending(Op.INSERT)
                    or self.queue.has_pending(Op.DELETE))
            if held_writes:
                self.metrics.write_holds += 1
            if got is None and held_writes and force:
                # drain must make progress: force the cutover, then
                # release the held writes normally
                self._claim_overlap(block=True)
                with self._lock:
                    got = self.queue.next_batch(self.clock(), force=True)
            if got is None:
                # no batch released: still honor the group-commit clock
                # so deferred acks can't wait behind an idle queue
                self._commit_wal()
                return None
            op, reqs = got
            try:
                if op is Op.QUERY:
                    self._exec_query(reqs)
                else:
                    if op is Op.INSERT:
                        self._exec_insert(reqs)
                    else:
                        self._exec_delete(reqs)
                    self.maintenance.note_write_batch()
                    actions = self.maintenance.run_if_due()
                    if "reorder" in actions:
                        self._apply_perm(self.maintenance.last_perm)
                    for a in actions:
                        self.metrics.maintenance_runs[a] += 1
                    self._commit_wal()
                    self.maintenance.maybe_checkpoint()
            except BaseException as e:
                # un-stage this batch's deferred acks before failing its
                # tickets: a later group commit must not resolve a
                # ticket the client was already told failed
                dead = {r.ticket for r in reqs}
                self._pending_acks = [(t, v) for t, v in self._pending_acks
                                      if t not in dead]
                for r in reqs:
                    if not r.ticket.done:
                        r.ticket._fail(e)
                raise
            now = self.clock()
            self.metrics.record_batch(
                op, len(reqs), [now - r.t_enqueue for r in reqs], now)
            self.batch_log.append((op, len(reqs)))
            return op

    def drain(self) -> int:
        """Pump until the queue is empty (then force the group commit so
        every staged ack resolves); returns batches executed."""
        n = 0
        while True:
            with self._lock:
                empty = len(self.queue) == 0
            if empty:
                with self._pump_lock:
                    self._commit_wal(force=True)
                    # settle any in-flight overlapped repair: after a
                    # drain the maintenance counters must be final
                    self._claim_overlap(block=True)
                return n
            if self.pump(force=True) is not None:
                n += 1

    # -- durability: checkpoint / recover (DESIGN.md §11) ---------------------

    def resolve_ext(self, ext_id: int) -> int:
        """Internal id currently backing an external id (-1 = none) —
        the id-level survival probe the recovery harness verifies with."""
        with self._pump_lock:
            return int(self._ext2int[int(ext_id)])

    def is_deleted(self, ext_id: int) -> bool:
        """True if this engine has applied a delete of `ext_id`."""
        with self._pump_lock:
            return int(ext_id) in self._deleted_ext

    def checkpoint(self) -> Optional[str]:
        """Write a covering checkpoint: force the group commit, save the
        backend with the engine's id maps as extras, then drop WAL
        segments the checkpoint covers.  Returns the published path, or
        None when disabled / nothing new to cover.  The covering LSN in
        the manifest is the replay cut: recovery applies exactly the
        records after it."""
        if self.cfg.ckpt_dir is None:
            return None
        with self._pump_lock:
            # a checkpoint must capture a settled backend: force the
            # overlapped-repair cutover first so the saved state and the
            # maintenance counters agree
            self._claim_overlap(block=True)
            if self.wal is not None:
                self._commit_wal(force=True)
                lsn = self.wal.last_lsn
                if self._has_ckpt and lsn == self._covering_lsn:
                    return None          # nothing new since last cover
            else:
                self._ckpt_seq += 1
                lsn = self._ckpt_seq
            deleted = np.zeros(self.backend.cap, bool)
            if self._deleted_ext:
                deleted[np.fromiter(self._deleted_ext, np.int64)] = True
            # _seq belongs to the submit side: snapshot it under _lock
            # (reading it under _pump_lock alone races a live submit_*)
            with self._lock:
                seq = self._seq
            path = self.backend.save(
                self.cfg.ckpt_dir, lsn=lsn,
                extra={"int2ext": self._int2ext, "ext2int": self._ext2int,
                       "deleted": deleted},
                meta={"next_ext": self._next_ext, "seq": seq,
                      # maintenance trigger phase: replay must re-enter
                      # run_if_due with the same counters or its
                      # consolidate/compact timing drifts from the
                      # original timeline (breaking bit-exact replay)
                      "maint_since_check":
                          self.maintenance.write_batches_since_check,
                      "maint_deletes":
                          self.maintenance.deletes_since_compact},
                keep=self.cfg.ckpt_keep,
                _pre_publish=lambda: self._crash("mid_checkpoint"))
            self._covering_lsn = lsn
            self._has_ckpt = True
            self.metrics.maintenance_runs["checkpoint"] += 1
            if self.wal is not None:
                self.wal.truncate_through(lsn)
            return path

    @classmethod
    def recover(cls, cfg: ServeConfig, *,
                fresh_backend: Callable[[], Any],
                restore_backend: Optional[
                    Callable[[str], Tuple[Any, dict, dict]]] = None,
                clock=time.monotonic, injector=None) -> "ServeEngine":
        """Rebuild an engine after a crash (or cold-start it — with no
        checkpoint and an empty WAL this is a plain constructor).

        `restore_backend(ckpt_dir) -> (backend, metadata, extras)` is
        the implementation's restore classmethod (e.g.
        ``lambda d: LSMVecIndex.restore(hnsw_cfg, d)``); `fresh_backend`
        builds the empty backend when no checkpoint exists.  Opening the
        WAL truncates any torn tail; the tail records past the covering
        LSN then replay through the normal dispatch path.
        """
        backend, md, extras = None, {}, {}
        if (cfg.ckpt_dir is not None and restore_backend is not None
                and latest_step(cfg.ckpt_dir) is not None):
            backend, md, extras = restore_backend(cfg.ckpt_dir)
        restored = backend is not None
        if backend is None:
            backend = fresh_backend()
        eng = cls(backend, cfg, clock=clock)
        eng.injector = injector
        if restored:
            eng._int2ext = np.asarray(extras["int2ext"], np.int64).copy()
            eng._ext2int = np.asarray(extras["ext2int"], np.int64).copy()
            eng._deleted_ext = set(
                np.flatnonzero(np.asarray(extras["deleted"], bool)).tolist())
            eng._next_ext = int(md["next_ext"])
            eng._seq = int(md["seq"])
            eng._covering_lsn = int(md.get("lsn", NO_LSN))
            # without a WAL the checkpoint "lsn" is the engine's own
            # step counter: resume it, or the first post-recovery
            # checkpoint publishes step_1 below the restored step_N and
            # latest_step keeps resolving the stale checkpoint forever
            eng._ckpt_seq = eng._covering_lsn
            eng._has_ckpt = True
            eng.maintenance.write_batches_since_check = \
                int(md.get("maint_since_check", 0))
            eng.maintenance.deletes_since_compact = \
                int(md.get("maint_deletes", 0))
        if eng.wal is not None:
            eng._replay(eng.wal.records(after=eng._covering_lsn))
            # replay may have re-triggered an overlapped repair; settle
            # it so the recovered engine's state is deterministic
            eng._claim_overlap(block=True)
        return eng

    def _replay(self, records: List[WalRecord]) -> int:
        """Re-dispatch recovered WAL records through the identical batch
        path — same pad widths, same maintenance cadence — so for
        deterministic policies the recovered backend is bit-exact with
        an uninterrupted run of the same record sequence.  Exactly-once
        relative to the restored state: backend memory is volatile, so
        everything after the covering LSN is by definition unapplied.
        Returns the number of records applied."""
        n = 0
        # recovery is single-threaded, but holding the execution lock
        # keeps the _GUARDED_BY contract uniform (and is free: RLock,
        # no contention before serving starts)
        with self._pump_lock:
            for rec in records:
                if rec.kind == KIND_INSERT:
                    res = self.backend.insert_batch(
                        rec.vectors, pad_to=self.cfg.insert_batch)
                    gids = np.asarray(res.ids, np.int64)
                    self._ext2int[rec.ext_ids] = gids
                    self._int2ext[gids] = rec.ext_ids
                    self._next_ext = max(self._next_ext,
                                         int(rec.ext_ids.max()) + 1)
                else:
                    self._apply_delete(rec.ext_ids)
                self.maintenance.note_write_batch()
                actions = self.maintenance.run_if_due()
                if "reorder" in actions:
                    self._apply_perm(self.maintenance.last_perm)
                for a in actions:
                    self.metrics.maintenance_runs[a] += 1
                n += 1
        return n

    def close(self) -> None:
        """Graceful shutdown: stop serving, drain, close the WAL.  A
        crash-recovery test never calls this — simulated death abandons
        the files exactly as a killed process would."""
        self.stop()
        if self.wal is not None:
            self.wal.close()

    # -- background serving ---------------------------------------------------

    def start(self) -> None:
        """Run the pump loop in a daemon thread (live serving mode)."""
        if self._thread is not None:
            return
        self._stop.clear()

        def loop():
            while not self._stop.is_set():
                if self.pump() is None:
                    # nothing released: sleep one coalescing quantum
                    time.sleep(min(self.cfg.query_window,
                                   self.cfg.insert_window, 0.001))

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="lsmvec-serve")
        self._thread.start()

    def stop(self, *, drain: bool = True) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None
        if drain:
            self.drain()
