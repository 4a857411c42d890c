"""Background maintenance policy: threshold-triggered consolidation,
compaction, and connectivity-aware relayout (DESIGN.md §8-10, §13).

The paper runs graph reordering piggybacked on LSM compaction (§3.4);
the seed repo left both as manual calls.  Here they become policy,
applied to any `VectorBackend` through its uniform
`maintain(op, **params) -> MaintenanceReport` method: the engine tracks
tombstone pressure host-side (no device syncs) and samples the
accumulated edge heat at a fixed batch cadence, triggering

- `maintain("consolidate")` when lazily-deleted (routable-but-not-
  returnable) nodes exceed `consolidate_ratio` of the index — the
  Quake-style live-workload trigger for the FreshDiskANN-style graph
  repair that splices tombstones out and reclaims their slots
  (DESIGN.md §9).  The check is **per shard**: the trigger fires when
  any shard's own ratio crosses the threshold
  (`BackendStats.max_tombstone_ratio`), and the backend consolidates
  exactly the shards over it.  With `overlap` (default) the repair runs
  double-buffered via `begin_maintain`/`poll_maintain` — queries keep
  serving from the live state while the repair runs (on the card: a
  worker thread on a second CUDA stream), and
  the cutover lands either at a poll or at the next write barrier
  (DESIGN.md §13),
- `maintain("compact")` when staged deletes since the last compaction
  exceed `tombstone_ratio` of the live set — bounding LSM read
  amplification and the dead-entry tax on resolve, and
- `maintain("reorder")` when total sampled edge heat exceeds
  `heat_budget` — enough fresh traversal signal that a relayout pays
  for itself.

Reordering permutes internal ids, so the engine owns an
external↔internal id mapping and folds each permutation (returned in
`MaintenanceReport.perm`, global across shards) into it; clients keep
their ids.  Consolidation retires internal ids without reusing them, so
the same map needs no rewrite — reclaimed entries simply become inert.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional

import numpy as np

from repro_torch.tier import TierPolicy


@dataclass
class MaintenancePolicy:
    """Thresholds; None disables the corresponding trigger."""

    #: LSM-staged deletes / live size (eager mode; lazy deletes stage
    #: nothing — consolidation doubles as their major compaction)
    tombstone_ratio: Optional[float] = 0.25
    #: graph tombstones / (live + tombstones) before consolidation runs,
    #: evaluated per shard (only meaningful under lazy deletion)
    consolidate_ratio: Optional[float] = 0.25
    heat_budget: Optional[int] = None         # total edge-heat counts
    check_every: int = 16                     # write batches between checks
    reorder_window: int = 8
    reorder_lam: float = 1.0
    #: write batches between covering checkpoints (DESIGN.md §11); None
    #: disables the trigger.  Unlike the threshold triggers this is a
    #: plain host counter — no device sync to evaluate — and it is not
    #: gated on `check_every`: durability cadence must not stretch just
    #: because maintenance probes are sparse.
    checkpoint_every: Optional[int] = None
    #: tiered hot/cold lane policy (DESIGN.md §12); None disables.  A
    #: demote/promote pass runs on every due check (it is a cheap
    #: no-op when the hot fraction already sits inside the hysteresis
    #: band), per shard — heat is shard-local, like the consolidate
    #: trigger.  Requires the backend's HNSWConfig to have `tier=True`.
    tier_policy: Optional[TierPolicy] = None
    #: overlapped consolidation (DESIGN.md §13): run the repair
    #: double-buffered against the live state instead of stop-the-world
    #: between micro-batches.  Cutover is atomic — at a poll once the
    #: repair's device work finishes, or at the next mutation's write
    #: barrier, whichever comes first — so correctness is unchanged;
    #: only query tail latency improves.
    overlap: bool = True


class MaintenanceManager:
    """Applies a MaintenancePolicy to one `VectorBackend`."""

    def __init__(self, backend, policy: MaintenancePolicy):
        self.backend = backend
        self.policy = policy
        self.deletes_since_compact = 0
        self.write_batches_since_check = 0
        self.write_batches_since_ckpt = 0
        self.compactions = 0
        self.reorders = 0
        self.consolidations = 0
        self.slots_reclaimed = 0
        self.checkpoints = 0
        self.tier_passes = 0
        self.tier_demoted = 0
        self.tier_promoted = 0
        #: an overlapped repair has begun and its report is unclaimed
        self.overlap_inflight = False
        self.last_perm: Optional[np.ndarray] = None
        #: the engine wires its `checkpoint()` here; the manager owns
        #: only the cadence (checkpoint_every write batches)
        self.checkpoint_fn: Optional[Callable[[], Optional[str]]] = None
        #: failure-injection gate (ServeEngine._crash); called at the
        #: mid-consolidation point of the crash-recovery matrix
        self.crash_hook: Optional[Callable[[str], None]] = None

    def note_deletes(self, n: int) -> None:
        """Count LSM-staged deletes toward the compact trigger.

        Lazy deletes are tombstone-bit-only — they stage nothing in the
        LSM, so they must not accrue compaction pressure (a compact
        would rewrite every level to drop zero dead entries and
        invalidate the read snapshot for nothing); consolidation is
        their compaction and resets the counter itself.
        """
        if not self.backend.lazy_delete:
            self.deletes_since_compact += n

    def note_write_batch(self) -> None:
        self.write_batches_since_check += 1
        self.write_batches_since_ckpt += 1

    def due(self) -> bool:
        return self.write_batches_since_check >= self.policy.check_every

    def maybe_checkpoint(self) -> bool:
        """Fire the covering-checkpoint callback when enough write
        batches have accumulated.  Returns True if a checkpoint ran.
        The counter resets before the callback: a crash mid-checkpoint
        must not re-arm the trigger on the very next batch of the dead
        process (the recovered engine starts its own cadence)."""
        pol = self.policy
        if pol.checkpoint_every is None or self.checkpoint_fn is None:
            return False
        if self.write_batches_since_ckpt < pol.checkpoint_every:
            return False
        self.write_batches_since_ckpt = 0
        if self.checkpoint_fn() is None:
            return False
        self.checkpoints += 1
        return True

    def _note_consolidation(self, reclaimed: int) -> None:
        """Book one finished consolidation: counters, the crash-matrix
        injection point, and the compact-counter reset (the rebuilt
        store is fully compacted and tombstone-free)."""
        if self.crash_hook is not None:
            # the consolidation mutated backend state that no WAL
            # record describes — the injection point proves recovery
            # does not depend on consolidation timing
            self.crash_hook("mid_consolidation")
        self.slots_reclaimed += reclaimed
        self.consolidations += 1
        self.deletes_since_compact = 0

    def poll_overlap(self, *, block: bool = False) -> bool:
        """Claim a finished overlapped consolidation (True iff one was
        claimed).  Cheap when nothing is in flight; a repair finished
        early by a mutation's write barrier is claimed here too."""
        if not self.overlap_inflight:
            return False
        rep = self.backend.poll_maintain(block=block)
        if rep is None:
            return False
        self.overlap_inflight = False
        if rep.applied:
            self._note_consolidation(rep.reclaimed)
            return True
        return False

    def barrier(self) -> bool:
        """Force any in-flight overlapped repair to completion and claim
        it (drain/checkpoint semantics).  True iff one was claimed."""
        return self.poll_overlap(block=True)

    def run_if_due(self, *, force: bool = False) -> List[str]:
        """Check thresholds and run triggered maintenance.

        Returns the actions taken (possibly empty).  Every op routes
        through the backend's uniform `maintain()` (or the async
        `begin_maintain`/`poll_maintain` pair when `policy.overlap`);
        the manager never string-dispatches over per-op return shapes —
        it reads one `MaintenanceReport`.  The stats and heat probes
        cost device->host scalar syncs, which is why they ride the
        `check_every` cadence; the overlap claim poll is host-only and
        runs on every call so a finished repair is booked promptly.
        The engine re-maps ids via the perm recorded in `last_perm`.
        """
        actions: List[str] = []
        # claim outside the due gate: a repair that finished between
        # checks must not wait out the cadence to be booked
        if self.poll_overlap():
            actions.append("consolidate")
        if not (force or self.due()):
            return actions
        self.write_batches_since_check = 0
        self.last_perm = None

        pol = self.policy
        st = None
        if (pol.consolidate_ratio is not None and self.backend.lazy_delete
                and not self.overlap_inflight):
            # one stats fetch per check: per-shard tombstone pressure is
            # the Quake-style live-workload signal
            st = self.backend.stats()
            if st.n_tombstones > 0 \
                    and st.max_tombstone_ratio >= pol.consolidate_ratio:
                if pol.overlap and hasattr(self.backend, "begin_maintain"):
                    if self.backend.begin_maintain(
                            "consolidate", ratio=pol.consolidate_ratio):
                        self.overlap_inflight = True
                        st = None   # stale once the repair cuts over
                else:
                    rep = self.backend.maintain(
                        "consolidate", ratio=pol.consolidate_ratio)
                    if rep.applied:
                        self._note_consolidation(rep.reclaimed)
                        actions.append("consolidate")
                        st = None   # stale after consolidation

        if pol.tombstone_ratio is not None and self.deletes_since_compact:
            if st is None:
                st = self.backend.stats()
            live = max(st.size, 1)
            if self.deletes_since_compact / live >= pol.tombstone_ratio:
                self.backend.maintain("compact")
                self.deletes_since_compact = 0
                self.compactions += 1
                actions.append("compact")

        if pol.heat_budget is not None:
            if self.backend.heat_total() >= pol.heat_budget:
                rep = self.backend.maintain(
                    "reorder", window=pol.reorder_window,
                    lam=pol.reorder_lam)
                self.last_perm = rep.perm
                self.backend.reset_heat()
                self.reorders += 1
                actions.append("reorder")

        if pol.tier_policy is not None:
            # after any reorder above: tier_maintain folds the heat the
            # reorder just consumed into its own EWMA, so running it
            # last keeps the two heat consumers in the same order every
            # check.  A pass that moves nothing still counts (the
            # trigger fired); the action is only recorded on real moves
            # so serve metrics show lane activity, not probe cadence.
            rep = self.backend.maintain("tier", policy=pol.tier_policy)
            self.tier_passes += 1
            self.tier_demoted += rep.demoted
            self.tier_promoted += rep.promoted
            if rep.applied:
                actions.append("tier")
        return actions
