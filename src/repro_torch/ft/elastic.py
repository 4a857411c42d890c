"""Fault-tolerance policy layer, shared by the training loop and the
serving path.

On a 1000+-node cluster the failure model is: a node (or pod) dies every
few hours; stragglers inflate step time; capacity changes mid-run.  The
policy here is the standard production one:

 1. *Checkpoint/restart* — atomic checkpoints every `ckpt_every` units
    (ckpt.py): training steps in `run_with_restarts`, serve write
    batches in `run_with_recovery`.  On any failure the launcher
    re-enters the run loop, which restores the latest checkpoint and
    resumes exactly — the training pipeline is counter-addressed, the
    serving path replays its WAL tail (DESIGN.md §11).
 2. *Straggler mitigation* — step times are monitored; a step exceeding
    `straggler_factor` x the trailing median marks the step "slow".  On a
    real cluster the response is re-scheduling the slow host (backup
    workers / a coordination timeout); here the detector and its
    accounting are implemented and tested, and the response hook is
    pluggable.
 3. *Elastic re-mesh* — checkpoints store logical (global-shape) arrays,
    so a resume may build a different mesh (fewer/more pods) and reshard;
    `run_with_restarts` re-invokes the step-builder with the current mesh.

`FailureInjector` deterministically raises mid-run to exercise all
paths in tests: by global step (`fail_at`, the training form) or by
named injection point (`fail_points`, the serve form — pre_commit,
post_commit_pre_apply, mid_checkpoint, mid_consolidation).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint


class SimulatedFailure(RuntimeError):
    pass


@dataclass
class FailureInjector:
    """Raises SimulatedFailure deterministically, once per trigger.

    Two trigger forms, freely mixed:
    - `fail_at`: global training steps (checked via `check(step)`);
    - `fail_points`: named serve-path injection points — the value is
      the 1-based hit index at which to fire, so ``{"pre_commit": 3}``
      crashes the third batch that reaches the pre-commit gate.  The
      engine passes each point via `at(point)`; `armed(point)` lets the
      call site prepare the crash (e.g. force a WAL sync so a
      post-commit crash leaves a durable record).
    """
    fail_at: List[int] = field(default_factory=list)
    fail_points: Dict[str, int] = field(default_factory=dict)
    seen: set = field(default_factory=set)
    hits: Dict[str, int] = field(default_factory=dict)

    def check(self, step: int):
        if step in self.fail_at and step not in self.seen:
            self.seen.add(step)
            raise SimulatedFailure(f"injected failure at step {step}")

    def armed(self, point: str) -> bool:
        """True if the *next* `at(point)` will raise."""
        target = self.fail_points.get(point)
        return (target is not None and point not in self.seen
                and self.hits.get(point, 0) + 1 == target)

    def at(self, point: str):
        """Pass a named injection point; raises on the configured hit."""
        self.hits[point] = self.hits.get(point, 0) + 1
        target = self.fail_points.get(point)
        if target is not None and point not in self.seen \
                and self.hits[point] == target:
            self.seen.add(point)
            raise SimulatedFailure(
                f"injected failure at {point} (hit {target})")


@dataclass
class RestartPolicy:
    """One policy object for both run loops.  `ckpt_dir` has no default:
    train and serve runs must name their own directory (the old shared
    `/tmp/repro_ckpt` default let two suites resume from each other's
    checkpoints).  `ckpt_every` counts training steps under
    `run_with_restarts` and serve write batches under
    `run_with_recovery`; `wal_dir` is serve-only (None = run without a
    WAL, i.e. no durability for un-checkpointed writes)."""
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 10
    max_restarts: int = 5
    straggler_factor: float = 3.0
    keep: int = 3
    wal_dir: Optional[str] = None


class StragglerDetector:
    def __init__(self, factor: float, window: int = 16):
        self.factor = factor
        self.window = window
        self.times: List[float] = []
        self.flagged: List[int] = []

    def observe(self, step: int, dt: float) -> bool:
        self.times.append(dt)
        hist = sorted(self.times[-self.window:])
        median = hist[len(hist) // 2]
        slow = len(self.times) >= 4 and dt > self.factor * median
        if slow:
            self.flagged.append(step)
        return slow


def run_with_restarts(
    *,
    policy: RestartPolicy,
    init_state: Callable[[], Any],
    step_fn: Callable[[Any, int], Any],
    num_steps: int,
    injector: Optional[FailureInjector] = None,
    meta_fn: Callable[[int], Dict] = lambda step: {},
    on_straggler: Optional[Callable[[int], None]] = None,
) -> Dict[str, Any]:
    """Drive `step_fn` to `num_steps` surviving injected/real failures.

    Returns {"state": final, "restarts": n, "stragglers": [...],
    "resumed_from": [...]}.
    """
    if policy.ckpt_dir is None:
        raise ValueError("RestartPolicy.ckpt_dir must be set (the old "
                         "/tmp/repro_ckpt default is gone)")
    restarts = 0
    resumed_from: List[int] = []
    detector = StragglerDetector(policy.straggler_factor)

    while True:
        try:
            start = latest_step(policy.ckpt_dir)
            if start is not None:
                state, meta, start = restore_checkpoint(
                    policy.ckpt_dir, init_state(), step=start)
                resumed_from.append(start)
                step = start
            else:
                state = init_state()
                step = 0
            while step < num_steps:
                t0 = time.monotonic()
                if injector is not None:
                    injector.check(step)
                state = step_fn(state, step)
                step += 1
                if detector.observe(step, time.monotonic() - t0) \
                        and on_straggler:
                    on_straggler(step)
                if step % policy.ckpt_every == 0 or step == num_steps:
                    save_checkpoint(policy.ckpt_dir, step, state,
                                    metadata=meta_fn(step),
                                    keep=policy.keep)
            return {"state": state, "restarts": restarts,
                    "stragglers": detector.flagged,
                    "resumed_from": resumed_from}
        except SimulatedFailure:
            restarts += 1
            if restarts > policy.max_restarts:
                raise


# ---------------------------------------------------------------------------
# serve-path crash recovery (DESIGN.md §11)
# ---------------------------------------------------------------------------

def run_with_recovery(
    *,
    policy: RestartPolicy,
    make_engine: Callable[[Optional[FailureInjector]], Any],
    ops: List[Tuple[str, Any]],
    injector: Optional[FailureInjector] = None,
    chunk: int = 8,
) -> Dict[str, Any]:
    """Drive a serve op stream to completion across injected crashes.

    `make_engine(injector)` must return a recovered engine — in
    practice a thin wrapper over ``ServeEngine.recover`` pointed at
    `policy.ckpt_dir`/`policy.wal_dir` — so calling it again after a
    SimulatedFailure restores the latest covering checkpoint and
    replays the WAL tail.  `ops` is the client stream:
    ``("insert", vector)`` / ``("delete", ext_id)`` / ``("query",
    vector)``.

    Delivery semantics are the WAL's: acknowledged writes are durable
    and survive every crash; unacknowledged writes are retried by this
    loop (at-least-once — a retried insert whose original record was
    already durable-but-unacked becomes a second copy under a fresh
    external id, exactly what a real client retry produces).

    Returns ``{"engine", "acked" (op index -> ticket value),
    "restarts", "retried"}``.
    """
    engine = make_engine(injector)
    remaining = list(enumerate(ops))     # (op index, (kind, payload))
    acked: Dict[int, Any] = {}
    restarts = 0
    retried = 0

    def _submit(eng, idx, kind, payload):
        if kind == "insert":
            return idx, eng.submit_insert(payload)
        if kind == "delete":
            return idx, eng.submit_delete(payload)
        if kind == "query":
            return idx, eng.submit_query(payload)
        raise ValueError(f"unknown op kind {kind!r}")

    while remaining:
        batch, remaining = remaining[:chunk], remaining[chunk:]
        tickets = []
        try:
            for idx, (kind, payload) in batch:
                tickets.append(_submit(engine, idx, kind, payload))
            engine.drain()
            for idx, t in tickets:
                acked[idx] = t.result()
        except SimulatedFailure:
            restarts += 1
            if restarts > policy.max_restarts:
                raise
            # harvest what resolved before the crash; everything else
            # goes back to the head of the stream in original order
            done = set()
            for idx, t in tickets:
                if t.done:
                    try:
                        acked[idx] = t.result()
                        done.add(idx)
                    except BaseException:
                        pass            # failed ticket: retry
            redo = [(idx, op) for idx, op in batch if idx not in done]
            retried += len(redo)
            remaining = redo + remaining
            # simulated process death: drop the dead engine's WAL fd
            # without flushing — a real kill never flushes, and a late
            # buffered flush would write a stale partial record into
            # the segment the restarted engine appends to
            wal = getattr(engine, "wal", None)
            if wal is not None:
                wal.abandon()
            engine = make_engine(injector)   # simulated process restart
    engine.drain()
    return {"engine": engine, "acked": acked, "restarts": restarts,
            "retried": retried}


def verify_acked_writes(engine, ops: List[Tuple[str, Any]],
                        acked: Dict[int, Any]) -> Dict[str, int]:
    """Prove zero acknowledged-write loss after recovery.

    Replays the acked subset of `ops` into an expected live-set, then
    checks every expected-live external id two ways: by id (the engine
    maps it to a live internal id) and by search reachability (querying
    its own vector returns it).  Acked deletes must read as deleted.
    Raises AssertionError naming the first lost write; returns counts
    ``{"live", "deleted", "searched"}``.
    """
    expect_live: Dict[int, Any] = {}
    expect_deleted: List[int] = []
    for idx, (kind, payload) in enumerate(ops):
        if idx not in acked:
            continue
        if kind == "insert":
            expect_live[int(acked[idx])] = np.asarray(payload, np.float32)
        elif kind == "delete":
            expect_live.pop(int(payload), None)
            expect_deleted.append(int(payload))

    for ext in expect_live:
        gid = engine.resolve_ext(ext)
        assert gid >= 0, f"acked insert ext={ext} lost: no internal id"
        assert not engine.is_deleted(ext), \
            f"acked insert ext={ext} reads as deleted"
    for ext in expect_deleted:
        assert engine.is_deleted(ext) or engine.resolve_ext(ext) < 0, \
            f"acked delete ext={ext} still live after recovery"

    searched = 0
    items = list(expect_live.items())
    tickets = [engine.submit_query(vec) for _, vec in items]
    engine.drain()
    for (ext, _), t in zip(items, tickets):
        res = t.result()
        assert ext in np.asarray(res.ids).tolist(), \
            f"acked insert ext={ext} not search-reachable after recovery"
        searched += 1
    return {"live": len(expect_live), "deleted": len(expect_deleted),
            "searched": searched}
