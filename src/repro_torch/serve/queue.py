"""Coalescing request queue: arrival-ordered FIFO with per-op batch caps
and coalescing windows (DESIGN.md §8).

Two gather modes decide which requests join a micro-batch:

- **strict** — the batch is the longest run of *consecutive* same-op
  requests at the head of the FIFO.  Queries never jump over a pending
  write and vice versa, so the executed schedule is serializable in
  arrival order: the stream produces exactly the results of applying
  every op one-by-one (the parity contract the tests pin).
- **relaxed** — the batch gathers same-op requests from anywhere in the
  queue (op chosen by the oldest pending request).  Queries may execute
  before an older write completes and writes of different ops may
  reorder around each other — the Quake-style throughput mode, where
  the workload mix shapes the batch instead of the arrival interleave.
  Same-op order is always preserved (insert ids stay deterministic,
  deletes stay FIFO), and cross-op write reordering cannot change the
  final live set: a delete can only name an id some already-completed
  insert returned, so no delete can jump ahead of "its" insert.  What
  may differ from arrival-order execution is which graph edges form
  around in-flight nodes — the usual relaxed-consistency ANN-serving
  trade, bounded by the recall guardrail in `benchmarks/serve_load.py`.

Release policy, shared by both modes: a gathered run is dispatched when
it reaches the op's batch cap, when its oldest member has waited at
least the op's coalescing window, or when the run cannot grow anymore
(strict mode: a different-op request is queued right behind it).
Otherwise the queue holds the run back, trading latency for occupancy.
"""

from __future__ import annotations

import collections
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.serve.request import Op, Request


class CoalescingQueue:
    def __init__(self, *, batch_caps: Dict[Op, int],
                 windows: Dict[Op, float], strict_order: bool = False):
        self._fifo: Deque[Request] = collections.deque()
        self._caps = dict(batch_caps)
        self._windows = dict(windows)
        self.strict_order = strict_order

    def __len__(self) -> int:
        return len(self._fifo)

    def push(self, req: Request) -> None:
        self._fifo.append(req)

    def set_window(self, op: Op, window: float) -> None:
        """Retarget one op's coalescing window (the engine's adaptive
        batch shaping re-derives windows from the live arrival mix)."""
        self._windows[op] = window

    def windows(self) -> Dict[Op, float]:
        """Current per-op coalescing windows (a copy)."""
        return dict(self._windows)

    def has_pending(self, op: Op) -> bool:
        """True when at least one request of `op` is queued."""
        return any(r.op is op for r in self._fifo)

    def _gather(self, only_op: Optional[Op] = None
                ) -> Tuple[List[Request], bool]:
        """Candidate run for the next micro-batch (not yet removed).

        Returns (run, closed): `closed` means the run can never grow —
        it hit its cap, or (strict mode) a different-op request follows.
        Relaxed mode gathers the head op from anywhere in the queue:
        cross-op reordering is safe for liveness because a delete can
        only name an id some already-*completed* insert returned (the
        external-id contract), so only same-op arrival order — which
        every run preserves — is semantically load-bearing.
        `only_op` restricts the run to that op (the engine's write-hold
        during an overlapped repair, relaxed mode only); the run may be
        empty.
        """
        head_op = self._fifo[0].op if only_op is None else only_op
        cap = self._caps[head_op]
        run: List[Request] = []
        blocked = False
        for req in self._fifo:
            if req.op is head_op:
                run.append(req)
                if len(run) >= cap:
                    return run, True
            elif self.strict_order:
                blocked = True
                break
        if not self.strict_order:
            # an open run only stays open while it could still fill
            return run, False
        return run, blocked

    def next_batch(self, now: float, *, force: bool = False,
                   hold_writes: bool = False
                   ) -> Optional[Tuple[Op, List[Request]]]:
        """Pop the next micro-batch, or None if coalescing should wait.

        `now` comes from the engine's clock; `force` releases regardless
        of window state (used by drain()).  `hold_writes` (relaxed mode
        only — strict arrival order is the parity contract and is never
        reordered) restricts the batch to queries: the engine sets it
        while an overlapped repair is in flight so write batches — whose
        barrier would force the cutover early — defer until the repair
        lands, while queries keep flowing.  Returns None when only
        writes are pending under a hold.
        """
        if not self._fifo:
            return None
        only = Op.QUERY if (hold_writes and not self.strict_order) else None
        run, closed = self._gather(only)
        if not run:
            return None
        op = run[0].op
        expired = now - run[0].t_enqueue >= self._windows[op]
        if not (closed or expired or force):
            return None
        members = set(id(r) for r in run)
        self._fifo = collections.deque(
            r for r in self._fifo if id(r) not in members)
        return op, run

    def oldest_wait(self, now: float) -> float:
        """Age of the oldest pending request (0.0 when empty)."""
        return now - self._fifo[0].t_enqueue if self._fifo else 0.0
