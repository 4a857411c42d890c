"""Request/response plumbing for the online serving engine (DESIGN.md §8).

A request is one operation against the index — a single query vector, a
single insert vector, or a single external-id delete.  The engine owns
batching: callers submit individual requests and receive a `Ticket`, a
tiny future resolved when the micro-batch carrying the request completes.
"""

from __future__ import annotations

import enum
import threading
from dataclasses import dataclass, field
from typing import Any, Optional


class Op(enum.Enum):
    QUERY = "query"
    INSERT = "insert"
    DELETE = "delete"


class Ticket:
    """Completion handle for one submitted request.

    Thread-safe: `result()` blocks until the engine pumps the micro-batch
    that carries this request (with an optional timeout).  In
    single-threaded use, call `engine.drain()` first and `result()`
    returns immediately.
    """

    __slots__ = ("_event", "_value", "_error")

    def __init__(self):
        self._event = threading.Event()
        self._value: Any = None
        self._error: Optional[BaseException] = None

    @property
    def done(self) -> bool:
        return self._event.is_set()

    def _complete(self, value: Any) -> None:
        self._value = value
        self._event.set()

    def _fail(self, err: BaseException) -> None:
        self._error = err
        self._event.set()

    def result(self, timeout: Optional[float] = None) -> Any:
        if not self._event.wait(timeout):
            raise TimeoutError("request not completed; pump the engine "
                               "(engine.drain()) or raise the timeout")
        if self._error is not None:
            raise self._error
        return self._value


@dataclass
class Request:
    """One enqueued operation. `seq` is the global arrival order."""

    op: Op
    payload: Any                      # query/insert: vector; delete: ext id
    seq: int
    t_enqueue: float
    ticket: Ticket = field(default_factory=Ticket)


@dataclass(frozen=True)
class QueryResult:
    """k nearest external ids + squared distances for one query."""

    ids: Any       # np.ndarray [k]
    dists: Any     # np.ndarray [k]
