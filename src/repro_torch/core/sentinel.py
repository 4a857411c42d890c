"""Runtime sync sentinels on PyTorch: the counterpart of
`repro.core.sentinel` (DESIGN.md §14), with the same names.

`declared_sync(reason)` marks the places where the serving stack may
read a device value on the host; the static `tools.repro_lint` host-sync
rule asks for a ``# sync-ok: <reason>`` comment at the same points.
Inside `forbid_undeclared_sync()` any host read outside such a scope
raises `UndeclaredHostSyncError`, and every scope entered bumps a
per-reason counter (`sync_counts`), so a run can count its reads per
served request.

Two layers compose while the guard is up:

* **Python layer** — a patch of the `torch.Tensor` methods that copy a
  value to the host: ``item``, ``tolist``, ``__bool__``, ``__int__``,
  ``__float__``, ``__index__``, ``numpy`` (which ``np.asarray`` reaches
  through ``__array__``) and ``cpu``.  It is per thread, as the
  reference's is: a declared scope blesses only the thread that entered
  it.  It sees every tensor, host tensors included, so on the CPU the
  index's tensors stand in for the card's and the CPU tests see the
  sites that sync on the card.
* **CUDA layer** — ``torch.cuda.set_sync_debug_mode("error")``, which
  makes ATen raise on the syncs no Python patch sees (``nonzero``,
  boolean-mask indexing, blocking copies), as JAX's transfer guard does
  on an accelerator.  It is inert without a card.

How they compose across threads, and the gap that remains: the CUDA
setting is process-wide, not per thread.  It is "error" only while the
guard is up *and no thread holds a declared scope*; while any thread
does (the overlapped repair's worker for the whole repair, the pump
thread inside a `collect`), it is off for every thread.  In that window
an ATen-internal sync in another thread goes unseen; a read through the
Python sinks is still caught there, per thread.  The CUDA layer also
counts blocking host→device copies as syncs (it cannot tell them from
reads), so the serving path uploads its batches with
``non_blocking=True``.
"""

from __future__ import annotations

import collections
import threading
from contextlib import contextmanager
from typing import Dict, Iterator

import torch

_counts: Dict[str, int] = collections.Counter()
_lock = threading.Lock()

# forbid_undeclared_sync() state: a global depth (a guard entered in any
# thread guards every thread: the pump and repair threads read too), a
# thread-local allow depth (a declared scope blesses only its own
# thread), and the number of declared scopes open in any thread (the
# process-wide CUDA layer is off while it is above zero)
_guard_depth = 0
_open_scopes = 0
_tls = threading.local()

#: the Tensor methods that copy a value to the host
SINKS = ("item", "tolist", "__bool__", "__int__", "__float__", "__index__",
         "numpy", "cpu")

_saved: Dict[str, object] = {}
_cuda_mode = "default"


class UndeclaredHostSyncError(RuntimeError):
    """A device→host sync outside any `declared_sync` scope."""


def _allowed() -> bool:
    return getattr(_tls, "allow_depth", 0) > 0


def _set_cuda_layer() -> None:
    """Put the CUDA layer in the state the guard and the open scopes ask
    for.  Called with `_lock` held."""
    global _cuda_mode
    want = "error" if _guard_depth > 0 and _open_scopes == 0 else "default"
    if want != _cuda_mode and torch.cuda.is_available():
        torch.cuda.set_sync_debug_mode(want)
        _cuda_mode = want


@contextmanager
def declared_sync(reason: str) -> Iterator[None]:
    """Scope in which device→host reads are declared legitimate.

    `reason` is mandatory and says why the read is allowed; it keys the
    counter surfaced by `sync_counts()`.
    """
    global _open_scopes
    if not reason:
        raise ValueError("declared_sync requires a non-empty reason")
    with _lock:
        _counts[reason] += 1
        _open_scopes += 1
        if _guard_depth:
            _set_cuda_layer()
    _tls.allow_depth = getattr(_tls, "allow_depth", 0) + 1
    try:
        yield
    finally:
        _tls.allow_depth -= 1
        with _lock:
            _open_scopes -= 1
            if _guard_depth:
                _set_cuda_layer()


@contextmanager
def forbid_undeclared_sync() -> Iterator[None]:
    """Raise `UndeclaredHostSyncError` on any host read outside a
    `declared_sync` scope, for the duration of the context.

    Re-entrant; the patches go in on the first entry and come out when
    the last scope exits.
    """
    global _guard_depth
    with _lock:
        if _guard_depth == 0:
            _install()
        _guard_depth += 1
        _set_cuda_layer()
    try:
        yield
    finally:
        with _lock:
            _guard_depth -= 1
            if _guard_depth == 0:
                _remove()
            _set_cuda_layer()


def _guarded(name: str, orig):
    def guarded(self, *args, **kwargs):
        if _guard_depth > 0 and not _allowed():
            raise UndeclaredHostSyncError(
                f"`Tensor.{name}` outside declared_sync (annotate the call "
                "site with `# sync-ok: <reason>` and wrap it in "
                "repro_torch.core.sentinel.declared_sync)")
        return orig(self, *args, **kwargs)
    guarded.__name__ = name
    return guarded


def _install() -> None:
    for name in SINKS:
        # the method as defined on `torch.Tensor` itself, if it is, so
        # that `_remove` puts back exactly what was there
        _saved[name] = torch.Tensor.__dict__.get(name)
        setattr(torch.Tensor, name, _guarded(name, getattr(torch.Tensor,
                                                           name)))


def _remove() -> None:
    for name in SINKS:
        orig = _saved.pop(name)
        if orig is None:
            delattr(torch.Tensor, name)
        else:
            setattr(torch.Tensor, name, orig)


def sync_counts() -> Dict[str, int]:
    """Snapshot of {reason: times entered} since process start (or the
    last `reset_sync_counts`)."""
    with _lock:
        return dict(_counts)


def reset_sync_counts() -> None:
    with _lock:
        _counts.clear()
