"""The port's sync sentinel (`repro_torch.core.sentinel`) on the CPU.

Every construct of the Python layer's sink set raises outside a declared
scope and passes inside one; a declared scope blesses only its own
thread.  A guarded steady state of serving over the port raises nothing,
and counts each reason the reference also declares exactly as often as
the reference does for the same stream; the reads only the port makes
come under reasons of their own, asserted here by name.
"""

import threading

import numpy as np
import pytest
import torch

from repro import serve as ref_serve
from repro.core import sentinel as ref_sentinel
from repro_torch import serve
from repro_torch.core import sentinel
from repro_torch.core.sentinel import (
    UndeclaredHostSyncError,
    declared_sync,
    forbid_undeclared_sync,
    sync_counts,
)
from torch_serve_common import JCFG, N_BASE, W, FakeClock, built, ints, pair

torch.set_num_threads(1)

#: one construct per sink, each a host read of a tensor
SINK_CASES = {
    "item": lambda x: x[0].item(),
    "tolist": lambda x: x.tolist(),
    "bool": lambda x: bool(x[2] > 0),
    "branch": lambda x: 1 if x[2] > 0 else 0,
    "int": lambda x: int(x[0]),
    "float": lambda x: float(x[1]),
    "index": lambda x: [10, 11, 12][x[1]],
    "numpy": lambda x: x.numpy(),
    "asarray": lambda x: np.asarray(x),
    "cpu": lambda x: x.cpu(),
}

#: the reads only the port makes, each under a reason of its own
PORT_ONLY = {"loop-trip exit", "greedy-descent step",
             "insert_batch host loop", "repair worker reads"}


@pytest.mark.parametrize("sink", list(SINK_CASES))
def test_sink_raises_outside_a_declared_scope_and_passes_inside(sink):
    x = torch.arange(8)
    read = SINK_CASES[sink]
    want = read(x)
    with forbid_undeclared_sync():
        with pytest.raises(UndeclaredHostSyncError):
            read(x)
        with declared_sync("test escape"):
            got = read(x)
        # device-side work needs no declaration
        y = torch.where(x > 3, x, 0).sum()
        with pytest.raises(UndeclaredHostSyncError):
            read(x)
    assert np.array_equal(np.asarray(got), np.asarray(want))
    assert int(y) == 22 and read(x) is not None     # the guard is down
    assert sync_counts().get("test escape", 0) >= 1


def test_declared_scope_blesses_only_its_own_thread():
    x = torch.arange(4)
    inside, release = threading.Event(), threading.Event()
    got = {}

    def holder():
        with declared_sync("held by another thread"):
            got["holder"] = x.tolist()
            inside.set()
            release.wait(timeout=30)

    def stray():
        try:
            x.tolist()
            got["stray"] = "read"
        except UndeclaredHostSyncError:
            got["stray"] = "raised"

    with forbid_undeclared_sync():
        t = threading.Thread(target=holder)
        t.start()
        assert inside.wait(timeout=30)
        s = threading.Thread(target=stray)   # the guard covers every thread
        s.start()
        s.join(timeout=30)
        with pytest.raises(UndeclaredHostSyncError):
            x.tolist()                       # nor is this thread blessed
        release.set()
        t.join(timeout=30)
    assert not t.is_alive() and not s.is_alive()
    assert got == {"holder": [0, 1, 2, 3], "stray": "raised"}


def test_guard_nests_and_restores_the_tensor_methods():
    before = {n: torch.Tensor.__dict__.get(n) for n in sentinel.SINKS}
    with forbid_undeclared_sync():
        with forbid_undeclared_sync():
            with pytest.raises(UndeclaredHostSyncError):
                torch.ones(2).tolist()
        with pytest.raises(UndeclaredHostSyncError):
            torch.ones(2).tolist()       # the outer guard still holds
    assert {n: torch.Tensor.__dict__.get(n) for n in sentinel.SINKS} == before
    assert torch.ones(2).tolist() == [1.0, 1.0]
    with pytest.raises(ValueError):
        with declared_sync(""):
            pass


class _Stream:
    """Mixed traffic with persistent cursors, as `test_transfer_guard.py`
    drives it: deletes always hit live external ids and never repeat."""

    def __init__(self, eng, base, fresh):
        self.eng, self.base, self.fresh = eng, base, fresh
        self.rng = np.random.default_rng(9)
        self.fi = 0
        self.next_del = 0

    def rounds(self, n):
        for r in range(n):
            for _ in range(int(self.rng.integers(1, 6))):
                self.eng.submit_query(
                    self.base[int(self.rng.integers(0, len(self.base)))])
            if r % 2 == 0:
                self.eng.submit_insert(self.fresh[self.fi % len(self.fresh)])
                self.fi += 1
            else:
                self.eng.submit_delete(self.next_del)
                self.next_del += 1
            self.eng.drain()


def test_guarded_steady_state_counts_match_the_reference():
    """The same stream through both engines: warm up unguarded until a
    consolidation has run, then serve under each package's guard.  The
    port raises nothing, launches no new kernel variant, and its count
    for every reason the reference declares equals the reference's."""
    jidx, tidx = pair(JCFG, *built(JCFG))
    rng = np.random.default_rng(0)
    base, fresh = ints(rng, (N_BASE, JCFG.dim)), ints(rng, (64, JCFG.dim))
    engines, streams = {}, {}
    for name, pkg, idx in (("ref", ref_serve, jidx), ("port", serve, tidx)):
        engines[name] = pkg.ServeEngine(idx, pkg.ServeConfig(
            query_batch=W, insert_batch=W, delete_batch=W,
            maintenance=pkg.MaintenancePolicy(
                tombstone_ratio=None, consolidate_ratio=0.02,
                heat_budget=None, check_every=2)), clock=FakeClock())
        streams[name] = _Stream(engines[name], base, fresh)
        streams[name].rounds(12)
        assert engines[name].metrics.maintenance_runs["consolidate"] > 0
    warm = tidx.trace_counts()
    before = {n: engines[n].metrics.maintenance_runs["consolidate"]
              for n in engines}

    ref_sentinel.reset_sync_counts()
    with ref_sentinel.forbid_undeclared_sync():
        streams["ref"].rounds(10)
        engines["ref"].drain()
    sentinel.reset_sync_counts()
    with forbid_undeclared_sync():
        streams["port"].rounds(10)
        engines["port"].drain()
    ref_counts, counts = ref_sentinel.sync_counts(), sync_counts()

    assert tidx.trace_counts() == warm
    for n in engines:
        assert engines[n].metrics.maintenance_runs["consolidate"] > before[n]
    assert ref_counts, "the reference's guarded phase declared nothing"
    for reason, n in ref_counts.items():
        assert counts.get(reason) == n, (reason, counts.get(reason), n)
    assert set(counts) - set(ref_counts) == PORT_ONLY, counts
    assert all(counts[r] > 0 for r in PORT_ONLY)
    # both engines served the same stream to the same end
    assert engines["port"].batch_log == [
        (serve.Op(op.value), k) for op, k in engines["ref"].batch_log]
