"""The port's serving engine (`repro_torch.serve`) against the
reference's, on the CPU.

Both engines take one seeded stream of independent requests on a fake
clock, over index pairs at the same built state (`torch_serve_common`):
every ticket's value, the batch log, the `ServeMetrics` counters, the
external-id maps and the final backend state agree bitwise, in strict
and relaxed order, with overlapped and synchronous consolidation, eager
deletes with compaction, heat-driven reorder and a tier policy.  Also:
no module of the port, nor `chip_smoke.py`, imports `jax` or `repro`.
"""

import ast
import pathlib

import numpy as np
import pytest
import torch

from repro import serve as ref_serve
from repro.tier import TierPolicy as RefTierPolicy
from repro_torch import serve
from repro_torch.tier import TierPolicy
from torch_serve_common import (
    JCFG,
    N_BASE,
    W,
    FakeClock,
    assert_same_state,
    built,
    ints,
    mixed_stream,
    pair,
    submit,
)

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parents[1]

#: name -> (config changes, strict order, policy fields); one stream each
CASES = {
    "strict-overlapped": ({}, True, dict(consolidate_ratio=0.05,
                                         check_every=2)),
    "relaxed-synchronous": ({}, False, dict(consolidate_ratio=0.05,
                                            check_every=2, overlap=False)),
    "relaxed-reorder": ({}, False, dict(consolidate_ratio=0.05,
                                        check_every=8, heat_budget=1)),
    "strict-eager-compact": ({"lazy_delete": False}, True,
                             dict(tombstone_ratio=0.02, check_every=1)),
    "relaxed-tier": ({"tier": True}, False,
                     dict(consolidate_ratio=None, check_every=2,
                          tier=dict(hot_frac=0.5, max_demote=64))),
}

def _engines(jcfg, strict, pol):
    pol = dict(pol)
    tier = pol.pop("tier", None)
    base = dict(tombstone_ratio=None, heat_budget=None)
    base.update(pol)
    jidx, tidx = pair(jcfg, *built(jcfg))

    def cfg(pkg, tier_cls):
        policy = pkg.MaintenancePolicy(
            **base, tier_policy=tier_cls(**tier) if tier else None)
        return pkg.ServeConfig(query_batch=W, insert_batch=W,
                               delete_batch=W, strict_order=strict,
                               maintenance=policy)

    return (ref_serve.ServeEngine(jidx, cfg(ref_serve, RefTierPolicy),
                                  clock=FakeClock()),
            serve.ServeEngine(tidx, cfg(serve, TierPolicy),
                              clock=FakeClock()))


def _same_value(a, b):
    if isinstance(a, ref_serve.QueryResult):
        assert isinstance(b, serve.QueryResult)
        np.testing.assert_array_equal(b.ids, a.ids)
        np.testing.assert_array_equal(b.dists, a.dists)
        assert b.ids.dtype == a.ids.dtype and b.dists.dtype == a.dists.dtype
    else:
        assert type(b) is type(a) and b == a


def _counters(m):
    snap = m.snapshot()
    for op in ("query", "insert", "delete"):
        snap[op].pop("ops_per_s")   # wall time, zero on a fake clock
    return snap


@pytest.mark.parametrize("case", list(CASES))
def test_engine_matches_reference_bitwise(case):
    changes, strict, pol = CASES[case]
    jcfg = JCFG._replace(**changes)
    jeng, teng = _engines(jcfg, strict, pol)
    rng = np.random.default_rng(sorted(CASES).index(case))
    for chunk in mixed_stream(rng, 192, N_BASE, jcfg.dim):
        jt = [submit(jeng, k, p) for k, p in chunk]
        tt = [submit(teng, k, p) for k, p in chunk]
        jeng.drain()
        teng.drain()
        for a, b in zip(jt, tt):
            _same_value(a.result(timeout=0), b.result(timeout=0))
    assert [(op.value, n) for op, n in teng.batch_log] \
        == [(op.value, n) for op, n in jeng.batch_log]
    assert _counters(teng.metrics) == _counters(jeng.metrics)
    np.testing.assert_array_equal(teng._int2ext, jeng._int2ext)
    np.testing.assert_array_equal(teng._ext2int, jeng._ext2int)
    assert teng._deleted_ext == jeng._deleted_ext
    assert teng._next_ext == jeng._next_ext
    assert teng.delete_noops == jeng.delete_noops
    assert_same_state(teng.backend, jeng.backend)
    # each case drives the maintenance it names
    runs = teng.metrics.maintenance_runs
    if "reorder" in case:
        assert teng.maintenance.reorders > 0
    if "compact" in case:
        assert runs["compact"] > 0
    if "tier" in case:
        assert teng.maintenance.tier_demoted > 0
    if "overlapped" in case or "synchronous" in case:
        assert runs["consolidate"] > 0


def test_background_serving_answers_every_ticket_in_time():
    """`start()`/`stop()`: the pump thread serves tickets submitted from
    the caller's thread; every wait carries a timeout."""
    jcfg = JCFG
    _, tidx = pair(jcfg, *built(jcfg))
    eng = serve.ServeEngine(tidx, serve.ServeConfig(
        query_batch=W, insert_batch=W, delete_batch=W, query_window=0.001,
        maintenance=serve.MaintenancePolicy(tombstone_ratio=None,
                                            heat_budget=None)))
    base = ints(np.random.default_rng(7), (N_BASE, jcfg.dim))
    eng.start()
    try:
        tickets = [eng.submit_query(base[i]) for i in range(20)]
        ins = eng.submit_insert(base[0] + 1)
        results = [t.result(timeout=60.0) for t in tickets]
        new_ext = ins.result(timeout=60.0)
    finally:
        eng.stop()
    assert new_ext == N_BASE
    # each query is a live row: found at distance 0 (integer rows may
    # repeat, so the id need not be its own)
    assert np.mean([r.dists[0] == 0.0 for r in results]) >= 0.9


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("where", ["src/repro_torch", "chip_smoke.py"])
def test_port_imports_neither_jax_nor_repro(where):
    root = REPO / where
    files = sorted(root.rglob("*.py")) if root.is_dir() else [root]
    assert files
    bad = [(str(f.relative_to(REPO)), m) for f in files for m in _imports(f)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, bad
