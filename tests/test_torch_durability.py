"""Durability of the port's serving engine on the CPU (DESIGN.md §11):
recovery from a checkpoint and the WAL tail is bitwise, acks imply
durability, group commit defers acks, a checkpoint truncates the WAL it
covers, and the four-point crash matrix loses no acknowledged write
(`repro_torch.ft`)."""

import os

import numpy as np
import pytest
import torch

from repro_torch.checkpoint import latest_step
from repro_torch.core import hnsw, lsm
from repro_torch.core.index import LSMVecIndex
from repro_torch.ft import (
    FailureInjector,
    RestartPolicy,
    SimulatedFailure,
    run_with_recovery,
    run_with_restarts,
    verify_acked_writes,
)
from repro_torch.serve import (
    MaintenancePolicy,
    ServeConfig,
    ServeEngine,
    WalConfig,
)

torch.set_num_threads(1)

CFG = hnsw.HNSWConfig(cap=1024, dim=16, M=8, M_up=4, num_upper=2,
                      ef_search=32, ef_construction=32, k=10,
                      rho=1.0, use_filter=False, lsm_mem_cap=64,
                      lsm_levels=2, lsm_fanout=8)


def _vecs(n, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, CFG.dim)).astype(np.float32)


def _same_state(a, b):
    sa, sb = lsm.dehydrate(a.state), lsm.dehydrate(b.state)
    assert sa.keys() == sb.keys()
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert a._count == b._count


def _serve_cfg(tmp_path, **kw):
    maint = kw.pop("maintenance", MaintenancePolicy(checkpoint_every=4))
    return ServeConfig(
        query_batch=8, insert_batch=8, delete_batch=8,
        adaptive_windows=False, query_window=0.0, insert_window=0.0,
        delete_window=0.0,
        wal=WalConfig(dir=str(tmp_path / "wal"), **kw),
        ckpt_dir=str(tmp_path / "ckpt"), maintenance=maint)


def _fresh():
    return LSMVecIndex(CFG, seed=1, device="cpu")


def _restore(d):
    return LSMVecIndex.restore(CFG, d, device="cpu")


def _recover(tmp_path, injector=None, **kw):
    return ServeEngine.recover(_serve_cfg(tmp_path, **kw),
                               fresh_backend=_fresh,
                               restore_backend=_restore, injector=injector)


def _mixed_ops(n, seed=0):
    rng = np.random.default_rng(seed)
    ops, n_ins = [], 0
    for _ in range(n):
        r = rng.random()
        if r < 0.7 or n_ins < 5:
            ops.append(("insert", rng.standard_normal(CFG.dim)
                        .astype(np.float32)))
            n_ins += 1
        elif r < 0.85:
            ops.append(("delete", int(rng.integers(0, n_ins))))
        else:
            ops.append(("query", rng.standard_normal(CFG.dim)
                        .astype(np.float32)))
    return ops


def test_engine_recovery_is_bit_exact_without_crash(tmp_path):
    """An engine rebuilt from its checkpoint and WAL tail holds the state
    of the one it replaced, bitwise, and the same id maps."""
    eng = _recover(tmp_path)
    ids = [eng.submit_insert(x) for x in _vecs(90, seed=2)]
    for e in range(0, 10):
        eng.submit_delete(e)
    eng.drain()
    assert all(t.done for t in ids)
    assert eng.metrics.maintenance_runs["checkpoint"] >= 1

    eng2 = _recover(tmp_path)       # a process restart, the old WAL left
    _same_state(eng.backend, eng2.backend)
    np.testing.assert_array_equal(eng._int2ext, eng2._int2ext)
    np.testing.assert_array_equal(eng._ext2int, eng2._ext2int)
    assert eng._deleted_ext == eng2._deleted_ext
    assert eng._next_ext == eng2._next_ext
    # and the two go on alike
    xs = _vecs(8, seed=3)
    for e in (eng, eng2):
        for x in xs:
            e.submit_insert(x)
        e.drain()
    _same_state(eng.backend, eng2.backend)


def test_ack_implies_durable_replay(tmp_path):
    """Every resolved write ticket survives a crash with no checkpoint at
    all: pure WAL replay from LSN 0."""
    cfg = _serve_cfg(tmp_path,
                     maintenance=MaintenancePolicy(checkpoint_every=None))
    eng = ServeEngine.recover(cfg, fresh_backend=_fresh,
                              restore_backend=_restore)
    tickets = [eng.submit_insert(x) for x in _vecs(80, seed=4)]
    del_t = eng.submit_delete(3)
    eng.drain()
    exts = [t.result(timeout=0) for t in tickets]
    assert del_t.result(timeout=0) is True

    eng2 = ServeEngine.recover(cfg, fresh_backend=_fresh,
                               restore_backend=_restore)
    for e in exts:
        if e != 3:
            assert eng2.resolve_ext(e) >= 0
    assert eng2.is_deleted(3)
    _same_state(eng.backend, eng2.backend)


def test_group_commit_defers_acks_until_sync(tmp_path):
    cfg = _serve_cfg(tmp_path, group_commit_n=100,
                     maintenance=MaintenancePolicy(checkpoint_every=None))
    eng = ServeEngine(_fresh(), cfg)
    tickets = [eng.submit_insert(x) for x in _vecs(8, seed=6)]
    eng.pump(force=True)
    # the batch ran but the commit threshold was not reached: no ack may
    # come before its fsync
    assert not any(t.done for t in tickets)
    assert eng.wal.n_unsynced == 1
    eng.drain()
    assert all(t.done for t in tickets)
    assert eng.wal.n_unsynced == 0
    assert eng.metrics.wal_commits == 1 and eng.metrics.wal_records == 1
    eng.close()


def test_checkpoint_truncates_covered_wal(tmp_path):
    eng = _recover(tmp_path, maintenance=MaintenancePolicy(
        checkpoint_every=None), segment_bytes=512)
    for x in _vecs(72, seed=8):
        eng.submit_insert(x)
    eng.drain()
    n_before = len(os.listdir(tmp_path / "wal"))
    assert n_before > 2
    path = eng.checkpoint()
    assert path is not None and os.path.isdir(path)
    assert eng._covering_lsn == eng.wal.last_lsn
    assert len(os.listdir(tmp_path / "wal")) < n_before
    # no surviving record is covered by the checkpoint
    assert eng.wal.records(after=eng._covering_lsn) == eng.wal.records()
    eng.close()
    eng2 = _recover(tmp_path, maintenance=MaintenancePolicy(
        checkpoint_every=None), segment_bytes=512)
    assert eng2.wal.last_lsn == eng._covering_lsn
    _same_state(eng.backend, eng2.backend)


def test_acked_writes_survive_double_restart_after_covering_ckpt(tmp_path):
    """Once a checkpoint covers LSN N and only the empty tail segment is
    left, two restarts in a row must not reset LSN allocation."""
    eng = _recover(tmp_path)
    for x in _vecs(16, seed=20):
        eng.submit_insert(x)
    eng.drain()
    assert eng.checkpoint() is not None or eng._has_ckpt
    covering = eng._covering_lsn
    eng.close()
    eng2 = _recover(tmp_path)
    assert eng2.wal.last_lsn == covering
    eng2.close()
    eng3 = _recover(tmp_path)
    assert eng3.wal.last_lsn == covering
    tickets = [eng3.submit_insert(x) for x in _vecs(8, seed=21)]
    eng3.drain()
    exts = [t.result(timeout=0) for t in tickets]
    eng3.close()
    eng4 = _recover(tmp_path)
    for e in exts:
        assert eng4.resolve_ext(e) >= 0, f"acked insert ext={e} lost"
    eng4.close()


class _FlakyBackend:
    """The port's index, whose first insert dispatch raises after the
    engine has logged the batch."""

    def __init__(self, inner):
        self._inner = inner
        self._fail = True

    def insert_batch(self, *a, **kw):
        if self._fail:
            self._fail = False
            raise RuntimeError("injected dispatch failure")
        return self._inner.insert_batch(*a, **kw)

    def __getattr__(self, name):
        return getattr(self._inner, name)


def test_failed_insert_dispatch_burns_logged_ext_ids(tmp_path):
    cfg = _serve_cfg(tmp_path,
                     maintenance=MaintenancePolicy(checkpoint_every=None))
    eng = ServeEngine(_FlakyBackend(_fresh()), cfg)
    bad = [eng.submit_insert(x) for x in _vecs(8, seed=30)]
    with pytest.raises(RuntimeError, match="injected"):
        eng.drain()
    for t in bad:
        with pytest.raises(RuntimeError):
            t.result(timeout=0)
    good = [eng.submit_insert(x) for x in _vecs(8, seed=31)]
    eng.drain()
    exts = [t.result(timeout=0) for t in good]
    assert min(exts) >= 8            # ids 0..7 burned with the orphan
    eng.close()
    eng2 = _recover(tmp_path,
                    maintenance=MaintenancePolicy(checkpoint_every=None))
    for e in exts:
        assert eng2.resolve_ext(e) >= 0
    eng2.close()


def test_no_wal_checkpoint_seq_resumes_after_recovery(tmp_path):
    cfg = ServeConfig(
        query_batch=8, insert_batch=8, delete_batch=8,
        adaptive_windows=False, query_window=0.0, insert_window=0.0,
        delete_window=0.0, wal=None, ckpt_dir=str(tmp_path / "ckpt"),
        maintenance=MaintenancePolicy(checkpoint_every=None))
    eng = ServeEngine(_fresh(), cfg)
    for x in _vecs(8, seed=40):
        eng.submit_insert(x)
    eng.drain()
    eng.checkpoint()
    eng.checkpoint()
    assert latest_step(cfg.ckpt_dir) == 2
    eng2 = ServeEngine.recover(cfg, fresh_backend=_fresh,
                               restore_backend=_restore)
    for x in _vecs(8, seed=41):
        eng2.submit_insert(x)
    eng2.drain()
    eng2.checkpoint()
    assert latest_step(cfg.ckpt_dir) == 3


@pytest.mark.parametrize("point,hit", [
    ("pre_commit", 3),
    ("post_commit_pre_apply", 3),
    ("mid_checkpoint", 2),
    ("mid_consolidation", 1),
])
def test_crash_recovery_matrix_zero_acked_loss(tmp_path, point, hit):
    """Kill at each injection point, restart, and show that every
    acknowledged ticket survives, by id map and by search."""
    maint = MaintenancePolicy(checkpoint_every=4)
    if point == "mid_consolidation":
        maint = MaintenancePolicy(checkpoint_every=4, check_every=2,
                                  consolidate_ratio=0.05)
    policy = RestartPolicy(ckpt_dir=str(tmp_path / "ckpt"),
                           wal_dir=str(tmp_path / "wal"), max_restarts=5)
    injector = FailureInjector(fail_points={point: hit})
    ops = _mixed_ops(90, seed=3)
    out = run_with_recovery(
        policy=policy,
        make_engine=lambda inj: _recover(tmp_path, injector=inj,
                                         maintenance=maint),
        ops=ops, injector=injector, chunk=10)
    assert out["restarts"] >= 1, f"{point} never fired"
    summary = verify_acked_writes(out["engine"], ops, out["acked"])
    assert summary["live"] == summary["searched"] > 0


def test_run_with_restarts_resumes_from_the_port_checkpoint(tmp_path):
    policy = RestartPolicy(ckpt_dir=str(tmp_path), ckpt_every=3)

    def step(state, i):
        return {"w": state["w"] + i}

    out = run_with_restarts(
        policy=policy, init_state=lambda: {"w": torch.zeros(4)},
        step_fn=step, num_steps=8,
        injector=FailureInjector(fail_at=[5]))
    assert out["restarts"] == 1 and out["resumed_from"] == [3]
    assert torch.equal(out["state"]["w"], torch.full((4,), 28.0))
    with pytest.raises(ValueError, match="ckpt_dir"):
        run_with_restarts(policy=RestartPolicy(), init_state=lambda: 0,
                          step_fn=lambda s, i: s, num_steps=1)
    with pytest.raises(SimulatedFailure):
        FailureInjector(fail_points={"pre_commit": 1}).at("pre_commit")
