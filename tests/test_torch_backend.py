"""The port's `VectorBackend` surface against the reference, at d=65.

Both packages start from the reference's built state (carried across by
the bridge) and are handed the reference's level draws.  On
integer-valued vectors, bitwise: the snapshot `insert_batch` patches
(against the reference's and against a fresh resolve), `stats` and
`memory_breakdown` on tiered and untiered lanes, `lsm.dehydrate`'s keys
and shapes, and a consolidation begun with `begin_maintain`, claimed
with `poll_maintain` or finished by a mutation's write barrier.

One reference index serves the module: each test puts the built state
back into it (`fresh`), so every reference function compiles once.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import backend as ref_backend
from repro.core import hnsw as jax_hnsw
from repro.core import index as ref
from repro.core import iostats as ref_iostats
from repro.core import lsm as ref_lsm
from repro.core.backend import SearchParams as RefParams
from repro_torch.bridge import hnsw_state_from_numpy, hnsw_state_to_numpy
from repro_torch.core import backend, hnsw, iostats, lsm
from repro_torch.core.backend import SearchParams
from repro_torch.core.index import LSMVecIndex
from repro_torch.kernels import _build

torch.set_num_threads(1)

JCFG = jax_hnsw.HNSWConfig(cap=512, dim=65, M=8, M_up=4, num_upper=2,
                           ef_search=16, ef_construction=16, k=5,
                           lsm_mem_cap=64, lsm_levels=2, lsm_fanout=8)
TCFG = hnsw.HNSWConfig(**{f: getattr(JCFG, f)
                          for f in hnsw.HNSWConfig._fields})
N_BASE = 80          # past BATCH_MIN_GRAPH: no seeding inserts
PAD = 24


def _ints(rng, shape):
    return rng.integers(-3, 4, shape).astype(np.float32)


def _ref_draws(jidx, n_items, pad_to):
    """The level uniforms the reference index draws for an insert_batch
    of n_items (no seeding inserts) padded to `pad_to`, one array per
    chunk."""
    rng = jidx._rng
    draws = []
    for _ in range(0, n_items, pad_to):
        rng, sub = jax.random.split(rng)
        keys = jax.random.split(sub, pad_to)
        draws.append(np.array(jax.vmap(lambda kk: jax.random.uniform(
            kk, (), jnp.float32, 1e-7, 1.0))(keys)))
    return draws


def _feed(tidx, draws):
    """Hand the port index the reference's draws, in order."""
    draws = list(draws)
    tidx._uniforms = lambda n: torch.from_numpy(draws.pop(0))


def _np_state(jidx):
    return {k: np.asarray(v) for k, v in ref_lsm.dehydrate(jidx.state).items()}


def assert_same_state(tidx, jidx):
    got = hnsw_state_to_numpy(tidx.state)
    want = _np_state(jidx)
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert tidx._count == jidx._count


def assert_same_tindex(a, b):
    """Two port indexes hold the same state, bitwise."""
    sa, sb = lsm.dehydrate(a.state), lsm.dehydrate(b.state)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
    assert a._count == b._count


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(7)
    base = _ints(rng, (N_BASE, JCFG.dim))
    jidx = ref.LSMVecIndex.build(JCFG, base, seed=0)
    return jidx, _np_state(jidx), jax.tree.map(jnp.copy, jidx.state)


@pytest.fixture
def fresh(built):
    """(port index, reference index), both at the built state."""
    jidx, np_state, jstate = built
    jidx.state = jax.tree.map(jnp.copy, jstate)
    jidx._rng = jax.random.key(1)
    jidx._count = N_BASE
    jidx._version = 0
    jidx._snap, jidx._snap_version = None, -1
    jidx.snap_patches = 0
    jidx._pending_repair = jidx._done_report = None
    jidx.io_stats = ref_iostats.IOStats.zero()
    tidx = LSMVecIndex(TCFG, state=hnsw_state_from_numpy(np_state, "cpu"),
                       device="cpu")
    return tidx, jidx


def _snap_search(tidx, jidx, qs):
    p = SearchParams(use_snapshot=True)
    got = tidx.search(qs, params=p)
    want = jidx.search(qs, params=RefParams(use_snapshot=True))
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.dists, want.dists)


@pytest.mark.parametrize("n_items", [PAD, 3 * PAD - 5])
def test_insert_batch_patches_the_snapshot_like_the_reference(fresh, n_items):
    """After one and after several padded chunks: the patched snapshot
    equals the reference's patched one and a fresh resolve, and the next
    snapshot search reads it without re-resolving."""
    tidx, jidx = fresh
    rng = np.random.default_rng(n_items)
    qs = _ints(rng, (6, JCFG.dim))
    _snap_search(tidx, jidx, qs)
    assert not tidx.snapshot_stale and not jidx.snapshot_stale
    for step in range(2):
        xs = _ints(rng, (n_items, JCFG.dim))
        _feed(tidx, _ref_draws(jidx, n_items, PAD))
        np.testing.assert_array_equal(tidx.insert_batch(xs, pad_to=PAD).ids,
                                      jidx.insert_batch(xs, pad_to=PAD).ids)
        assert tidx.snap_patches == jidx.snap_patches \
            == (step + 1) * -(-n_items // PAD)
        assert not tidx.snapshot_stale and not jidx.snapshot_stale
        np.testing.assert_array_equal(tidx._snap.numpy(),
                                      np.asarray(jidx._snap))
        fresh_rows = lsm.snapshot_rows(TCFG.lsm_cfg, tidx.state.store,
                                       TCFG.cap)
        assert torch.equal(tidx._snap, fresh_rows)
        assert_same_state(tidx, jidx)
        snap = tidx._snap
        _snap_search(tidx, jidx, qs)
        assert tidx._snap is snap


def test_stale_snapshot_is_resolved_not_patched(fresh):
    """With no fresh snapshot an insert_batch patches nothing; a graph
    write (compaction) makes the snapshot stale again."""
    tidx, jidx = fresh
    rng = np.random.default_rng(3)
    xs = _ints(rng, (PAD, JCFG.dim))
    _feed(tidx, _ref_draws(jidx, PAD, PAD))
    tidx.insert_batch(xs, pad_to=PAD)
    jidx.insert_batch(xs, pad_to=PAD)
    assert tidx.snap_patches == jidx.snap_patches == 0
    assert tidx.snapshot_stale and jidx.snapshot_stale
    _snap_search(tidx, jidx, _ints(rng, (4, JCFG.dim)))
    assert not tidx.snapshot_stale
    tidx.maintain("compact")
    assert tidx.snapshot_stale


@pytest.mark.parametrize("tier", [False, True])
def test_stats_and_memory_breakdown_match_reference(fresh, tier):
    tidx, jidx = fresh
    rng = np.random.default_rng(11)
    dels = np.concatenate([rng.choice(N_BASE, 9, replace=False), [3, 3]])
    tidx.delete_batch(dels)
    jidx.delete_batch(dels)
    if tier:
        # a cold lane on both: memory accounting reads only the lanes
        cold = np.zeros(JCFG.cap, bool)
        cold[:N_BASE:3] = True
        tidx.state = tidx.state._replace(
            hot=tidx.state.hot & ~torch.from_numpy(cold))
        jidx.state = jidx.state._replace(
            hot=jidx.state.hot & ~jnp.asarray(cold))
    tv = LSMVecIndex(TCFG._replace(tier=tier), state=tidx.state, device="cpu")
    jv = ref.LSMVecIndex(JCFG._replace(tier=tier), state=jidx.state)
    got, want = tv.stats(), jv.stats()
    assert got.memory.as_dict() == want.memory.as_dict()
    assert (got.size, got.n_tombstones, got.delete_noops,
            got.max_tombstone_ratio) == (want.size, want.n_tombstones,
                                         want.delete_noops,
                                         want.max_tombstone_ratio)
    assert got.shards[0].__dict__ == want.shards[0].__dict__
    assert got.delete_noops > 0
    assert got.n_tombstones == len(np.unique(dels))
    assert (got.memory.n_cold > 0) == tier
    assert tv.memory_breakdown().as_dict() == jv.memory_breakdown().as_dict()
    assert tv.memory_bytes() == jv.memory_bytes() \
        == hnsw.memory_resident_bytes(TCFG._replace(tier=tier), tv.state)


def test_dehydrate_keys_and_shapes_match_reference(fresh):
    tidx, jidx = fresh
    got = lsm.dehydrate(tidx.state, "state")
    want = ref_lsm.dehydrate(jidx.state, "state")
    assert list(got) == list(want)
    assert all(tuple(got[k].shape) == tuple(want[k].shape) for k in got)
    back = lsm.hydrate(tidx.state, got, "state")
    assert all(a is b for a, b in zip(lsm.dehydrate(back).values(),
                                      lsm.dehydrate(tidx.state).values()))
    with pytest.raises(KeyError):
        lsm.hydrate(tidx.state, {k: v for k, v in got.items()
                                 if k != "state/store/level_keys/1"}, "state")


def _delete_some(tidx, jidx, seed, n=12):
    dels = np.random.default_rng(seed).choice(N_BASE, n, replace=False)
    tidx.delete_batch(dels)
    jidx.delete_batch(dels)
    return dels


def test_overlapped_consolidation_matches_sync_and_reference(fresh):
    tidx, jidx = fresh
    assert not tidx.begin_maintain("consolidate")      # nothing to reclaim
    assert tidx.poll_maintain() is None
    dels = _delete_some(tidx, jidx, 5)
    sync = tidx.clone()
    assert not tidx.begin_maintain("compact")
    assert not tidx.begin_maintain("consolidate", ratio=0.5)
    assert tidx.begin_maintain("consolidate")
    assert tidx.maintenance_pending
    assert not tidx.begin_maintain("consolidate")      # one in flight
    assert jidx.begin_maintain("consolidate")
    rep = tidx.poll_maintain(block=True)
    want = jidx.poll_maintain(block=True)
    assert rep is not None and want is not None
    assert (rep.op, rep.applied, rep.reclaimed, rep.detail) == (
        want.op, want.applied, want.reclaimed, want.detail)
    assert rep.reclaimed == len(dels)
    assert not tidx.maintenance_pending and tidx.poll_maintain() is None
    sync_rep = sync.maintain("consolidate")
    assert sync_rep.reclaimed == rep.reclaimed
    assert_same_tindex(tidx, sync)
    assert_same_state(tidx, jidx)
    for a, b in zip(tidx.io_stats, jidx.io_stats):
        assert int(a) == int(b)
    assert tidx.snapshot_stale
    _snap_search(tidx, jidx, _ints(np.random.default_rng(0), (5, JCFG.dim)))


@pytest.mark.parametrize("mutation", ["delete_batch", "insert_batch"])
def test_mutation_mid_repair_lands_after_the_cutover(fresh, mutation):
    """The write barrier: a mutation issued while a repair is in flight
    finishes the repair first, then applies to the repaired state; the
    stashed report is claimed once, then nothing."""
    tidx, jidx = fresh
    dels = _delete_some(tidx, jidx, 8)
    sync = tidx.clone()
    rng = np.random.default_rng(9)
    if mutation == "insert_batch":
        xs = _ints(rng, (PAD, JCFG.dim))
        draws = _ref_draws(jidx, PAD, PAD)
        _feed(tidx, draws)
        _feed(sync, draws)
        args = (xs,)
    else:
        # ids still live: had they landed before the cutover, the repaired
        # state would have dropped their tombstones
        args = (np.concatenate([np.setdiff1d(np.arange(N_BASE), dels)[::9],
                                [-1]]),)
    assert tidx.begin_maintain("consolidate")
    assert jidx.begin_maintain("consolidate")
    got = getattr(tidx, mutation)(*args, pad_to=PAD)
    want = getattr(jidx, mutation)(*args, pad_to=PAD)
    np.testing.assert_array_equal(got.ids, want.ids)
    assert tidx._pending_repair is None and tidx.maintenance_pending
    sync.maintain("consolidate")
    getattr(sync, mutation)(*args, pad_to=PAD)
    assert_same_tindex(tidx, sync)
    assert_same_state(tidx, jidx)
    if mutation == "delete_batch":
        assert tidx.n_tombstones == int((args[0] >= 0).sum())
    rep = tidx.poll_maintain()
    want_rep = jidx.poll_maintain()
    assert rep is not None and want_rep is not None
    assert rep.detail == {"overlapped": True} and rep.applied
    assert rep.reclaimed == want_rep.reclaimed == len(dels)
    assert tidx.poll_maintain() is None and jidx.poll_maintain() is None
    assert not tidx.maintenance_pending


def test_maintain_claims_a_repair_a_barrier_finished(fresh):
    tidx, _ = fresh
    dels = np.arange(0, 40, 5)
    tidx.delete_batch(dels)
    assert tidx.begin_maintain("consolidate")
    tidx.delete_batch([41])
    rep = tidx.maintain("consolidate")
    assert rep.detail == {"overlapped": True}
    assert rep.reclaimed == len(dels)
    assert tidx.n_tombstones == 1
    assert tidx.maintain("consolidate").reclaimed == 1
    assert not tidx.maintenance_pending


def test_protocol_surface_and_accounting_match_reference(fresh):
    tidx, jidx = fresh
    names = {n for n in dir(ref_backend.VectorBackend) if not n.startswith("_")}
    assert names == {n for n in dir(backend.VectorBackend)
                     if not n.startswith("_")}
    assert len(names) == 18
    assert all(hasattr(tidx, n) for n in names)
    assert isinstance(tidx, backend.VectorBackend)
    qs = _ints(np.random.default_rng(2), (7, JCFG.dim))
    handle = tidx.dispatch_search(qs)
    assert isinstance(handle, backend.SearchHandle) and handle.is_ready()
    handle.collect()
    jidx.search(qs)
    _snap_search(tidx, jidx, qs)
    assert tidx.heat_total() == jidx.heat_total() > 0
    np.testing.assert_array_equal(tidx.initial_ids(), jidx.initial_ids())
    assert tidx.io_cost() == pytest.approx(jidx.io_cost(), rel=1e-6)
    assert set(tidx.trace_counts()) == set(jidx.trace_counts())
    # the CPU launches no kernel: no variant is ever taken here
    assert set(tidx.trace_counts().values()) == {0}
    tidx.reset_heat()
    jidx.reset_heat()
    assert tidx.heat_total() == jidx.heat_total() == 0
    tidx.reset_stats()
    assert tidx.io_cost() == 0.0
    assert_same_state(tidx, jidx)
    model = iostats.h100_hbm_model(JCFG.dim, JCFG.M)
    assert tuple(model) == tuple(ref_iostats.tpu_hbm_model(
        JCFG.dim, JCFG.M, bw_bytes=3.35e12))


def test_merge_topk_and_shard_routing_match_reference():
    rng = np.random.default_rng(4)
    gids = [rng.integers(-1, 100, (6, 5)) for _ in range(3)]
    dists = [np.sort(rng.integers(0, 9, (6, 5)).astype(np.float32), 1)
             for _ in range(3)]
    got = backend.merge_topk(gids, dists, 7)
    want = ref_backend.merge_topk(gids, dists, 7)
    np.testing.assert_array_equal(got.ids, want.ids)
    np.testing.assert_array_equal(got.dists, want.dists)
    seq = np.arange(1000)
    for n in (1, 2, 5):
        np.testing.assert_array_equal(backend.shard_of_seq(seq, n),
                                      ref_backend.shard_of_seq(seq, n))
        assert backend.shard_of_seq(17, n) == ref_backend.shard_of_seq(17, n)


def test_variants_collect_per_thread_and_per_scope():
    outer, inner, other = set(), set(), set()
    _build.taken("gather_l2", "pair")               # no scope open: dropped
    with _build.variants(outer):
        _build.taken("gather_l2", "pair")
        with _build.variants(inner):
            _build.taken("beam")

        def work():
            with _build.variants(other):
                _build.taken("l2_distance", "flat")
            _build.taken("simhash_encode")          # no scope in this thread

        t = threading.Thread(target=work)
        t.start()
        t.join()
        _build.taken("gather_l2", "chunk")
    assert outer == {("gather_l2", "pair"), ("gather_l2", "chunk")}
    assert inner == {("beam", "")}
    assert other == {("l2_distance", "flat")}


def test_restore_and_clone_need_a_card_unless_asked_for_the_cpu(
        fresh, monkeypatch, tmp_path):
    tidx, _ = fresh
    tidx.save(str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        LSMVecIndex.restore(TCFG, str(tmp_path))
    idx, _, _ = LSMVecIndex.restore(TCFG, str(tmp_path), device="cpu")
    assert idx.device.type == "cpu" and idx.clone().device.type == "cpu"
