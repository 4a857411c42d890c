"""Sharded search, port against reference, on the CPU.

`ShardedFlatIndex`: the port at P shards, ragged row counts so that the
last shard is padded with +inf rows, against the reference's index over
a mesh of min(P, devices) CPU devices.  The merged top-10 is the same
for every P (ties go to the lower position at both steps, so to the
lower global id), so the two agree bitwise on integer-valued rows.

`ShardedBackend` at 1, 2 and 3 shards: the port carried across from the
reference's built backend (`bridge.sharded_backend_from_numpy`) or built
with the reference's draws, each shard handed its reference shard's
level draws (`RefDraws`), then both run the same calls: search on every
route, `dispatch_search().collect()`, padded inserts, deletes with
out-of-range ids, consolidation, compaction, reordering, stats, memory,
clone, and checkpoints across the packages.  On integer-valued rows
every id, distance, report and state field stays bitwise equal.  One
reference backend per shard count serves every test (its jitted
functions belong to its shards), put back to its built state first.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import serve as ref_serve
from repro.checkpoint import ckpt as ref_ckpt
from repro.core import distributed as ref_dist
from repro.core import iostats as ref_iostats
from repro.core import lsm as ref_lsm
from repro.core.backend import SearchParams as RefParams
from repro_torch import serve
from repro_torch.bridge import (
    sharded_backend_from_numpy,
    sharded_backend_to_numpy,
)
from repro_torch.core import index as tindex
from repro_torch.core.backend import SearchParams
from repro_torch.core.distributed import ShardedBackend, ShardedFlatIndex
from repro_torch.core.index import LSMVecIndex
from torch_serve_common import (
    JCFG,
    W,
    FakeClock,
    RefDraws,
    ints,
    mixed_stream,
    submit,
    tcfg,
)

torch.set_num_threads(1)

TCFG = tcfg(JCFG)
SHARDS = (1, 2, 3)
N_BASE = 300         # every shard past BATCH_MIN_GRAPH at 3 shards
SEED = 3


# -- ShardedFlatIndex ---------------------------------------------------------

@pytest.fixture(scope="module")
def flat_world():
    rng = np.random.default_rng(4)
    return ints(rng, (1003, 16)), ints(rng, (24, 16)), {}


def _ref_flat(world, m):
    data, qs, cache = world
    if m not in cache:
        mesh = jax.sharding.Mesh(np.array(jax.devices()[:m]), ("data",))
        idx = ref_dist.ShardedFlatIndex(mesh).build(data)
        cache[m] = idx.search(qs, k=16)
    return cache[m]


@pytest.mark.parametrize("p", [1, 2, 3, 7, 8])
def test_sharded_flat_matches_reference(flat_world, p):
    data, qs, _ = flat_world
    idx = ShardedFlatIndex(p, devices=["cpu"]).build(data)
    assert idx.n_per * p - len(data) == {1: 0, 2: 1, 3: 2, 7: 5, 8: 5}[p]
    ids, dists = idx.search(qs, k=16)
    assert ids.shape == (len(qs), 10)      # the reference merges a fixed 10
    want_ids, want_d = _ref_flat(flat_world, min(p, len(jax.devices())))
    np.testing.assert_array_equal(ids, want_ids)
    np.testing.assert_array_equal(dists, want_d)
    assert ids.max() < len(data) and np.isfinite(dists).all()
    ids5, d5 = idx.search(qs, k=5)
    np.testing.assert_array_equal(ids5, ids[:, :5])
    np.testing.assert_array_equal(d5, dists[:, :5])


def test_sharded_flat_padding_sorts_last_when_rows_are_few():
    """Fewer real rows than the merge's 10 (9 rows over 5 shards, one
    padded row): every real row comes first, in (distance, id) order as
    numpy sorts it, and the padded row's NaN distance comes back as +inf
    in the last column.  (The reference's merge needs at least 10
    candidates, which its one-device mesh would not have here.)"""
    rng = np.random.default_rng(9)
    data, qs = ints(rng, (9, 16)), ints(rng, (3, 16))
    ids, dists = ShardedFlatIndex(5, devices=["cpu"]).build(data).search(qs)
    d2 = ((qs[:, None, :] - data[None]) ** 2).sum(-1)
    order = np.stack([np.lexsort((np.arange(9), row)) for row in d2])
    np.testing.assert_array_equal(ids[:, :9], order)
    np.testing.assert_array_equal(dists[:, :9],
                                  np.take_along_axis(d2, order, 1))
    assert (ids[:, 9] == 9).all() and np.isinf(dists[:, 9]).all()


# -- ShardedBackend -----------------------------------------------------------

def _jax_draws(cfg, n, seed):
    """The reference's bulk-build draws for key(seed)."""
    k_init, k_lvl = jax.random.split(jax.random.key(seed))
    proj = jax.random.normal(k_init, (cfg.m_bits, cfg.dim), jnp.float32)
    u01 = jax.random.uniform(k_lvl, (n,), jnp.float32, 1e-7, 1.0)
    return torch.from_numpy(np.array(proj)), torch.from_numpy(np.array(u01))


def _ref_numpy(jbe):
    """The reference backend as the bridge's flat dict."""
    out = {"n_shards": jbe.n_shards, "seed": jbe.seed,
           "n_routed": jbe._n_routed,
           "alloc": np.asarray(jbe._alloc, np.int64),
           "consolidations": np.asarray(jbe.consolidations, np.int64)}
    for s, sh in enumerate(jbe.shards):
        out.update({f"shard_{s:02d}/{k}": np.asarray(v)
                    for k, v in ref_lsm.dehydrate(sh.state).items()})
    return out


def assert_same_backend(tbe, jbe, io=True):
    """Every shard's state, count and (`io`) I/O statistics, and the
    routing state."""
    got, want = sharded_backend_to_numpy(tbe), _ref_numpy(jbe)
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    for a, b in zip(tbe.shards, jbe.shards):
        assert a._count == b._count
        for x, y in zip(a.io_stats, b.io_stats):
            assert not io or int(x) == int(y)


def assert_same_result(a, b, dtype=True):
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.dists, b.dists)
    assert not dtype or a.ids.dtype == b.ids.dtype


@pytest.fixture(scope="module")
def ref_backends():
    """shards -> (reference backend, its built state as numpy, a copy of
    each shard's state); the base rows."""
    base = ints(np.random.default_rng(11), (N_BASE, JCFG.dim))
    out = {}
    for n in SHARDS:
        jbe = ref_dist.ShardedBackend(
            JCFG, n, devices=[jax.devices()[0]]).build(base, seed=SEED)
        out[n] = (jbe, _ref_numpy(jbe),
                  [jax.tree.map(jnp.copy, sh.state) for sh in jbe.shards])
    return base, out


def _reset(jbe, states, built_np):
    """Put the reference backend back to its built state."""
    for s, (sh, st) in enumerate(zip(jbe.shards, states)):
        sh.state = jax.tree.map(jnp.copy, st)
        sh._rng = jax.random.key(jbe.seed + s + 1)
        sh._count = int(st.count)
        sh._version = 0
        sh._snap, sh._snap_version = None, -1
        sh.snap_patches = 0
        sh._pending_repair = sh._done_report = None
        sh.io_stats = ref_iostats.IOStats.zero()
    jbe._n_routed = int(built_np["n_routed"])
    jbe._alloc = built_np["alloc"].tolist()
    jbe.consolidations = [0] * jbe.n_shards
    jbe._claimed = {}


def _pair(ref_backends, n):
    """(reference, port) at the built state; the port's shards draw the
    reference shards' level uniforms."""
    _, backends = ref_backends
    jbe, built_np, states = backends[n]
    _reset(jbe, states, built_np)
    tbe = sharded_backend_from_numpy(TCFG, built_np, devices=["cpu"])
    _hand_draws(tbe, jbe)
    return jbe, tbe


def _hand_draws(tbe, jbe):
    for tsh, jsh in zip(tbe.shards, jbe.shards):
        tsh._uniforms = RefDraws(jsh._rng)


@pytest.mark.parametrize("n", SHARDS)
def test_build_matches_reference(ref_backends, n, monkeypatch):
    base, backends = ref_backends
    jbe, built_np, _ = backends[n]
    monkeypatch.setattr(tindex, "build_draws", _jax_draws)
    tbe = ShardedBackend(TCFG, n, devices=["cpu"]).build(base, seed=SEED)
    got = sharded_backend_to_numpy(tbe)
    assert got.keys() == built_np.keys()
    for k, v in got.items():
        if k.endswith("/mean_norm"):    # a float sum, as in test_torch_hnsw
            np.testing.assert_allclose(v, built_np[k], rtol=1e-6)
        else:
            np.testing.assert_array_equal(v, built_np[k], err_msg=k)
    np.testing.assert_array_equal(tbe.initial_ids(),
                                  np.asarray(built_np["alloc"]))
    assert tbe.cap == n * TCFG.cap and tbe.size == N_BASE


def _routes(tbe, jbe, qs):
    """Every read route: LSM probes and the snapshot (in a padded batch),
    each blocking and through the two-phase handle; and the port's fused
    route (a view of the same shards under `fused_beam`), which must
    give the snapshot route's result."""
    for kw in (dict(), dict(use_snapshot=True, pad_to=W)):
        got = tbe.search(qs, 5, params=SearchParams(**kw))
        assert_same_result(got, jbe.search(qs, 5, params=RefParams(**kw)))
        assert_same_result(
            tbe.dispatch_search(qs, 5, params=SearchParams(**kw)).collect(),
            jbe.dispatch_search(qs, 5, params=RefParams(**kw)).collect())
    fused = ShardedBackend(TCFG._replace(fused_beam=True), tbe.n_shards,
                           devices=["cpu"])
    fused._shards = [LSMVecIndex(fused.cfg, state=sh.state, device="cpu")
                     for sh in tbe.shards]
    # no heat: the view shares the shards' state
    assert_same_result(fused.search(qs, 5, params=SearchParams(
        use_snapshot=True, pad_to=W, record_heat=False)), got)


def _stats(be):
    st = dataclasses.asdict(be.stats())
    return st, be.memory_bytes(), dataclasses.asdict(be.memory_breakdown())


@pytest.mark.parametrize("n", SHARDS)
def test_backend_updates_and_maintenance_match_reference(ref_backends, n):
    jbe, tbe = _pair(ref_backends, n)
    rng = np.random.default_rng(20 + n)
    qs = ints(rng, (W - 2, JCFG.dim))     # a padded batch of the serve width
    _routes(tbe, jbe, qs)

    xs = ints(rng, (40, JCFG.dim))
    got, want = tbe.insert_batch(xs, pad_to=W), jbe.insert_batch(xs, pad_to=W)
    np.testing.assert_array_equal(got.ids, want.ids)
    assert got.n_applied == want.n_applied == 40
    assert_same_backend(tbe, jbe)

    born = tbe.initial_ids()
    dels = np.concatenate([rng.choice(born, 30, replace=False),
                           [-1, n * JCFG.cap + 5, (n - 1) * JCFG.cap
                            + JCFG.cap - 1, born[0], born[0]]])
    got, want = tbe.delete_batch(dels, pad_to=W), jbe.delete_batch(
        dels, pad_to=W)
    assert got.n_applied == want.n_applied == len(dels) - 2
    np.testing.assert_array_equal(got.ids, want.ids)
    assert _stats(tbe) == _stats(jbe)
    assert tbe.n_tombstones == jbe.n_tombstones > 0
    _routes(tbe, jbe, qs)

    for op in ("consolidate", "compact"):
        got, want = tbe.maintain(op), jbe.maintain(op)
        assert (got.applied, got.reclaimed) == (want.applied, want.reclaimed)
        assert_same_backend(tbe, jbe)
        _routes(tbe, jbe, qs)
    assert tbe.consolidations == jbe.consolidations
    assert sum(tbe.consolidations) > 0

    tbe.search(qs, 5)                     # heat for the relayout
    jbe.search(qs, 5)
    assert tbe.heat_total() == jbe.heat_total() > 0
    got, want = tbe.maintain("reorder"), jbe.maintain("reorder")
    np.testing.assert_array_equal(got.perm, want.perm)
    assert_same_backend(tbe, jbe)
    _routes(tbe, jbe, qs)
    assert _stats(tbe) == _stats(jbe)
    assert tbe.io_cost() == pytest.approx(jbe.io_cost(), rel=1e-6)

    twin = tbe.clone()                    # a clone's statistics start at 0
    assert_same_backend(twin, jbe, io=False)
    assert twin.initial_ids().tolist() == jbe.initial_ids().tolist()
    assert twin.consolidations == jbe.consolidations
    assert twin.search(qs, 5).ids.tolist() == jbe.search(qs, 5).ids.tolist()


def test_checkpoints_cross_between_the_packages(ref_backends, tmp_path):
    """The reference's checkpoint restores in the port bitwise (and the
    next inserts agree); the port's holds the same layout and arrays as
    the reference's of the same state, its generator aside; a checkpoint
    of another shard count or cap is refused by both packages."""
    jbe, tbe = _pair(ref_backends, 2)
    xs = ints(np.random.default_rng(5), (16, JCFG.dim))
    tbe.insert_batch(xs, pad_to=W)
    jbe.insert_batch(xs, pad_to=W)
    tbe.delete_batch(tbe.initial_ids()[:6])
    jbe.delete_batch(jbe.initial_ids()[:6])
    ext = np.arange(7, dtype=np.int64)
    jdir, tdir = str(tmp_path / "ref"), str(tmp_path / "port")
    jbe.save(jdir, lsn=9, extra={"ext2int": ext}, meta={"note": "x"})
    tbe.save(tdir, lsn=9, extra={"ext2int": ext}, meta={"note": "x"})

    back, meta, extras = ShardedBackend.restore(TCFG, jdir, devices=["cpu"])
    assert meta == {"note": "x", "lsn": 9}
    np.testing.assert_array_equal(extras["ext2int"], ext)
    assert_same_backend(back, jbe, io=False)
    _hand_draws(back, jbe)
    more = ints(np.random.default_rng(6), (12, JCFG.dim))
    np.testing.assert_array_equal(back.insert_batch(more, pad_to=W).ids,
                                  jbe.insert_batch(more, pad_to=W).ids)
    assert_same_backend(back, jbe, io=False)

    step = "step_00000009"
    for part in ["engine"] + [f"shard_{s:02d}" for s in range(2)]:
        a, ma, _ = ref_ckpt.load_arrays(f"{tdir}/{step}/{part}")
        b, mb, _ = ref_ckpt.load_arrays(f"{jdir}/{step}/{part}")
        assert a.keys() == b.keys() and ma == mb
        for k in a:
            if k != "rng":
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    for name in ("layout.json",):
        assert open(f"{tdir}/{step}/{name}").read() \
            == open(f"{jdir}/{step}/{name}").read()
    np.testing.assert_array_equal(np.load(f"{tdir}/{step}/alloc.npz")["alloc"],
                                  np.load(f"{jdir}/{step}/alloc.npz")["alloc"])
    own, _, _ = ShardedBackend.restore(TCFG, tdir, devices=["cpu"])
    a, b = sharded_backend_to_numpy(own), sharded_backend_to_numpy(tbe)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    for restore in (
            lambda d, **kw: ShardedBackend.restore(TCFG, d, devices=["cpu"],
                                                   **kw),
            lambda d, **kw: ref_dist.ShardedBackend.restore(JCFG, d, **kw)):
        for d in (jdir, tdir):
            with pytest.raises(ValueError, match="shards"):
                restore(d, n_shards=3)
    with pytest.raises(ValueError, match="cap/dim"):
        ShardedBackend.restore(TCFG._replace(cap=512), jdir, devices=["cpu"])


def test_one_shard_is_the_bare_index():
    """At one shard the global ids are the local ones, and every call
    gives the bare index's result."""
    rng = np.random.default_rng(8)
    base, qs = ints(rng, (200, TCFG.dim)), ints(rng, (16, TCFG.dim))
    xs = ints(rng, (24, TCFG.dim))
    bare = LSMVecIndex.build(TCFG, base, seed=SEED, device="cpu")
    be = ShardedBackend(TCFG, 1, devices=["cpu"]).build(base, seed=SEED)
    np.testing.assert_array_equal(be.initial_ids(), bare.initial_ids())
    for index in (bare, be):
        index.insert_batch(xs, pad_to=W)
        index.delete_batch(np.arange(0, 200, 9), pad_to=W)
    # (global ids are int64, the bare index's int32)
    for kw in (dict(), dict(use_snapshot=True)):
        assert_same_result(be.search(qs, params=SearchParams(**kw)),
                           bare.search(qs, params=SearchParams(**kw)), False)
    assert be.maintain("consolidate").reclaimed \
        == bare.maintain("consolidate").reclaimed > 0
    perm, bare_perm = be.maintain("reorder").perm, \
        bare.maintain("reorder").perm
    np.testing.assert_array_equal(perm[:len(bare_perm)], bare_perm)
    np.testing.assert_array_equal(perm[len(bare_perm):], np.arange(
        len(bare_perm), TCFG.cap))
    assert_same_result(be.search(qs), bare.search(qs), False)
    assert dataclasses.asdict(be.stats()) == dataclasses.asdict(bare.stats())


def test_serve_stream_over_two_shards_matches_reference(ref_backends):
    """One `ServeEngine` stream (queries, inserts, deletes of live ids,
    overlapped consolidations) over a 2-shard backend: every ticket, the
    batch log, the id maps and the final state bitwise in both
    packages."""
    jbe, tbe = _pair(ref_backends, 2)

    def cfg(pkg):
        policy = pkg.MaintenancePolicy(
            tombstone_ratio=None, heat_budget=None, consolidate_ratio=0.05,
            check_every=2)
        return pkg.ServeConfig(query_batch=W, insert_batch=W,
                               delete_batch=W, strict_order=True,
                               maintenance=policy)

    jeng = ref_serve.ServeEngine(jbe, cfg(ref_serve), clock=FakeClock())
    teng = serve.ServeEngine(tbe, cfg(serve), clock=FakeClock())
    for chunk in mixed_stream(np.random.default_rng(12), 144, N_BASE,
                              JCFG.dim):
        jt = [submit(jeng, k, p) for k, p in chunk]
        tt = [submit(teng, k, p) for k, p in chunk]
        jeng.drain()
        teng.drain()
        for a, b in zip(jt, tt):
            a, b = a.result(timeout=0), b.result(timeout=0)
            if isinstance(a, ref_serve.QueryResult):
                np.testing.assert_array_equal(b.ids, a.ids)
                np.testing.assert_array_equal(b.dists, a.dists)
            else:
                assert b == a
    assert [(op.value, m) for op, m in teng.batch_log] \
        == [(op.value, m) for op, m in jeng.batch_log]
    assert teng.metrics.maintenance_runs["consolidate"] \
        == jeng.metrics.maintenance_runs["consolidate"] > 0
    np.testing.assert_array_equal(teng._int2ext, jeng._int2ext)
    np.testing.assert_array_equal(teng._ext2int, jeng._ext2int)
    assert_same_backend(tbe, jbe)
