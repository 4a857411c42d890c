"""Major compaction and connectivity-aware reordering (§3.4), port
against reference: `gorder_permutation` (exact), `layout_score`,
`block_io_count`, `apply_permutation`, `lsm.compact_all` /
`lsm.remap_ids`, and the index's `maintain("compact")` /
`maintain("reorder")` followed by searches.

The placement is host numpy with the reference's arithmetic, so the
permutation is the reference's exactly; the relayout and the tree
rewrite are bitwise; on integer-valued vectors the searches after them
are too, and return the renamed ids of the searches before.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hnsw as ref_hnsw
from repro.core import index as ref_index
from repro.core import lsm as ref_lsm
from repro.core import reorder as ref
from repro.core.backend import SearchParams as RefParams
from repro_torch.bridge import (
    hnsw_state_from_numpy,
    hnsw_state_to_numpy,
    lsm_state_from_numpy,
    lsm_state_to_numpy,
)
from repro_torch.core import hnsw, lsm, reorder
from repro_torch.core.backend import SearchParams
from repro_torch.core.index import LSMVecIndex

torch.set_num_threads(1)

JCFG = ref_hnsw.HNSWConfig(cap=512, dim=65, M=8, M_up=4, num_upper=2,
                           ef_search=16, ef_construction=16, k=5,
                           lsm_mem_cap=64, lsm_levels=2, lsm_fanout=8)
TCFG = hnsw.HNSWConfig(**{f: getattr(JCFG, f)
                          for f in hnsw.HNSWConfig._fields})


def _np(st):
    return {k: np.asarray(v) for k, v in ref_lsm.dehydrate(st).items()}


def _ints(rng, shape):
    return rng.integers(-3, 4, shape).astype(np.float32)


@pytest.mark.parametrize("n,m,window,lam,dead", [
    (64, 4, 4, 1.0, 0), (200, 8, 8, 1.0, 17), (150, 6, 3, 4.0, 40),
    (1, 4, 8, 1.0, 0), (30, 5, 8, 0.0, 30)])
def test_gorder_layout_and_block_io_match_reference(n, m, window, lam, dead):
    rng = np.random.default_rng(n + dead)
    rows = rng.integers(-1, n, (n, m)).astype(np.int32)
    heat = rng.integers(0, 20, (n, m)).astype(np.int32)
    live = np.ones(n, bool)
    live[rng.choice(n, dead, replace=False)] = False
    want = ref.gorder_permutation(rows, heat, window=window, lam=lam,
                                  live=live)
    got = reorder.gorder_permutation(rows, heat, window=window, lam=lam,
                                     live=live)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert sorted(got.tolist()) == list(range(n))
    assert (got[~live] >= live.sum()).all()
    np.testing.assert_array_equal(
        reorder.gorder_permutation(rows, window=window),
        ref.gorder_permutation(rows, window=window))
    for perm in (np.arange(n, dtype=np.int32), got):
        assert reorder.layout_score(rows, perm, heat, window=window,
                                    lam=lam) == ref.layout_score(
            rows, perm, heat, window=window, lam=lam)
    seqs = [rng.integers(0, n, rng.integers(0, 9)) for _ in range(25)]
    assert reorder.block_io_count(seqs, got, block_rows=4) == \
        ref.block_io_count(seqs, got, block_rows=4)


def test_gorder_raises_the_layout_score_of_a_shuffled_ring():
    n = 48
    shuffle = np.random.default_rng(1).permutation(n)
    inv = np.argsort(shuffle)
    rows = np.stack([(np.arange(n) + 1) % n, (np.arange(n) - 1) % n], 1)
    rows = inv[rows[shuffle]].astype(np.int32)
    perm = reorder.gorder_permutation(rows, window=4)
    assert reorder.layout_score(rows, perm, window=4) > 1.5 * \
        reorder.layout_score(rows, np.arange(n), window=4)


def _lsm_pair():
    """A reference tree with entries in the memtable and both levels,
    tombstones, and the dead key `cap` that batched updates write."""
    cfg = ref_lsm.LSMConfig(mem_cap=16, num_levels=2, fanout=4, row_width=3)
    rng = np.random.default_rng(4)
    st = ref_lsm.init(cfg)
    for s in range(0, 150, 10):
        keys = rng.integers(0, 40, 10).astype(np.int32)
        keys[0] = 40                                   # the dead key
        vals = rng.integers(-1, 40, (10, 3)).astype(np.int32)
        lives = (rng.random(10) > 0.2).astype(np.int8)
        st = ref_lsm.puts(cfg, st, jnp.asarray(keys), jnp.asarray(vals),
                          jnp.asarray(lives))
    tcfg = lsm.LSMConfig(*cfg)
    return cfg, st, tcfg, lsm_state_from_numpy(
        {k: np.asarray(v) for k, v in ref_lsm.dehydrate(st).items()}, "cpu")


def test_compact_all_and_remap_ids_match_reference():
    cfg, st, tcfg, tst = _lsm_pair()
    assert int(st.mem_count) > 0 and int(st.level_counts[0]) > 0
    for want, got in (
            (ref_lsm.compact_all(cfg, st), lsm.compact_all(tcfg, tst)),
            # a 40-entry map: the dead key 40 reads its last entry
            (ref_lsm.remap_ids(cfg, st, jnp.asarray(
                np.random.default_rng(5).permutation(40).astype(np.int32))),
             lsm.remap_ids(tcfg, tst, np.random.default_rng(5).permutation(
                 40).astype(np.int32)))):
        w = {k: np.asarray(v) for k, v in ref_lsm.dehydrate(want).items()}
        for k, v in lsm_state_to_numpy(got).items():
            np.testing.assert_array_equal(v, w[k], err_msg=k)
    live, rows = lsm.resolve_all(tcfg, lsm.compact_all(tcfg, tst), 40)
    live0, rows0 = lsm.resolve_all(tcfg, tst, 40)
    assert torch.equal(live, live0)
    assert torch.equal(torch.where(live[:, None] > 0, rows, -1),
                       torch.where(live0[:, None] > 0, rows0, -1))


@pytest.fixture(scope="module")
def pair():
    """A reference index after searches (heat), inserts and lazy deletes,
    with tier lanes set, and the port's index on a copy of its state."""
    rng = np.random.default_rng(6)
    base = _ints(rng, (120, JCFG.dim))
    jidx = ref_index.LSMVecIndex.build(JCFG, base, seed=0)
    qs = _ints(rng, (10, JCFG.dim))
    jidx.search(qs)
    jidx.insert_batch(_ints(rng, (40, JCFG.dim)))
    jidx.delete_batch(rng.choice(160, 9, replace=False))
    jidx.search(qs, params=RefParams(use_snapshot=True))
    st = jidx.state
    jidx.state = st._replace(
        hot=st.hot.at[::3].set(False),
        tier_heat=jnp.arange(JCFG.cap, dtype=jnp.float32),
        qscale=jnp.arange(JCFG.cap, dtype=jnp.float32) / 7.0)
    tidx = LSMVecIndex(TCFG, state=hnsw_state_from_numpy(
        _np(jidx.state), "cpu"), device="cpu")
    return jidx, tidx, qs


def _same(tidx, jidx):
    want = _np(jidx.state)
    for k, v in hnsw_state_to_numpy(tidx.state).items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def _searches(index, qs, params):
    return [index.search(qs, params=p) for p in params]


def test_apply_permutation_matches_reference(pair):
    jidx, _, _ = pair
    st = hnsw_state_from_numpy(_np(jidx.state), "cpu")
    perm = np.random.default_rng(8).permutation(160).astype(np.int32)
    want = _np(ref.apply_permutation(JCFG, jidx.state, perm))
    got = hnsw_state_to_numpy(reorder.apply_permutation(TCFG, st, perm))
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def test_index_compact_and_reorder_match_reference(pair):
    jidx, tidx, qs = pair
    params = [SearchParams(), SearchParams(use_snapshot=True)]
    ref_params = [RefParams(), RefParams(use_snapshot=True)]
    before = _searches(tidx, qs, params)
    for a, b in zip(before, _searches(jidx, qs, ref_params)):
        np.testing.assert_array_equal(a.ids, b.ids)

    rep = tidx.maintain("compact")
    want = jidx.maintain("compact")
    assert (rep.op, rep.applied) == (want.op, want.applied)
    _same(tidx, jidx)
    assert int(tidx.state.store.mem_count) == 0
    assert all(int(c) == 0 for c in tidx.state.store.level_counts[:-1])
    # both indexes search alike, so both record the same heat
    for a, b, c in zip(_searches(tidx, qs, params), before,
                       _searches(jidx, qs, ref_params)):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.dists, b.dists)
        np.testing.assert_array_equal(a.ids, c.ids)

    rep = tidx.maintain("reorder", window=4, lam=2.0)
    want = jidx.maintain("reorder", window=4, lam=2.0)
    np.testing.assert_array_equal(rep.perm, want.perm)
    assert rep.detail["gorder_seconds"] >= 0.0
    _same(tidx, jidx)
    perm = rep.perm
    for a, b, c in zip(_searches(tidx, qs, params), before,
                       _searches(jidx, qs, ref_params)):
        np.testing.assert_array_equal(a.ids, c.ids)
        np.testing.assert_array_equal(a.dists, c.dists)
        # the same answers, renamed
        np.testing.assert_array_equal(
            a.ids, np.where(b.ids >= 0, perm[np.maximum(b.ids, 0)], -1))
        np.testing.assert_array_equal(a.dists, b.dists)


def test_insert_after_reorder_finds_the_new_node():
    """The reference's `test_update_after_reorder` on the port."""
    rng = np.random.default_rng(18)
    cfg = TCFG._replace(dim=16, cap=1024, ef_search=32, k=10)
    data = rng.normal(size=(256, 16)).astype(np.float32)
    idx = LSMVecIndex.build(cfg, data, device="cpu")
    idx.search(rng.normal(size=(8, 16)).astype(np.float32), k=5)
    perm = idx.reorder()
    assert sorted(perm.tolist()) == list(range(256))
    new_vec = rng.normal(size=16).astype(np.float32) + 50.0
    nid = idx.insert(new_vec)
    assert nid == 256
    assert int(idx.search(new_vec[None, :], k=1).ids[0, 0]) == nid
    for p in (SearchParams(), SearchParams(use_snapshot=True)):
        found = idx.search(data[:20] + 0.0, k=1, params=p).ids[:, 0]
        assert (found == perm[np.arange(20)]).mean() >= 0.9
    with pytest.raises(ValueError, match="unknown"):
        idx.maintain("bogus")


def test_jax_and_port_gorder_agree_on_a_built_index_graph():
    """The bottom layer of a bulk-built graph, with the searches' heat."""
    rng = np.random.default_rng(9)
    base = _ints(rng, (300, JCFG.dim))
    st = ref_hnsw.bulk_build(JCFG, jnp.asarray(base), jax.random.key(3))
    live, rows = ref_lsm.resolve_all(JCFG.lsm_cfg, st.store, 300)
    heat = rng.integers(0, 9, (300, JCFG.M)).astype(np.int32)
    rows = np.asarray(rows)
    live = np.asarray(live) > 0
    np.testing.assert_array_equal(
        reorder.gorder_permutation(rows, heat, live=live),
        ref.gorder_permutation(rows, heat, live=live))
