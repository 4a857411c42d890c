"""Eager deletion (Algorithm 2, `lazy_delete=False`), port against
reference: `delete_batch` and `delete` through the functional API and
through `LSMVecIndex`.

Integer-valued vectors make every distance an exact integer, so each
relink decision is the reference's: after every call every state field
(levels, upper rows, the LSM tree's runs and counters, entry, n_live,
n_delete_noops) is bitwise equal, and so are the IOStats and the
searches on both read routes.  The batches hold repeats, -1 pads,
unallocated ids, upper-layer nodes and the entry node.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hnsw as ref
from repro.core import index as ref_index
from repro.core import lsm as ref_lsm
from repro.core.backend import SearchParams as RefParams
from repro_torch.bridge import hnsw_state_from_numpy, hnsw_state_to_numpy
from repro_torch.core import hnsw, lsm
from repro_torch.core.backend import SearchParams
from repro_torch.core.index import LSMVecIndex

torch.set_num_threads(1)

JCFG = ref.HNSWConfig(cap=512, dim=16, M=8, M_up=4, num_upper=2,
                      ef_search=16, ef_construction=16, k=5, lsm_mem_cap=64,
                      lsm_levels=2, lsm_fanout=8, lazy_delete=False)
TCFG = hnsw.HNSWConfig(**{f: getattr(JCFG, f)
                          for f in hnsw.HNSWConfig._fields})


def _ints(rng, shape):
    return rng.integers(-4, 5, shape).astype(np.float32)


def _np(st):
    return {k: np.asarray(v) for k, v in ref_lsm.dehydrate(st).items()}


def assert_same_state(port_st, ref_st):
    want = _np(ref_st)
    for k, v in hnsw_state_to_numpy(port_st).items():
        assert v.dtype == want[k].dtype and v.shape == want[k].shape, k
        np.testing.assert_array_equal(v, want[k], err_msg=k)


def assert_same_search(port_st, ref_st, qs):
    snap = lsm.snapshot_rows(TCFG.lsm_cfg, port_st.store, TCFG.cap)
    ref_snap = ref_lsm.snapshot_rows(JCFG.lsm_cfg, ref_st.store, JCFG.cap)
    for got, want in (
            (hnsw.search_batch(TCFG, port_st, torch.from_numpy(qs)),
             ref.search_batch(JCFG, ref_st, jnp.asarray(qs))),
            (hnsw.search_batch(TCFG, port_st, torch.from_numpy(qs),
                               snapshot=snap),
             ref.search_batch(JCFG, ref_st, jnp.asarray(qs),
                              snapshot=ref_snap))):
        np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
        np.testing.assert_array_equal(got.dists.numpy(),
                                      np.asarray(want.dists))
        for a, b in zip(got.stats, want.stats):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(5)
    base = _ints(rng, (240, JCFG.dim))
    st = ref.bulk_build(JCFG, jnp.asarray(base), jax.random.key(0))
    return st, rng, _ints(rng, (12, JCFG.dim))


def test_eager_delete_batch_matches_reference(built):
    ref_st, rng, qs = built
    levels = np.asarray(ref_st.levels)
    upper = np.flatnonzero(levels > 0)
    entry = int(ref_st.entry)
    dels = np.concatenate([
        rng.choice(240, 30, replace=False), upper[:3], [entry, entry, 3, 3],
        [-1, 250, 511, -1]]).astype(np.int32)
    # lazily tombstoned nodes are skipped as relink candidates
    tomb = np.setdiff1d(rng.choice(240, 12, replace=False), dels)
    ref_st, _ = ref.tombstone_batch(JCFG, ref_st, jnp.asarray(tomb))
    st = hnsw_state_from_numpy(_np(ref_st), "cpu")
    ref_delete_batch = jax.jit(lambda s, i: ref.delete_batch(JCFG, s, i))
    for chunk in (dels[:20], dels[20:], np.zeros((0,), np.int32)):
        ref_st, ref_io = ref_delete_batch(ref_st, jnp.asarray(chunk))
        st, io = hnsw.delete_batch(TCFG, st, torch.from_numpy(chunk))
        assert [int(a) for a in io] == [int(a) for a in ref_io]
        assert_same_state(st, ref_st)
    assert int(st.entry) != entry and int(st.levels[entry]) == -1
    n_applied = len({int(i) for i in dels if 0 <= i < 240})
    assert int(st.n_live) == 240 - len(tomb) - n_applied
    # repeats of a deleted id and the unallocated ids are counted no-ops
    assert int(st.n_delete_noops) == int((dels >= 0).sum()) - n_applied
    assert_same_search(st, ref_st, qs)
    res = hnsw.search_batch(TCFG, st, torch.from_numpy(qs))
    assert not np.isin(res.ids.numpy(), dels[dels >= 0]).any()


def test_eager_delete_one_by_one_matches_reference(built):
    ref_st, rng, qs = built
    st = hnsw_state_from_numpy(_np(ref_st), "cpu")
    entry = int(ref_st.entry)
    upper = [int(u) for u in np.flatnonzero(np.asarray(ref_st.levels) > 0)
             if u != entry]
    ref_delete = jax.jit(lambda s, i: ref.delete(JCFG, s, i))
    for node in [7, 7, 300, upper[0], entry, 11]:
        ref_st, ref_io = ref_delete(ref_st, jnp.asarray(node, jnp.int32))
        st, io = hnsw.delete(TCFG, st, node)
        assert [int(a) for a in io] == [int(a) for a in ref_io], node
        assert_same_state(st, ref_st)
    assert int(st.n_delete_noops) == 2
    assert_same_search(st, ref_st, qs)
    with pytest.raises(ValueError):
        hnsw.delete(TCFG, st, TCFG.cap)


def test_eager_index_delete_matches_reference_and_refreshes_snapshot():
    """`LSMVecIndex.delete` / `delete_batch(pad_to=)` under
    `lazy_delete=False`: each is a graph write, so the cached snapshot is
    re-resolved and snapshot searches see the relinked rows."""
    cfg_j = JCFG._replace(dim=65)
    cfg_t = TCFG._replace(dim=65)
    rng = np.random.default_rng(3)
    base = _ints(rng, (60, 65))
    jidx = ref_index.LSMVecIndex.build(cfg_j, base, seed=0)
    tidx = LSMVecIndex(cfg_t, state=hnsw_state_from_numpy(
        _np(jidx.state), "cpu"), device="cpu")
    qs = _ints(rng, (9, 65))
    snap = SearchParams(use_snapshot=True)
    ref_snap = RefParams(use_snapshot=True)
    np.testing.assert_array_equal(tidx.search(qs, params=snap).ids,
                                  jidx.search(qs, params=ref_snap).ids)
    tidx.delete(5)
    jidx.delete(5)
    r1 = tidx.delete_batch([8, 9, 5, -1, 40, 41, 42], pad_to=4)
    r2 = jidx.delete_batch([8, 9, 5, -1, 40, 41, 42], pad_to=4)
    assert r1.n_applied == r2.n_applied == 6
    assert_same_state(tidx.state, jidx.state)
    for a, b in zip(tidx.io_stats, jidx.io_stats):
        assert int(a) == int(b)
    assert tidx.size == jidx.size == 54
    for p, rp in ((snap, ref_snap), (SearchParams(), RefParams())):
        got, want = tidx.search(qs, params=p), jidx.search(qs, params=rp)
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.dists, want.dists)
        assert not np.isin(got.ids, [5, 8, 9, 40, 41, 42]).any()
    fused = LSMVecIndex(cfg_t._replace(fused_beam=True), state=tidx.state,
                        device="cpu")
    a, b = fused.search(qs, params=snap), tidx.search(qs, params=snap)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.dists, b.dists)
