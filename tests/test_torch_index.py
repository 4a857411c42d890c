"""The slice through `LSMVecIndex`, port against reference, at d=65.

The port's index starts from the reference's built state (carried by
the bridge) and is handed the reference's level draws, then both run
the same calls: search on both routes, padded `insert_batch` (its
leading items through the per-item `insert`, the graph being small),
padded `delete_batch`, `maintain("consolidate")`.  On integer-valued vectors
the ids, dists, heat and every state field stay bitwise equal.
`brute_force_knn` and `recall_at_k` agree with the reference's too.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hnsw as jax_hnsw
from repro.core import index as ref
from repro.core import iostats as ref_iostats
from repro.core import lsm as ref_lsm
from repro.core.backend import SearchParams as RefParams
from repro_torch._device import resolve
from repro_torch.bridge import hnsw_state_from_numpy, hnsw_state_to_numpy
from repro_torch.core import hnsw
from repro_torch.core.backend import SearchParams
from repro_torch.core.index import LSMVecIndex, brute_force_knn, recall_at_k
from repro_torch.core.iostats import DISK, sampling_saving, search_cost
from repro_torch.data.synth import make_clustered_vectors

torch.set_num_threads(1)

JCFG = jax_hnsw.HNSWConfig(cap=512, dim=65, M=8, M_up=4, num_upper=2,
                           ef_search=16, ef_construction=16, k=5,
                           lsm_mem_cap=64, lsm_levels=2, lsm_fanout=8)
TCFG = hnsw.HNSWConfig(**{f: getattr(JCFG, f)
                          for f in hnsw.HNSWConfig._fields})


def _ints(rng, shape):
    return rng.integers(-3, 4, shape).astype(np.float32)


def _ref_draws(jidx, n_items, pad_to):
    """The level uniforms the reference index draws for an insert_batch
    of n_items padded to `pad_to`: one per seeding insert, then one
    array per padded chunk."""
    rng = jidx._rng
    n_seed = max(0, min(n_items, jidx.BATCH_MIN_GRAPH - jidx.size))
    draws = []
    for _ in range(n_seed):
        rng, sub = jax.random.split(rng)
        draws.append(np.array(jax.random.uniform(
            sub, (1,), jnp.float32, 1e-7, 1.0)))
    for _ in range(0, n_items - n_seed, pad_to):
        rng, sub = jax.random.split(rng)
        keys = jax.random.split(sub, pad_to)
        draws.append(np.array(jax.vmap(lambda kk: jax.random.uniform(
            kk, (), jnp.float32, 1e-7, 1.0))(keys)))
    return draws


def assert_same(tidx, jidx):
    got = hnsw_state_to_numpy(tidx.state)
    want = {k: np.asarray(v)
            for k, v in ref_lsm.dehydrate(jidx.state).items()}
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert tidx._count == jidx._count
    for a, b in zip(tidx.io_stats, jidx.io_stats):
        assert int(a) == int(b)
    assert float(search_cost(tidx.io_stats, DISK)) == pytest.approx(
        jidx.io_cost(), rel=1e-6)
    assert float(sampling_saving(tidx.io_stats, DISK)) == pytest.approx(
        float(ref_iostats.sampling_saving(jidx.io_stats, ref_iostats.DISK)),
        rel=1e-6)


def assert_same_search(tidx, jidx, qs):
    for snap in (False, True):
        got = tidx.search(qs, params=SearchParams(use_snapshot=snap))
        want = jidx.search(qs, params=RefParams(use_snapshot=snap))
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.dists, want.dists)
    got = tidx.dispatch_search(qs, 3, params=SearchParams(pad_to=16))
    want = jidx.dispatch_search(qs, 3, params=RefParams(pad_to=16))
    np.testing.assert_array_equal(got.collect().ids, want.collect().ids)


@pytest.fixture(scope="module")
def pair():
    rng = np.random.default_rng(2)
    base = _ints(rng, (40, JCFG.dim))
    jidx = ref.LSMVecIndex.build(JCFG, base, seed=0)
    state = hnsw_state_from_numpy(
        {k: np.asarray(v) for k, v in ref_lsm.dehydrate(jidx.state).items()},
        "cpu")
    tidx = LSMVecIndex(TCFG, state=state, device="cpu")
    return tidx, jidx, rng, base


def test_index_slice_matches_reference(pair):
    tidx, jidx, rng, base = pair
    qs = _ints(rng, (9, JCFG.dim))
    assert_same_search(tidx, jidx, qs)
    assert_same(tidx, jidx)

    xs = _ints(rng, (60, JCFG.dim))
    draws = _ref_draws(jidx, len(xs), pad_to=40)
    assert len(draws) == 25  # 24 seeding inserts, then 36 rows padded to 40
    tidx._uniforms = lambda n: torch.from_numpy(draws.pop(0))
    got_ids = tidx.insert_batch(xs, pad_to=40).ids
    want_ids = jidx.insert_batch(xs, pad_to=40).ids
    np.testing.assert_array_equal(got_ids, want_ids)
    assert not draws
    assert_same(tidx, jidx)
    assert_same_search(tidx, jidx, qs)

    dels = np.concatenate([rng.choice(100, 9, replace=False), [4, -1]])
    r1 = tidx.delete_batch(dels, pad_to=8)
    r2 = jidx.delete_batch(dels, pad_to=8)
    assert r1.n_applied == r2.n_applied
    assert_same(tidx, jidx)
    assert_same_search(tidx, jidx, qs)

    rep = tidx.maintain("consolidate")
    want_rep = jidx.maintain("consolidate")
    assert (rep.op, rep.applied, rep.reclaimed) == (
        want_rep.op, want_rep.applied, want_rep.reclaimed)
    assert tidx.n_tombstones == 0 and tidx.size == jidx.size
    assert_same(tidx, jidx)
    assert_same_search(tidx, jidx, qs)
    assert not tidx.maintain("consolidate").applied


def test_ground_truth_helpers_match_reference():
    rng = np.random.default_rng(4)
    vecs = _ints(rng, (300, 65))
    qs = _ints(rng, (20, 65))
    live = rng.random(300) > 0.2
    for lv in (None, live):
        got = brute_force_knn(vecs, qs, 7, live=lv, block=8, device="cpu")
        want = ref.brute_force_knn(
            jnp.asarray(vecs), jnp.asarray(qs), 7,
            live=None if lv is None else jnp.asarray(lv), block=8)
        np.testing.assert_array_equal(got, want)
    found = got.copy()
    found[::3, 2] = -1
    assert recall_at_k(found, want) == ref.recall_at_k(found, want) < 1.0


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve(None)
    with pytest.raises(RuntimeError, match="CUDA"):
        LSMVecIndex(TCFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        brute_force_knn(np.zeros((3, 4), np.float32),
                        np.zeros((1, 4), np.float32), 1)
    assert resolve("cpu").type == "cpu"


def test_port_index_recall_on_clustered_data():
    cfg = TCFG._replace(dim=32, cap=1024, ef_search=32, k=10)
    base = make_clustered_vectors(600, 32, seed=1, clusters=8)
    idx = LSMVecIndex.build(cfg, base, seed=3, device="cpu")
    qs = make_clustered_vectors(30, 32, seed=2, clusters=8)
    truth = brute_force_knn(base, qs, 10, device="cpu")
    assert recall_at_k(idx.search(qs).ids, truth) >= 0.9
    new = make_clustered_vectors(100, 32, seed=7, clusters=8)
    ids = idx.insert_batch(new).ids
    np.testing.assert_array_equal(ids, np.arange(600, 700))
    allv = np.concatenate([base, new])
    idx.delete_batch(np.arange(0, 700, 10))
    live = np.ones(700, bool)
    live[::10] = False
    truth = brute_force_knn(allv, qs, 10, live=live, device="cpu")
    res = idx.search(qs)
    assert not np.isin(res.ids, np.arange(0, 700, 10)).any()
    assert recall_at_k(res.ids, truth) >= 0.9
    idx.maintain("consolidate")
    assert recall_at_k(idx.search(qs).ids, truth) >= 0.9


# the tier and fused-beam configuration: a narrower width, rerank inside
# ef.  Every row holds 254 in its first coordinate, so its absmax is 254,
# its cold-lane scale exactly 2 and every cold distance an exact integer
# (the other coordinates quantize lossily, to even integers)
TIER_JCFG = JCFG._replace(dim=24, tier=True, fused_beam=True, rerank=8)
TIER_TCFG = hnsw.HNSWConfig(**{f: getattr(TIER_JCFG, f)
                               for f in hnsw.HNSWConfig._fields})


def _tier_ints(rng, shape):
    x = rng.integers(-6, 7, shape).astype(np.float32)
    x[..., 0] = 254.0
    return x


def test_index_fused_tier_slice_matches_reference():
    """build -> search -> insert -> delete -> consolidate -> tier ->
    search under tier=True, fused_beam=True: the LSM-probe searches run
    the loop route with the int8 lane, the snapshot and padded ones the
    fused route; the port's two routes also agree with each other."""
    from repro.tier import TierPolicy as RefPolicy
    from repro_torch.tier import TierPolicy

    rng = np.random.default_rng(5)
    base = _tier_ints(rng, (40, TIER_JCFG.dim))
    jidx = ref.LSMVecIndex.build(TIER_JCFG, base, seed=0)
    tidx = LSMVecIndex(TIER_TCFG, state=hnsw_state_from_numpy(
        {k: np.asarray(v) for k, v in ref_lsm.dehydrate(jidx.state).items()},
        "cpu"), device="cpu")
    qs = _tier_ints(rng, (9, TIER_JCFG.dim))
    assert_same_search(tidx, jidx, qs)
    assert_same(tidx, jidx)

    xs = _tier_ints(rng, (60, TIER_JCFG.dim))
    draws = _ref_draws(jidx, len(xs), pad_to=40)
    tidx._uniforms = lambda n: torch.from_numpy(draws.pop(0))
    np.testing.assert_array_equal(tidx.insert_batch(xs, pad_to=40).ids,
                                  jidx.insert_batch(xs, pad_to=40).ids)
    dels = rng.choice(100, 12, replace=False)
    tidx.delete_batch(dels, pad_to=8)
    jidx.delete_batch(dels, pad_to=8)
    assert_same_search(tidx, jidx, qs)
    assert tidx.maintain("consolidate").reclaimed == \
        jidx.maintain("consolidate").reclaimed
    assert_same(tidx, jidx)

    pol = dict(hot_frac=0.25, max_demote=TIER_JCFG.cap, max_promote=8)
    rep = tidx.maintain("tier", policy=TierPolicy(**pol))
    want = jidx.maintain("tier", policy=RefPolicy(**pol))
    assert (rep.op, rep.applied, rep.demoted, rep.promoted) == (
        want.op, want.applied, want.demoted, want.promoted)
    assert rep.demoted > 0
    assert_same(tidx, jidx)
    cold = ~(tidx.state.hot | (tidx.state.levels > 0))
    assert int((cold & (tidx.state.levels >= 0)).sum()) > 0
    assert_same_search(tidx, jidx, qs)
    assert_same(tidx, jidx)
    res = tidx.search(qs, params=SearchParams(use_snapshot=True))
    assert not np.isin(res.ids, dels).any()

    # the port's loop route on a copy of the state gives the fused
    # route's ids, dists and heat
    loop = LSMVecIndex(TIER_TCFG._replace(fused_beam=False),
                       state=hnsw_state_from_numpy(
                           hnsw_state_to_numpy(tidx.state), "cpu"),
                       device="cpu")
    p = SearchParams(use_snapshot=True)
    a, b = tidx.search(qs, params=p), loop.search(qs, params=p)
    np.testing.assert_array_equal(a.ids, b.ids)
    np.testing.assert_array_equal(a.dists, b.dists)
    np.testing.assert_array_equal(tidx.state.heat.numpy(),
                                  loop.state.heat.numpy())
