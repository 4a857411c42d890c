"""The fused SimHash prefilter + gather (`repro_torch.kernels.prefilter_gather`)
and the loop beam trip that takes it, against the reference.

The plain version is held against a composition of the reference's own
oracles on the same numpy-seeded inputs: `collision_count_ref` at the
clamped ids, the Hoeffding test `collisions >= thr` with the threshold
of `repro.core.simhash.hoeffding_threshold`, then `gather_l2_ref` (and,
under the tier, `gather_l2_q8_ref` for the rows not resident) over the
survivors.  Rows, queries and power-of-two scales are integer-valued,
so every distance is exact and the comparison is bitwise.

`traversal.beam_search` with a `fetch_fn` takes one fetch call a trip
where the filter is on and nothing samples; its ids, dists, stats and
heat equal the reference's vmapped loop bitwise, with the tier on and
off.  `LSMVecIndex.search` on the loop routes (LSM probe and snapshot),
untiered and tiered, equals the reference's index end to end.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hnsw as jax_hnsw
from repro.core import index as ref_index
from repro.core import lsm as ref_lsm
from repro.core import simhash as jax_simhash
from repro.core import traversal as ref_traversal
from repro.core.backend import SearchParams as RefParams
from repro.kernels.gather_l2.ref import gather_l2_q8_ref as jax_q8_ref
from repro.kernels.gather_l2.ref import gather_l2_ref as jax_gather_ref
from repro.kernels.simhash.ref import collision_count_ref as jax_cols_ref
from repro_torch.bridge import hnsw_state_from_numpy, hnsw_state_to_numpy
from repro_torch.core import hnsw, traversal
from repro_torch.core.backend import SearchParams
from repro_torch.core.index import LSMVecIndex
from repro_torch.kernels.gather_l2.ops import gather_l2, gather_l2_q8
from repro_torch.kernels.prefilter_gather.ops import prefilter_gather
from repro_torch.kernels.prefilter_gather.ref import prefilter_gather_ref

torch.set_num_threads(1)

CAP = 300


def _tier_lanes(rng, cap, d):
    """(resident, int8 rows, power-of-two scales) as numpy arrays."""
    return (rng.random(cap) < 0.5,
            rng.integers(-127, 128, (cap, d)).astype(np.int8),
            (2.0 ** rng.integers(-2, 3, cap)).astype(np.float32))


def _jax_fetch(q, table, q_codes, codes, row, eligible, thr, m_bits, tier):
    """The reference's oracles composed: counts, Hoeffding test, fetch."""
    cols = np.take_along_axis(
        np.asarray(jax_cols_ref(jnp.asarray(q_codes), jnp.asarray(codes),
                                m_bits)),
        np.clip(row, 0, codes.shape[0] - 1), axis=1)
    mask = eligible & (cols.astype(np.float32) >= thr[:, None])
    ids = np.where(mask, row, -1).astype(np.int32)
    if tier is None:
        return mask, np.asarray(jax_gather_ref(q, table, ids))
    resident, qt, sc = tier
    res = resident[np.maximum(ids, 0)]
    hot = np.where((ids >= 0) & res, ids, -1)
    cold = np.where((ids >= 0) & ~res, ids, -1)
    return mask, np.minimum(np.asarray(jax_gather_ref(q, table, hot)),
                            np.asarray(jax_q8_ref(q, qt, sc, cold)))


@pytest.mark.parametrize("b,n", [(1, 16), (9, 64)])
@pytest.mark.parametrize("tier", [False, True])
@pytest.mark.parametrize("m_bits", [32, 64])
@pytest.mark.parametrize("d", [65, 128])
def test_prefilter_gather_ref_matches_reference(d, m_bits, tier, b, n):
    rng = np.random.default_rng(d * 100 + m_bits + 7 * tier + b)
    words = m_bits // 32
    q = rng.integers(-6, 7, (b, d)).astype(np.float32)
    table = rng.integers(-6, 7, (CAP, d)).astype(np.float32)
    codes = rng.integers(0, 2 ** 32, (CAP, words), dtype=np.uint32)
    q_codes = rng.integers(0, 2 ** 32, (b, words), dtype=np.uint32)
    row = rng.integers(0, CAP, (b, n)).astype(np.int32)
    row[rng.random((b, n)) < 0.15] = -1
    eligible = (row >= 0) & (rng.random((b, n)) < 0.8)
    row[0, 0], eligible[0, 0] = -1, True     # counted against row 0, +inf
    # thresholds around the mean count, from the reference's Hoeffding
    # bound on random angles; past one query, the last one's beam is not
    # yet full
    cos = rng.uniform(0.2, 0.8, b).astype(np.float32)
    thr = np.array(jax_simhash.hoeffding_threshold(
        m_bits, 0.1, jnp.asarray(cos)), np.float32)
    # the first query's at the median of its eligible counts, so both
    # outcomes of the test occur
    cols0 = np.asarray(jax_cols_ref(jnp.asarray(q_codes[:1]),
                                    jnp.asarray(codes), m_bits))[0]
    thr[0] = np.median(cols0[row[0][eligible[0] & (row[0] >= 0)]]) + 0.5
    if b > 1:
        thr[-1] = -np.inf
    lanes = _tier_lanes(rng, CAP, d) if tier else None
    want_mask, want_d = _jax_fetch(q, table, q_codes, codes, row, eligible,
                                   thr, m_bits, lanes)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    got_mask, got_d = prefilter_gather_ref(
        t(q), t(table), t(q_codes.astype(np.int64)),
        t(codes.astype(np.int64)), t(row), t(eligible), t(thr),
        tier=None if lanes is None else tuple(t(a) for a in lanes))
    assert got_mask.dtype == torch.bool and got_d.dtype == torch.float32
    np.testing.assert_array_equal(got_mask.numpy(), want_mask)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    # the case covers both outcomes of the test, every -inf lane passes
    assert want_mask.any() and (eligible & ~want_mask).any()
    assert b == 1 or (want_mask[-1] == eligible[-1]).all()
    assert np.isinf(want_d[~want_mask]).all()
    assert np.isfinite(want_d[want_mask & (row >= 0)]).all()


# ---------------------------------------------------------------------------
# the loop beam with a fetch_fn, against the reference's vmapped loop
# ---------------------------------------------------------------------------

CAP_G, DIM, M, EF, K, M_BITS, NQ = 300, 16, 8, 16, 4, 64, 10


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(19)
    vecs = rng.integers(-4, 5, (CAP_G, DIM)).astype(np.float32)
    adj = rng.integers(0, CAP_G, (CAP_G, M)).astype(np.int32)
    adj[rng.random((CAP_G, M)) < 0.1] = -1
    live = rng.random(CAP_G) > 0.05
    returnable = live & (rng.random(CAP_G) > 0.1)
    proj = rng.normal(size=(M_BITS, DIM)).astype(np.float32)
    params = jax_simhash.SimHashParams(jnp.asarray(proj))
    qs = rng.integers(-4, 5, (NQ, DIM)).astype(np.float32)
    entry = rng.choice(np.flatnonzero(live), NQ).astype(np.int32)
    active = np.ones(NQ, bool)
    active[[3, 8]] = False
    resident, qvecs, qscale = _tier_lanes(rng, CAP_G, DIM)
    return dict(vecs=vecs, adj=adj, live=live, returnable=returnable,
                codes=np.asarray(jax_simhash.encode(params,
                                                    jnp.asarray(vecs))),
                qs=qs, entry=entry,
                entry_d=((qs - vecs[entry]) ** 2).sum(1).astype(np.float32),
                active=active,
                q_codes=np.asarray(jax_simhash.encode(params,
                                                      jnp.asarray(qs))),
                q_norm=np.sqrt((qs * qs).sum(1)).astype(np.float32),
                mean_norm=np.float32(np.sqrt((vecs * vecs).sum(1)).mean()),
                resident=resident, qvecs=qvecs, qscale=qscale)


@functools.lru_cache(maxsize=None)
def _ref_fn(n_expand, tier):
    """The reference's beam (filter on, rho = 1), jitted once per static
    combination, fetching through its tier lanes' oracles where `tier`."""

    def one(q, e, ed, cq, qn, a, ret, adj, vecs, codes, live, mean_norm,
            resident, qvecs, qscale):
        def adj_fn(nodes):
            rows = adj[jnp.maximum(nodes, 0)]
            return jnp.where((nodes >= 0)[:, None], rows, -1), \
                jnp.ones_like(nodes)

        def dist_fn(ids):
            if not tier:
                return jax_gather_ref(q[None, :], vecs, ids[None, :])[0]
            res = resident[jnp.maximum(ids, 0)]
            hot = jnp.where((ids >= 0) & res, ids, -1)
            cold = jnp.where((ids >= 0) & ~res, ids, -1)
            return jnp.minimum(
                jax_gather_ref(q[None, :], vecs, hot[None, :])[0],
                jax_q8_ref(q[None, :], qvecs, qscale, cold[None, :])[0])

        return ref_traversal.beam_search(
            q, e, ed, adj_fn, dist_fn, codes, cq, live, cap=CAP_G, ef=EF,
            k=K, m_bits=M_BITS, eps=0.1, rho=1.0, max_iters=2 * EF,
            use_filter=True, q_norm=qn, mean_norm=mean_norm,
            n_expand=n_expand, active=a, returnable=ret)

    return jax.jit(jax.vmap(one, in_axes=(0,) * 6 + (None,) * 9))


def _port_beam(g, n_expand, tier, with_active, monkeypatch=None,
               fused=True, **kw):
    """The port's loop beam, with a `prefilter_gather` fetch_fn where
    `fused`; with `monkeypatch`, the separate count and `dist_fn` raise if
    called."""
    t = {k: torch.from_numpy(np.array(v)) for k, v in g.items()}
    adj, qs, vecs = t["adj"], t["qs"], t["vecs"]
    codes, q_codes = t["codes"].to(torch.int64), t["q_codes"].to(torch.int64)
    lanes = (t["resident"], t["qvecs"], t["qscale"]) if tier else None
    calls = [0]

    def adj_fn(nodes):
        rows = adj[nodes.clamp_min(0).long()]
        return torch.where((nodes >= 0)[..., None], rows, -1), \
            torch.ones_like(nodes)

    def fetch_fn(row, eligible, thr):
        calls[0] += 1
        return prefilter_gather(qs, vecs, q_codes, codes, row, eligible, thr,
                                tier=lanes)

    def dist_fn(ids):
        if lanes is None:
            return gather_l2(qs, vecs, ids)
        res = lanes[0][ids.clamp_min(0).long()]
        return torch.minimum(
            gather_l2(qs, vecs, torch.where((ids >= 0) & res, ids, -1)),
            gather_l2_q8(qs, lanes[1], lanes[2],
                         torch.where((ids >= 0) & ~res, ids, -1)))

    if monkeypatch is not None:
        def never(*args):
            raise AssertionError("the fused trip ran a separate fetch")
        monkeypatch.setattr(traversal, "collision_count_rows", never)
        dist_fn = never
    args = dict(cap=CAP_G, ef=EF, k=K, m_bits=M_BITS, eps=0.1, rho=1.0,
                max_iters=2 * EF, use_filter=True, q_norm=t["q_norm"],
                mean_norm=t["mean_norm"], n_expand=n_expand, M=M,
                active=t["active"] if with_active else None,
                returnable=t["returnable"] if with_active else None)
    args.update(kw)
    res = traversal.beam_search(
        qs, t["entry"], t["entry_d"], adj_fn, dist_fn, codes, q_codes,
        t["live"], fetch_fn=fetch_fn if fused else None, **args)
    return res, calls[0]


def _assert_same_beam(got, want):
    np.testing.assert_array_equal(got.ids.numpy(), np.asarray(want.ids))
    np.testing.assert_array_equal(got.dists.numpy(), np.asarray(want.dists))
    for name, a, b in zip(want.stats._fields, got.stats, want.stats):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
    np.testing.assert_array_equal(got.heat_nodes.numpy(),
                                  np.asarray(want.heat_nodes))
    np.testing.assert_array_equal(got.heat_mask.numpy(),
                                  np.asarray(want.heat_mask))


@pytest.mark.parametrize("with_active", [False, True])
@pytest.mark.parametrize("tier", [False, True])
@pytest.mark.parametrize("n_expand", [1, 4])
def test_beam_search_fetch_fn_matches_reference(graph, monkeypatch, n_expand,
                                                tier, with_active):
    g = graph
    active = g["active"] if with_active else np.ones(NQ, bool)
    ret = g["returnable"] if with_active else g["live"]
    args = [g[k] for k in ("qs", "entry", "entry_d", "q_codes", "q_norm")]
    args += [active, ret]
    args += [g[k] for k in ("adj", "vecs", "codes", "live", "mean_norm",
                            "resident", "qvecs", "qscale")]
    want = _ref_fn(n_expand, tier)(*map(jnp.asarray, args))
    got, calls = _port_beam(g, n_expand, tier, with_active, monkeypatch)
    _assert_same_beam(got, want)
    # one fetch call a trip; the beams ran many
    assert calls > 3
    assert int(np.asarray(want.stats.n_filtered).sum()) > 0
    if tier:
        cold = ~g["resident"][np.maximum(np.asarray(want.ids), 0)]
        assert (cold & (np.asarray(want.ids) >= 0)).any()


# ---------------------------------------------------------------------------
# the fetch_fn route against the port's own separate route, float data
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def float_graph(graph):
    rng = np.random.default_rng(23)
    g = dict(graph)
    g["vecs"] = rng.normal(size=(CAP_G, DIM)).astype(np.float32)
    g["qs"] = rng.normal(size=(NQ, DIM)).astype(np.float32)
    g["qscale"] = (rng.random(CAP_G) * 0.05).astype(np.float32)
    g["entry_d"] = gather_l2(torch.from_numpy(g["qs"]),
                             torch.from_numpy(g["vecs"]),
                             torch.from_numpy(g["entry"][:, None]))[:, 0]
    g["entry_d"] = g["entry_d"].numpy()
    return g


@pytest.mark.parametrize("with_active", [False, True])
@pytest.mark.parametrize("tier", [False, True])
@pytest.mark.parametrize("n_expand", [1, 4])
def test_fetch_fn_route_equals_separate_route_on_float_data(
        float_graph, n_expand, tier, with_active):
    """The fused trip and the separate one (counts, masks, dist_fn) give
    the same bits on float rows too: one row-distance order."""
    got, calls = _port_beam(float_graph, n_expand, tier, with_active)
    want, _ = _port_beam(float_graph, n_expand, tier, with_active,
                         fused=False)
    assert calls > 3
    for a, b in zip(got, want):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b)
    for a, b in zip(got.stats, want.stats):
        assert torch.equal(a, b)


@pytest.mark.parametrize("use_filter,rho,fused", [
    (True, 1.0, True), (False, 1.0, False), (True, 0.5, False),
    (False, 0.5, False)])
def test_fetch_fn_taken_only_with_the_filter_and_no_sampling(
        graph, monkeypatch, use_filter, rho, fused):
    counts = [0]
    count_rows = traversal.collision_count_rows

    def counting(*args):
        counts[0] += 1
        return count_rows(*args)

    monkeypatch.setattr(traversal, "collision_count_rows", counting)
    res, calls = _port_beam(graph, 1, False, True, use_filter=use_filter,
                            rho=rho)
    assert (calls > 0) == fused
    assert (counts[0] > 0) == (not fused and (use_filter or rho < 1))
    monkeypatch.setattr(traversal, "collision_count_rows", count_rows)
    # without a fetch_fn the same search gives the same answers
    t = {k: torch.from_numpy(np.array(v)) for k, v in graph.items()}
    qs, vecs, adj = t["qs"], t["vecs"], t["adj"]
    plain = traversal.beam_search(
        qs, t["entry"], t["entry_d"], hnsw._snapshot_adj_fn(adj),
        lambda ids: gather_l2(qs, vecs, ids), t["codes"].to(torch.int64),
        t["q_codes"].to(torch.int64), t["live"], cap=CAP_G, ef=EF, k=K,
        m_bits=M_BITS, eps=0.1, rho=rho, max_iters=2 * EF,
        use_filter=use_filter, q_norm=t["q_norm"], mean_norm=t["mean_norm"],
        n_expand=1, M=M, active=t["active"], returnable=t["returnable"])
    assert torch.equal(res.ids, plain.ids)
    assert torch.equal(res.dists, plain.dists)


# ---------------------------------------------------------------------------
# the wrapper
# ---------------------------------------------------------------------------

def _small_inputs(rng, b=3, n=8, d=8, cap=20):
    q = torch.from_numpy(rng.integers(-3, 4, (b, d)).astype(np.float32))
    table = torch.from_numpy(rng.integers(-3, 4, (cap, d)).astype(
        np.float32))
    codes = torch.from_numpy(rng.integers(0, 2 ** 32, (cap, 2)))
    code_q = torch.from_numpy(rng.integers(0, 2 ** 32, (b, 2)))
    row = torch.from_numpy(rng.integers(-1, cap, (b, n)).astype(np.int32))
    thr = torch.full((b,), 30.0)
    return q, table, code_q, codes, row, row >= 0, thr


def test_cpu_wrapper_takes_the_plain_version_and_counts_no_launch():
    prefilter_gather.launches = 0
    prefilter_gather.by_class.clear()
    rng = np.random.default_rng(3)
    args = _small_inputs(rng)
    tier = (torch.from_numpy(rng.random(20) < 0.5),
            torch.from_numpy(rng.integers(-9, 9, (20, 8)).astype(np.int8)),
            torch.ones(20))
    for lanes in (None, tier):
        mask, dists = prefilter_gather(*args, tier=lanes)
        want = prefilter_gather_ref(*args, tier=lanes)
        assert torch.equal(mask, want[0]) and torch.equal(dists, want[1])
    assert prefilter_gather.launches == 0
    assert not prefilter_gather.by_class
    # an empty block keeps its shapes
    q, table, code_q, codes, row, elig, thr = args
    mask, dists = prefilter_gather(q, table, code_q, codes, row[:, :0],
                                   elig[:, :0], thr)
    assert mask.shape == dists.shape == (3, 0)


def test_wrapper_never_falls_back_off_the_cpu():
    """Tensors that are not all on the CPU launch the kernel or raise:
    here they lie on PyTorch's meta device, which no kernel takes."""
    args = [a.to("meta") for a in _small_inputs(np.random.default_rng(4))]
    with pytest.raises(ValueError, match="devices"):
        prefilter_gather(*args)
    mixed = list(_small_inputs(np.random.default_rng(4)))
    mixed[-1] = mixed[-1].to("meta")
    with pytest.raises(ValueError, match="devices"):
        prefilter_gather(*mixed)


# ---------------------------------------------------------------------------
# the index end to end, loop routes, untiered and tiered
# ---------------------------------------------------------------------------

JCFG = jax_hnsw.HNSWConfig(cap=256, dim=24, M=8, M_up=4, num_upper=2,
                           ef_search=16, ef_construction=16, k=5,
                           lsm_mem_cap=64, lsm_levels=2, lsm_fanout=8,
                           rerank=8)


def _ints(rng, shape):
    # every row's first coordinate 254 is its absmax: a demoted row's
    # scale is exactly 2 and every cold distance an exact integer
    x = rng.integers(-6, 7, shape).astype(np.float32)
    x[..., 0] = 254.0
    return x


def _ref_draws(jidx, n_items):
    """The level uniforms the reference draws for an unpadded batch of
    `n_items` on a graph past its seeding size."""
    _, sub = jax.random.split(jidx._rng)
    keys = jax.random.split(sub, n_items)
    return np.array(jax.vmap(lambda kk: jax.random.uniform(
        kk, (), jnp.float32, 1e-7, 1.0))(keys))


def _assert_same_search(tidx, jidx, qs):
    for snap in (False, True):
        got = tidx.search(qs, params=SearchParams(use_snapshot=snap))
        want = jidx.search(qs, params=RefParams(use_snapshot=snap))
        np.testing.assert_array_equal(got.ids, want.ids)
        np.testing.assert_array_equal(got.dists, want.dists)


@pytest.mark.parametrize("tier", [False, True])
def test_index_loop_routes_match_reference(monkeypatch, tier):
    from repro.tier import TierPolicy as RefPolicy
    from repro_torch.tier import TierPolicy

    jcfg = JCFG._replace(tier=tier)
    tcfg = hnsw.HNSWConfig(**{f: getattr(jcfg, f)
                              for f in hnsw.HNSWConfig._fields})
    rng = np.random.default_rng(31 + tier)
    base = _ints(rng, (80, jcfg.dim))
    jidx = ref_index.LSMVecIndex.build(jcfg, base, seed=0)
    tidx = LSMVecIndex(tcfg, state=hnsw_state_from_numpy(
        {k: np.asarray(v) for k, v in ref_lsm.dehydrate(jidx.state).items()},
        "cpu"), device="cpu")
    lanes = []
    fetch = hnsw.prefilter_gather

    def spy(*args, tier=None):
        lanes.append(tier is not None)
        return fetch(*args, tier=tier)

    monkeypatch.setattr(hnsw, "prefilter_gather", spy)
    qs = _ints(rng, (7, jcfg.dim))
    xs = _ints(rng, (24, jcfg.dim))
    if tier:
        pol = dict(hot_frac=0.25, max_demote=jcfg.cap, max_promote=8)
        _assert_same_search(tidx, jidx, qs)      # records heat
        rep = tidx.maintain("tier", policy=TierPolicy(**pol))
        want = jidx.maintain("tier", policy=RefPolicy(**pol))
        assert rep.demoted == want.demoted > 0
    lanes.clear()
    _assert_same_search(tidx, jidx, qs)
    # every loop-route search fetched through the fused op, on its lanes
    assert lanes and set(lanes) == {tier}
    # insert_batch's phase A (untiered lanes under either config)
    draws = _ref_draws(jidx, len(xs))
    tidx._uniforms = lambda n: torch.from_numpy(draws)
    lanes.clear()
    np.testing.assert_array_equal(tidx.insert_batch(xs).ids,
                                  jidx.insert_batch(xs).ids)
    assert lanes and not any(lanes)
    got = hnsw_state_to_numpy(tidx.state)
    want = {k: np.asarray(v)
            for k, v in ref_lsm.dehydrate(jidx.state).items()}
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    _assert_same_search(tidx, jidx, qs)
