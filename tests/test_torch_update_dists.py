"""One row-distance order in the port's update paths, on float data.

Every squared distance that `insert_batch`, `consolidate` and the eager
delete compute goes through `gather_l2`, whose plain version sums a row
in the CUDA kernels' order (`gather_l2/ref.py::_warp_sq_sum`), so the
card and the CPU write the same graph on float data too.  Each site is
run on `rng.normal` rows with `hnsw.gather_l2` wrapped: it must call the
gather for its distances, and every distance it got must equal, bitwise,
a direct `_warp_sq_sum` of the query row minus the table row.  The norms
(the distance to the origin) and the in-batch Gram matrix are checked
the same way.

The loop beam search counts SimHash collisions only where a decision
reads them: `use_filter=False, rho=1.0` launches no
`collision_count_rows`, any other setting one per trip, and the results
equal the plain fused version's (which always counts) either way.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import hnsw, simhash, traversal
from repro_torch.core.hnsw import _snapshot_adj_fn
from repro_torch.kernels.beam.ref import beam_search_ref
from repro_torch.kernels.gather_l2.ops import gather_l2
from repro_torch.kernels.gather_l2.ref import _warp_sq_sum

torch.set_num_threads(1)

CAP, DIM, M = 400, 128, 16


def _floats(seed, n=CAP, d=DIM):
    rng = np.random.default_rng(seed)
    return rng, torch.from_numpy(rng.normal(size=(n, d)).astype(np.float32))


@pytest.fixture
def spy(monkeypatch):
    """Every (queries, table, ids, out) `hnsw` hands the gather."""
    calls = []

    def recording(queries, table, ids):
        out = gather_l2(queries, table, ids)
        calls.append((queries.clone(), table, ids.clone(), out))
        return out

    monkeypatch.setattr(hnsw, "gather_l2", recording)
    return calls


def _direct(queries, table, ids):
    rows = table[ids.clamp_min(0).long()]
    return torch.where(ids >= 0, _warp_sq_sum(queries[:, None, :] - rows),
                       torch.inf)


def _check_calls(calls, n_min=1):
    assert len(calls) >= n_min
    for queries, table, ids, out in calls:
        assert torch.equal(out, _direct(queries, table, ids))


def test_direct_warp_sum_differs_from_a_plain_sum_on_this_data():
    """The data below tells the two orders apart, so the bitwise checks
    test the order and not just the values."""
    _, vecs = _floats(0)
    d = vecs[1:] - vecs[:1]
    assert not torch.equal(_warp_sq_sum(d), (d * d).sum(-1))


def test_diversity_topm_sums_in_the_gather_order(spy):
    rng, vecs = _floats(1)
    ids = torch.from_numpy(rng.integers(-1, CAP, (20, 3 * M)).astype(
        np.int32))
    x = vecs[:20]
    dists = torch.where(ids >= 0, _direct(x, vecs, ids), torch.inf)
    got_ids, got_d = hnsw._diversity_topm_block(ids, dists, vecs, M)
    assert len(spy) == 1
    queries, _, pair_ids, out = spy[0]
    order = torch.sort(dists, dim=1, stable=True).indices
    ids_s = ids.gather(1, order)
    # the b*C candidate rows, each against its block row's C candidates
    assert torch.equal(queries,
                       vecs[ids_s.clamp_min(0).long()].reshape(-1, DIM))
    assert torch.equal(pair_ids, ids_s.repeat_interleave(3 * M, 0))
    _check_calls(spy)
    assert got_ids.shape == (20, M) and bool((got_ids >= 0).any())


def test_backlink_sums_in_the_gather_order(spy):
    rng, vecs = _floats(2)
    rows = torch.from_numpy(rng.integers(-1, CAP, (M, M)).astype(np.int32))
    x = vecs[7]
    new_rows = hnsw._backlink(rows, vecs, x, 999)
    assert len(spy) == 1
    _check_calls(spy)
    d = _direct(x[None], vecs, rows.reshape(1, -1)).reshape(M, M)
    slots = torch.where(rows < 0, torch.inf, -d).argmax(1)
    want = rows.clone()
    want[torch.arange(M), slots] = 999
    assert torch.equal(new_rows, want)


def test_consolidate_rows_sum_in_the_gather_order(spy):
    rng, vecs = _floats(3)
    adj = torch.from_numpy(rng.integers(-1, CAP, (CAP, M)).astype(np.int32))
    tomb = torch.from_numpy(rng.random(CAP) < 0.03)
    keep = ~tomb
    new_adj, changed, n_dist = hnsw._consolidate_rows(
        vecs, adj, tomb, keep, keep, M, block=64)
    n_blocks = -(-int(changed.sum()) // 64)
    assert n_blocks >= 2
    # per block: the candidates' distances to the row, then the
    # candidates' pairwise matrix
    assert len(spy) == 2 * n_blocks
    _check_calls(spy)
    rows = torch.nonzero(changed).flatten()
    assert torch.equal(spy[0][0], vecs[rows[:64]])
    assert bool((new_adj[changed] != adj[changed]).any())
    assert int(n_dist) > 0


def test_eager_relink_sums_in_the_gather_order(spy):
    rng, vecs = _floats(4)
    cfg = hnsw.HNSWConfig(cap=CAP, dim=DIM)
    state = hnsw.init(cfg, torch.zeros((cfg.m_bits, DIM)), "cpu")
    state = state._replace(vectors=vecs)
    state.levels[:] = 0
    cand = torch.from_numpy(rng.integers(-1, CAP, (M * M + M,)).astype(
        np.int32))
    nbr = cand[-M:]
    rows, d = hnsw._relink(state, cand, nbr, 5, 0, M)
    assert len(spy) == 1
    _check_calls(spy)
    assert rows.shape == (M, M)


def test_norm_and_gram_have_one_order():
    _, x = _floats(5, n=33)
    assert torch.equal(hnsw._norm(x),
                       torch.sqrt(_warp_sq_sum(x).double()).float())
    assert torch.equal(hnsw._norm(x[3]), hnsw._norm(x)[3])
    g = torch.zeros((33, 33))
    for c in range(DIM):
        g = g + x[:, c, None] * x[None, :, c]
    assert torch.equal(hnsw._gram(x), g)


def _graph(seed=6, cap=300, dim=24, m=8, nq=12, m_bits=64):
    rng = np.random.default_rng(seed)
    vecs = torch.from_numpy(rng.normal(size=(cap, dim)).astype(np.float32))
    qs = torch.from_numpy(rng.normal(size=(nq, dim)).astype(np.float32))
    adj = torch.from_numpy(rng.integers(-1, cap, (cap, m)).astype(np.int32))
    proj = torch.from_numpy(rng.normal(size=(m_bits, dim)).astype(
        np.float32))
    live = torch.from_numpy(rng.random(cap) > 0.05)
    entries = torch.from_numpy(rng.choice(np.flatnonzero(live.numpy()),
                                          nq).astype(np.int32))
    return dict(
        qs=qs, entries=entries,
        entry_d=gather_l2(qs, vecs, entries[:, None])[:, 0], adj=adj,
        vecs=vecs, codes=simhash.encode(proj, vecs),
        code_qs=simhash.encode(proj, qs), live=live,
        q_norms=hnsw._norm(qs), mean_norm=hnsw._norm(vecs).mean())


@pytest.mark.parametrize("n_expand", [1, 4])
@pytest.mark.parametrize("use_filter,rho,counted", [
    (False, 1.0, False), (True, 1.0, True), (False, 0.5, True),
    (True, 0.5, True)])
def test_loop_counts_collisions_only_where_read(monkeypatch, use_filter, rho,
                                                counted, n_expand):
    g = _graph()
    calls, trips = [0], [0]
    count_rows = traversal.collision_count_rows
    host_any = traversal.host_any

    def counting(*args):
        calls[0] += 1
        return count_rows(*args)

    def tripping(x):
        trips[0] += 1
        return host_any(x)

    monkeypatch.setattr(traversal, "collision_count_rows", counting)
    monkeypatch.setattr(traversal, "host_any", tripping)
    kw = dict(ef=16, k=4, m_bits=64, eps=0.1, rho=rho, max_iters=32,
              use_filter=use_filter, n_expand=n_expand)
    res = traversal.beam_search(
        g["qs"], g["entries"], g["entry_d"], _snapshot_adj_fn(g["adj"]),
        lambda ids: gather_l2(g["qs"], g["vecs"], ids), g["codes"],
        g["code_qs"], g["live"], cap=g["adj"].shape[0], q_norm=g["q_norms"],
        mean_norm=g["mean_norm"], M=g["adj"].shape[1], **kw)
    # every trip but the last host read runs the loop body once
    assert trips[0] > 2
    assert calls[0] == (trips[0] - 1 if counted else 0)
    want = beam_search_ref(g["qs"], g["entries"], g["entry_d"], g["adj"],
                           g["vecs"], g["codes"], g["code_qs"], g["live"],
                           g["q_norms"], g["mean_norm"], **kw)
    got = (res.ids, res.dists, torch.stack(list(res.stats), 1),
           res.heat_nodes, res.heat_mask)
    for name, a, b in zip(("ids", "dists", "stats", "heat_nodes",
                           "heat_mask"), got, want):
        assert torch.equal(a, b), name
