"""The port's batched beam search and greedy descent against the
reference's vmapped `while_loop`s.

One random graph over integer-valued vectors (every distance an exact
integer in f32, ties everywhere), searched by a block of query lanes.
Across n_expand x rho x use_filter x active x returnable, ids, dists,
per-lane IOStats and the heat lanes are bitwise equal: the port breaks
ties toward the lower index exactly as `lax.top_k`/`argmin` do, and a
finished lane stays frozen as it does under vmap.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import simhash as jax_simhash
from repro.core import traversal as ref
from repro.kernels.gather_l2.ops import gather_l2 as jax_gather_l2
from repro_torch.core import simhash, traversal
from repro_torch.kernels.gather_l2.ops import gather_l2

torch.set_num_threads(1)

CAP, DIM, M, EF, K, M_BITS, NQ = 300, 16, 8, 16, 4, 64, 10


@pytest.fixture(scope="module")
def graph():
    rng = np.random.default_rng(11)
    vecs = rng.integers(-4, 5, (CAP, DIM)).astype(np.float32)
    adj = rng.integers(0, CAP, (CAP, M)).astype(np.int32)
    adj[rng.random((CAP, M)) < 0.1] = -1
    live = rng.random(CAP) > 0.05
    returnable = live & (rng.random(CAP) > 0.1)
    proj = rng.normal(size=(M_BITS, DIM)).astype(np.float32)
    codes = np.asarray(jax_simhash.encode(
        jax_simhash.SimHashParams(jnp.asarray(proj)), jnp.asarray(vecs)))
    qs = rng.integers(-4, 5, (NQ, DIM)).astype(np.float32)
    entry = rng.choice(np.flatnonzero(live), NQ).astype(np.int32)
    entry_d = ((qs - vecs[entry]) ** 2).sum(1).astype(np.float32)
    active = np.ones(NQ, bool)
    active[[2, 7]] = False
    q_codes = np.asarray(jax_simhash.encode(
        jax_simhash.SimHashParams(jnp.asarray(proj)), jnp.asarray(qs)))
    return dict(vecs=vecs, adj=adj, live=live, returnable=returnable,
                codes=codes, qs=qs, entry=entry, entry_d=entry_d,
                active=active, q_codes=q_codes,
                q_norm=np.sqrt((qs * qs).sum(1)).astype(np.float32),
                mean_norm=np.float32(np.sqrt((vecs * vecs).sum(1)).mean()))


@functools.lru_cache(maxsize=None)
def _ref_fn(n_expand, rho, use_filter):
    """The reference, jitted once per static combination.  It always
    gets `active` and `returnable` arrays: all-True lanes and
    returnable == live give the same answers as None, so one compile
    serves the port's None and array cases alike."""

    def one(q, e, ed, cq, qn, a, ret, adj, vecs, codes, live, mean_norm):
        def adj_fn(nodes):
            rows = adj[jnp.maximum(nodes, 0)]
            return jnp.where((nodes >= 0)[:, None], rows, -1), \
                jnp.ones_like(nodes)

        return ref.beam_search(
            q, e, ed, adj_fn,
            lambda ids: jax_gather_l2(q[None, :], vecs, ids[None, :])[0],
            codes, cq, live, cap=CAP, ef=EF, k=K, m_bits=M_BITS, eps=0.1,
            rho=rho, max_iters=2 * EF, use_filter=use_filter, q_norm=qn,
            mean_norm=mean_norm, n_expand=n_expand, active=a,
            returnable=ret)

    return jax.jit(jax.vmap(one, in_axes=(0,) * 6 + (None,) * 6))


def _ref_search(g, n_expand, rho, use_filter, with_active, with_ret):
    active = g["active"] if with_active else np.ones(NQ, bool)
    ret = g["returnable"] if with_ret else g["live"]
    args = [g[k] for k in ("qs", "entry", "entry_d", "q_codes", "q_norm")]
    args += [active, ret]
    args += [g[k] for k in ("adj", "vecs", "codes", "live", "mean_norm")]
    res = _ref_fn(n_expand, rho, use_filter)(*map(jnp.asarray, args))
    return jax.tree.map(np.asarray, res)


def _port_search(g, n_expand, rho, use_filter, with_active, with_ret):
    t = {k: torch.from_numpy(np.array(v)) for k, v in g.items()}
    adj = t["adj"]

    def adj_fn(nodes):
        rows = adj[nodes.clamp_min(0).long()]
        return torch.where((nodes >= 0)[..., None], rows, -1), \
            torch.ones_like(nodes)

    return traversal.beam_search(
        t["qs"], t["entry"], t["entry_d"], adj_fn,
        lambda ids: gather_l2(t["qs"], t["vecs"], ids),
        t["codes"].to(torch.int64), t["q_codes"].to(torch.int64), t["live"],
        cap=CAP, ef=EF, k=K, m_bits=M_BITS, eps=0.1, rho=rho,
        max_iters=2 * EF, use_filter=use_filter, q_norm=t["q_norm"],
        mean_norm=t["mean_norm"], n_expand=n_expand, M=M,
        active=t["active"] if with_active else None,
        returnable=t["returnable"] if with_ret else None)


@pytest.mark.parametrize("with_active,with_ret",
                         [(False, False), (True, True), (True, False),
                          (False, True)])
@pytest.mark.parametrize("use_filter", [False, True])
@pytest.mark.parametrize("rho", [1.0, 0.5])
@pytest.mark.parametrize("n_expand", [1, 4])
def test_beam_search_bitwise(graph, n_expand, rho, use_filter, with_active,
                             with_ret):
    want = _ref_search(graph, n_expand, rho, use_filter, with_active,
                       with_ret)
    got = _port_search(graph, n_expand, rho, use_filter, with_active,
                       with_ret)
    np.testing.assert_array_equal(got.ids.numpy(), want.ids)
    np.testing.assert_array_equal(got.dists.numpy(), want.dists)
    for name, a, b in zip(want.stats._fields, got.stats, want.stats):
        np.testing.assert_array_equal(a.numpy(), b, err_msg=name)
    np.testing.assert_array_equal(got.heat_nodes.numpy(), want.heat_nodes)
    np.testing.assert_array_equal(got.heat_mask.numpy(), want.heat_mask)
    assert (want.stats.n_hops > 1).sum() >= NQ - 2
    if with_active:
        off = ~graph["active"]
        assert (got.ids.numpy()[off] == -1).all()
        assert (got.stats.n_vec.numpy()[off] == 0).all()


def test_greedy_descent_bitwise(graph):
    g = graph
    adj = g["adj"][:, :4]
    up = functools.partial(ref.greedy_descent, adj=jnp.asarray(adj),
                           vectors=jnp.asarray(g["vecs"]),
                           live=jnp.asarray(g["live"]))
    ep, d = jax.vmap(lambda q, e, ed: up(q, e, ed))(
        jnp.asarray(g["qs"]), jnp.asarray(g["entry"]),
        jnp.asarray(g["entry_d"]))
    t_ep, t_d = traversal.greedy_descent(
        torch.from_numpy(g["qs"]), torch.from_numpy(g["entry"]),
        torch.from_numpy(g["entry_d"]), torch.from_numpy(adj),
        torch.from_numpy(g["vecs"]), torch.from_numpy(g["live"]))
    np.testing.assert_array_equal(t_ep.numpy(), np.asarray(ep))
    np.testing.assert_array_equal(t_d.numpy(), np.asarray(d))
    assert (t_ep.numpy() != g["entry"]).any()


def test_rank_and_topk_break_ties_like_lax():
    x = torch.tensor([[1.0, 1.0, 0.0, 1.0, float("inf"), 0.0]])
    vals, idx = traversal.stable_topk_asc(x, 4)
    neg, want = jax.lax.top_k(-jnp.asarray(x.numpy()), 4)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want))
    np.testing.assert_array_equal(vals.numpy(), -np.asarray(neg))
    score = torch.tensor([[3, -1, 3, 5, -1, 0]], dtype=torch.int32)
    np.testing.assert_array_equal(
        traversal._rank_desc(score).numpy()[0],
        np.asarray(ref._rank_desc(jnp.asarray(score.numpy()[0]))))
    assert simhash.collisions(torch.zeros((1, 2), dtype=torch.int64),
                              torch.zeros((1, 2), dtype=torch.int64),
                              64).tolist() == [64]
