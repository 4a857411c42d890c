"""The port's fused beam search (`kernels/beam`) against the reference's.

`beam_search_ref` of the port runs on the CPU here: the route
`ops.fused_beam_search` takes for CPU tensors and the plain version the
CUDA kernel is held against on the card.  The reference side is
`repro.kernels.beam.ref.beam_search_ref` under a plain jit, at the
operand shapes of `tests/test_beam_kernel.py` (cap 64, dim 16, M 6,
5 query lanes, ef 12, k 4).  Vectors are integer-valued, so every
distance is exact in f32 whatever the summation order, and ids, dists,
IOStats and heat lanes are compared bitwise; one float case compares
ids exactly and dists at 1e-5.  The same worlds also run through the
port's own loop route (`traversal.beam_search` over the snapshot
adjacency and `gather_l2`), which the fused route must equal bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import simhash as jax_simhash
from repro.kernels.beam.ref import beam_iter_cap as jax_iter_cap
from repro.kernels.beam.ref import beam_search_ref as jax_beam_ref
from repro_torch.core import traversal
from repro_torch.core.hnsw import _snapshot_adj_fn
from repro_torch.kernels.beam.ops import beam_iter_cap, fused_beam_search
from repro_torch.kernels.gather_l2.ops import gather_l2, gather_l2_q8

torch.set_num_threads(1)

EPS = 0.1
_jax_ref = jax.jit(jax_beam_ref, static_argnames=(
    "ef", "k", "m_bits", "eps", "rho", "max_iters", "use_filter",
    "n_expand", "record_heat"))


def _world(seed=0, cap=64, dim=16, M=6, bq=5, m_bits=64, dead=0.1,
           tomb=0.2, floats=False):
    """Dense operands as numpy, the same for both packages."""
    rng = np.random.default_rng(seed)
    if floats:
        vectors = rng.normal(size=(cap, dim)).astype(np.float32)
        qs = rng.normal(size=(bq, dim)).astype(np.float32)
    else:
        vectors = rng.integers(-8, 8, (cap, dim)).astype(np.float32)
        qs = rng.integers(-8, 8, (bq, dim)).astype(np.float32)
    proj = rng.normal(size=(m_bits, dim)).astype(np.float32)
    params = jax_simhash.SimHashParams(jnp.asarray(proj))
    live = rng.random(cap) >= dead
    entries = rng.integers(0, cap, (bq,)).astype(np.int32)
    return dict(
        qs=qs, entries=entries,
        entry_dists=((qs - vectors[entries]) ** 2).sum(1).astype(np.float32),
        adjacency=rng.integers(-1, cap, (cap, M)).astype(np.int32),
        vectors=vectors,
        codes=np.asarray(jax_simhash.encode(params, jnp.asarray(vectors))),
        code_qs=np.asarray(jax_simhash.encode(params, jnp.asarray(qs))),
        live=live,
        q_norms=np.sqrt((qs * qs).sum(1)).astype(np.float32),
        mean_norm=np.float32(np.sqrt(dim) * 4.0),
        returnable=live & (rng.random(cap) >= tomb))


def _tier_lanes(w, seed):
    rng = np.random.default_rng(seed)
    cap, dim = w["vectors"].shape
    return dict(
        resident=rng.random(cap) < 0.5,
        qvecs=rng.integers(-127, 128, (cap, dim)).astype(np.int8),
        # power-of-two scales keep the cold distances exact
        qscale=(2.0 ** rng.integers(-2, 3, cap)).astype(np.float32))


_ARGS = ("qs", "entries", "entry_dists", "adjacency", "vectors", "codes",
         "code_qs", "live", "q_norms", "mean_norm")


def _run_jax(w, opt, **kw):
    res = _jax_ref(*(jnp.asarray(w[a]) for a in _ARGS),
                   **{n: None if v is None else jnp.asarray(v)
                      for n, v in opt.items()},
                   eps=EPS, m_bits=64, **kw)
    return [np.asarray(a) for a in res]


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                            else a.copy())


def _run_port(w, opt, **kw):
    res = fused_beam_search(*(_t(w[a]) for a in _ARGS),
                            **{n: None if v is None else _t(v)
                               for n, v in opt.items()},
                            eps=EPS, m_bits=64, **kw)
    return [a.numpy() for a in res]


def _run_port_loop(w, opt, *, ef, k, rho, max_iters, use_filter, n_expand):
    """The port's loop route over the same operands: snapshot adjacency,
    `gather_l2` (and the int8 lane under the tier split)."""
    t = {a: _t(w[a]) for a in _ARGS}
    qs, vectors = t["qs"], t["vectors"]
    if opt.get("resident") is not None:
        res_, qv, qsc = (_t(opt[n]) for n in ("resident", "qvecs", "qscale"))

        def dist_fn(ids):
            res = res_[ids.clamp_min(0).long()]
            hot = torch.where((ids >= 0) & res, ids, -1)
            cold = torch.where((ids >= 0) & ~res, ids, -1)
            return torch.minimum(gather_l2(qs, vectors, hot),
                                 gather_l2_q8(qs, qv, qsc, cold))
    else:
        def dist_fn(ids):
            return gather_l2(qs, vectors, ids)
    out = traversal.beam_search(
        qs, t["entries"], t["entry_dists"], _snapshot_adj_fn(t["adjacency"]),
        dist_fn, t["codes"], t["code_qs"], t["live"],
        cap=vectors.shape[0], ef=ef, k=k, m_bits=64, eps=EPS, rho=rho,
        max_iters=max_iters, use_filter=use_filter, q_norm=t["q_norms"],
        mean_norm=t["mean_norm"], n_expand=n_expand,
        M=t["adjacency"].shape[1],
        active=None if opt.get("active") is None else _t(opt["active"]),
        returnable=(None if opt.get("returnable") is None
                    else _t(opt["returnable"])))
    return [out.ids.numpy(), out.dists.numpy(),
            torch.stack(list(out.stats), 1).numpy(), out.heat_nodes.numpy(),
            out.heat_mask.numpy()]


def _assert_bitwise(got, want, names=("ids", "dists", "stats", "heat_nodes",
                                      "heat_mask")):
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def _kw(ef=12, k=4, rho=1.0, use_filter=False, n_expand=1):
    return dict(ef=ef, k=k, rho=rho, use_filter=use_filter,
                n_expand=n_expand, max_iters=2 * ef)


@pytest.mark.parametrize("rho", [1.0, 0.5])
@pytest.mark.parametrize("use_filter", [False, True])
@pytest.mark.parametrize("n_expand", [1, 3])
def test_beam_ref_matches_reference_matrix(n_expand, use_filter, rho):
    """Lazy lane on: port ref == reference ref == port loop route."""
    w = _world(seed=n_expand * 10 + use_filter)
    kw = _kw(rho=rho, use_filter=use_filter, n_expand=n_expand)
    opt = dict(returnable=w["returnable"])
    got = _run_port(w, opt, **kw)
    _assert_bitwise(got, _run_jax(w, opt, **kw))
    _assert_bitwise(got, _run_port_loop(w, opt, **kw))
    stats = got[2]
    assert (stats[:, 3] > 1).all()        # every lane expanded past its entry
    if use_filter:
        assert stats[:, 2].sum() > 0      # the filter skipped candidates


def test_beam_ref_without_lazy_lane():
    w = _world(seed=21)
    kw = _kw(n_expand=2)
    got = _run_port(w, {}, **kw)
    _assert_bitwise(got, _run_jax(w, {}, **kw))
    _assert_bitwise(got, _run_port_loop(w, {}, **kw))


def test_beam_ref_tier_mixed_lanes():
    """Hot rows exact, cold rows through the dequantising int8 lane."""
    w = _world(seed=5)
    opt = dict(returnable=w["returnable"], **_tier_lanes(w, 5))
    kw = _kw(n_expand=2)
    got = _run_port(w, opt, **kw)
    _assert_bitwise(got, _run_jax(w, opt, **kw))
    _assert_bitwise(got, _run_port_loop(w, opt, **kw))
    # the cold lane really answered: the same search all-hot differs
    all_hot = dict(opt, resident=np.ones_like(opt["resident"]))
    assert not np.array_equal(_run_port(w, all_hot, **kw)[1], got[1])


def test_beam_ref_masked_pad_lanes():
    w = _world(seed=6, bq=6)
    opt = dict(active=np.array([True, True, False, True, False, True]))
    kw = _kw()
    got = _run_port(w, opt, **kw)
    _assert_bitwise(got, _run_jax(w, opt, **kw))
    _assert_bitwise(got, _run_port_loop(w, opt, **kw))
    ids, dists, stats, heat_nodes, _ = got
    off = ~opt["active"]
    assert (ids[off] == -1).all() and np.isinf(dists[off]).all()
    assert (stats[off] == 0).all() and (heat_nodes[off] == -1).all()


def test_beam_ref_record_heat_false():
    w = _world(seed=8)
    kw = _kw(n_expand=2)
    on = _run_port(w, {}, record_heat=True, **kw)
    off = _run_port(w, {}, record_heat=False, **kw)
    _assert_bitwise(off, _run_jax(w, {}, record_heat=False, **kw))
    _assert_bitwise(off[:3], on[:3])
    assert (off[3] == -1).all() and not off[4].any()
    assert (on[3] >= 0).any()


def test_beam_ref_all_filtered_frontier():
    """No neighbor anywhere: the entry is expanded and is the result."""
    w = _world(seed=3)
    w["adjacency"] = np.full_like(w["adjacency"], -1)
    kw = _kw(n_expand=2)
    got = _run_port(w, {}, **kw)
    _assert_bitwise(got, _run_jax(w, {}, **kw))
    np.testing.assert_array_equal(got[0][:, 0], w["entries"])
    assert (got[0][:, 1:] == -1).all()


def test_beam_ref_float_data_close():
    """Float vectors: ids identical, dists within 1e-5 (the reference and
    the port sum a row in different orders)."""
    w = _world(seed=7, floats=True)
    opt = dict(returnable=w["returnable"])
    kw = _kw(n_expand=2)
    got = _run_port(w, opt, **kw)
    want = _run_jax(w, opt, **kw)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], rtol=1e-5, atol=1e-5)
    # the port's two routes share gather_l2_ref: bitwise even on floats
    _assert_bitwise(got, _run_port_loop(w, opt, **kw))


def test_beam_iter_cap_matches_reference():
    for mi in (1, 7, 24, 96):
        for ne in (1, 2, 5, 64):
            for ef in (4, 12, 48):
                assert beam_iter_cap(mi, ne, ef) == jax_iter_cap(mi, ne, ef)
