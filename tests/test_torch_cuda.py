"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one; the
file imports neither JAX nor the reference, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

`gather_l2` and `gather_l2_q8` are bitwise, on float data too: the
plain versions sum a row in the kernels' order (`gather_l2/ref.py`).
The three SimHash entries are bitwise too: codes are sign bits of f64
dot products and counts are integers.  `l2_distance` is allclose at
rtol 1e-5 with an absolute slack of 1e-3 of the largest squared norm,
for the cancellation in |q|^2 + |c|^2 - 2 q.c, and bitwise on
integer-valued data, where every product and partial sum is exact in
f32 whatever the order.  The beam megakernel
equals, bitwise and on float data too, the port's loop route on the
card (which fetches through `gather_l2` / `gather_l2_q8`) and its plain
version.  `prefilter_gather` (the loop trip's prefilter and fetch in one
launch) is bitwise equal to its plain version, and the loop route that
takes it to the beam megakernel.  The index's overlapped consolidation
(a worker thread on a second stream) leaves the state the serving
stream's consolidation does, bitwise, and its snapshot patches equal a
fresh resolve.  The serving engine on the card answers a short stream as
it does on the CPU, bitwise, and a guarded steady state with the sync
sentinel's CUDA layer on raises nothing.  `l2_distance` and the beam
megakernel keep NaN where their plain versions do (a row of +inf).  The
sharded flat index (its padding rows), a two-shard backend and both
baselines give on the card what they give on the CPU.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import simhash, traversal
from repro_torch.core.hnsw import _snapshot_adj_fn
from repro_torch.kernels.beam.ops import fused_beam_search
from repro_torch.kernels.beam.ref import beam_search_ref
from repro_torch.kernels.gather_l2.ops import (
    gather_l2,
    gather_l2_q8,
    shape_class,
)
from repro_torch.kernels.gather_l2.ref import gather_l2_q8_ref, gather_l2_ref
from repro_torch.kernels.l2_distance.ops import l2_distance
from repro_torch.kernels.l2_distance.ops import shape_class as l2_shape_class
from repro_torch.kernels.l2_distance.ref import l2_distance_ref
from repro_torch.kernels.prefilter_gather.ops import prefilter_gather
from repro_torch.kernels.prefilter_gather.ref import prefilter_gather_ref
from repro_torch.kernels.simhash.ops import (
    collision_count,
    collision_count_rows,
    simhash_encode,
)
from repro_torch.kernels.simhash.ref import (
    collision_count_ref,
    collision_count_rows_ref,
    simhash_encode_ref,
)

torch.set_num_threads(1)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gather_inputs(d, integer, seed, b, k, n):
    rng = np.random.default_rng(seed)
    if integer:
        q = rng.integers(-8, 9, (b, d)).astype(np.float32)
        table = rng.integers(-8, 9, (n, d)).astype(np.float32)
    else:
        q = rng.normal(size=(b, d)).astype(np.float32)
        table = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(-1, n, (b, k)).astype(np.int32)
    ids[0, 0] = -1
    return q, table, ids


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 65, 128, 960])
@pytest.mark.parametrize("k", [1, 7, 8, 9, 16, 48, 100])
@pytest.mark.parametrize("b", [1, 300])
def test_gather_l2_cuda_kernel_matches_plain(b, k, d):
    """Bitwise on integer and float data, on both kernels (a warp per
    pair up to 64 pairs, else 8 ids a warp): a lone query, K below, at
    and past one chunk and not a multiple of it, ragged and wide rows,
    aligned and misaligned operands (the scalar loads)."""
    dev = _cuda()
    for integer in (True, False):
        q, table, ids = (torch.from_numpy(a).to(dev) for a in _gather_inputs(
            d, integer, seed=b * k + d, b=b, k=k, n=3000))
        ref = gather_l2_ref(q, table, ids)
        before, by_class = gather_l2.launches, dict(gather_l2.by_class)
        out = gather_l2(q, table, ids)
        torch.cuda.synchronize()
        assert gather_l2.launches == before + 1
        cls = shape_class(b, k)
        assert gather_l2.by_class[cls] == by_class.get(cls, 0) + 1
        assert torch.equal(out, ref)
        assert torch.equal(gather_l2(_misaligned(q), table, ids), ref)
        assert torch.equal(gather_l2(q, _misaligned(table), ids), ref)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [65, 128])
@pytest.mark.parametrize("c_n", [1, 127, 129, 4097])
@pytest.mark.parametrize("q_n", [1, 63, 64, 65, 128, 1000])
def test_l2_distance_cuda_kernel_matches_plain(q_n, c_n, d):
    """Both tiles (Q <= 64 and Q > 64) at ragged N and d, aligned and
    misaligned operands (cp.async and scalar staging): allclose on float
    data and never negative, bitwise on integer-valued data."""
    dev = _cuda()
    rng = np.random.default_rng(7 * q_n + c_n + d)

    def layouts(q, c):
        return ((q, c), (q, _misaligned(c)), (_misaligned(q), c))

    q, c = (torch.from_numpy((10 * rng.normal(size=(n, d))).astype(
        np.float32)).to(dev) for n in (q_n, c_n))
    scale = max(float((q * q).sum(1).max()), float((c * c).sum(1).max()))
    for qq, cc in layouts(q, c):
        before = l2_distance.launches
        out = l2_distance(qq, cc)
        torch.cuda.synchronize()
        assert l2_distance.launches == before + 1
        torch.testing.assert_close(out, l2_distance_ref(qq, cc), rtol=1e-5,
                                   atol=1e-3 * scale)
        assert bool((out >= 0).all())
    q, c = (torch.from_numpy(rng.integers(-8, 9, (n, d)).astype(
        np.float32)).to(dev) for n in (q_n, c_n))
    ref = l2_distance_ref(q, c)
    for qq, cc in layouts(q, c):
        by_class = dict(l2_distance.by_class)
        assert torch.equal(l2_distance(qq, cc), ref)
        cls = l2_shape_class(q_n)
        assert l2_distance.by_class[cls] == by_class.get(cls, 0) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("d", [65, 128])
@pytest.mark.parametrize("q_n", [7, 300])
def test_l2_distance_cuda_kernel_keeps_nan_like_plain(q_n, d):
    """Rows of +inf (the sharded flat index's padding) and of NaN, among
    candidates and queries, on both tiles: NaN wherever the plain
    version has NaN (inf - inf), and every other entry, the finite ones
    bitwise, as the plain version gives it on integer-valued data."""
    dev = _cuda()
    rng = np.random.default_rng(q_n + d)
    q = rng.integers(-8, 9, (q_n, d)).astype(np.float32)
    c = rng.integers(-8, 9, (513, d)).astype(np.float32)
    c[[3, 200, 512]] = np.inf
    c[77] = np.nan
    c[78, 5] = -np.inf
    q[q_n - 1] = np.inf
    q, c = torch.from_numpy(q).to(dev), torch.from_numpy(c).to(dev)
    ref = l2_distance_ref(q, c)
    for qq, cc in ((q, c), (q, _misaligned(c))):
        out = l2_distance(qq, cc)
        torch.cuda.synchronize()
        assert torch.equal(torch.isnan(out), torch.isnan(ref))
        torch.testing.assert_close(out, ref, rtol=0, atol=0, equal_nan=True)
    assert bool(torch.isnan(ref).any()) and bool(torch.isfinite(ref).any())
    finite = l2_distance(q[:-1].contiguous(), c[:3].contiguous())
    assert torch.equal(finite, l2_distance_ref(q[:-1], c[:3]))


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    q = torch.zeros((2, 8), device=dev)
    table = torch.zeros((4, 8), device=dev)
    ids = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        gather_l2(q, table.cpu(), ids)
    with pytest.raises(TypeError):
        gather_l2(q, table, ids.long())
    with pytest.raises(ValueError):
        gather_l2(q, table[:, :4], ids)
    with pytest.raises(ValueError):
        l2_distance(q, table.T.contiguous().T)
    with pytest.raises(TypeError):
        l2_distance(q.double(), table.double())
    qt = torch.zeros((4, 8), dtype=torch.int8, device=dev)
    sc = torch.ones((4,), device=dev)
    with pytest.raises(TypeError):
        gather_l2_q8(q, qt.float(), sc, ids)
    with pytest.raises(ValueError):
        gather_l2_q8(q, qt, sc[:3], ids)
    with pytest.raises(ValueError):
        gather_l2_q8(q, qt, sc.cpu(), ids)
    w = _beam_world(dev, cap=64, dim=16, M=6, bq=3, floats=False)
    args, opt = w["args"], w["opt"]
    kw = dict(ef=12, k=4, m_bits=64, eps=0.1, rho=1.0, max_iters=24,
              use_filter=True, n_expand=1)
    bad_codes = list(args)
    bad_codes[5] = args[5].int()
    with pytest.raises(TypeError):
        fused_beam_search(*bad_codes, **kw)
    with pytest.raises(ValueError):        # a tier lane missing
        fused_beam_search(*args, resident=opt["resident"],
                          qvecs=opt["qvecs"], **kw)
    with pytest.raises(ValueError):        # more than the kernel holds
        fused_beam_search(*args, **dict(kw, ef=300, max_iters=600))
    with pytest.raises(ValueError):
        fused_beam_search(*args, **dict(kw, ef=48, max_iters=96,
                                        n_expand=40))
    with pytest.raises(ValueError):        # mixed devices
        fused_beam_search(*args[:-1], args[-1].cpu(), **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 65, 128])
def test_gather_l2_q8_cuda_kernel_matches_plain(d):
    dev = _cuda()
    rng = np.random.default_rng(d)
    n, b, k = 5000, 300, 16
    qt = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(
        np.int8)).to(dev)
    ids = torch.from_numpy(rng.integers(-1, n, (b, k)).astype(
        np.int32)).to(dev)
    for exact in (True, False):
        if exact:
            sc = 2.0 ** rng.integers(-3, 3, n)
            q = rng.integers(-20, 21, (b, d))
        else:
            sc = rng.random(n) * 0.1
            q = rng.normal(size=(b, d))
        sc = torch.from_numpy(sc.astype(np.float32)).to(dev)
        q = torch.from_numpy(q.astype(np.float32)).to(dev)
        before = gather_l2_q8.launches
        out = gather_l2_q8(q, qt, sc, ids)
        torch.cuda.synchronize()
        assert gather_l2_q8.launches == before + 1
        assert torch.equal(out, gather_l2_q8_ref(q, qt, sc, ids))


def _misaligned(t):
    """A copy of `t` whose storage starts one element past an aligned
    address, so the kernels take their scalar loads."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 128])
def test_gathers_give_the_same_bits_on_misaligned_rows(d):
    """Where d % 4 == 0 the scalar loads sum a row in the float4 / char4
    order, so a distance's bits depend on d alone."""
    dev = _cuda()
    q, table, ids = (torch.from_numpy(a).to(dev) for a in _gather_inputs(
        d, False, seed=3, b=300, k=16, n=5000))
    rng = np.random.default_rng(4)
    qt = torch.from_numpy(rng.integers(-127, 128, (5000, d)).astype(
        np.int8)).to(dev)
    sc = torch.from_numpy((rng.random(5000) * 0.1).astype(np.float32)).to(dev)
    f32 = gather_l2(q, table, ids)
    q8 = gather_l2_q8(q, qt, sc, ids)
    for qq, tt, qqt in ((_misaligned(q), table, qt),
                        (q, _misaligned(table), _misaligned(qt))):
        assert torch.equal(gather_l2(qq, tt, ids), f32)
        assert torch.equal(gather_l2_q8(qq, qqt, sc, ids), q8)
    assert torch.equal(f32, gather_l2_ref(q, table, ids))
    assert torch.equal(q8, gather_l2_q8_ref(q, qt, sc, ids))


def _beam_world(dev, *, cap, dim, M, bq, floats, seed=0):
    """A random graph and its operands on the card: the snapshot view,
    routable / returnable / resident lanes, a cold lane with power-of-two
    scales, entries and their distances."""
    rng = np.random.default_rng(seed)
    if floats:
        vecs = rng.normal(size=(cap, dim)).astype(np.float32)
        qs = rng.normal(size=(bq, dim)).astype(np.float32)
    else:
        vecs = rng.integers(-8, 8, (cap, dim)).astype(np.float32)
        qs = rng.integers(-8, 8, (bq, dim)).astype(np.float32)
    proj = torch.from_numpy(rng.normal(size=(64, dim)).astype(np.float32))
    live = rng.random(cap) >= 0.05
    entries = rng.choice(np.flatnonzero(live), bq).astype(np.int32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    v, q = t(vecs), t(qs)
    args = [q, t(entries), t(((qs - vecs[entries]) ** 2).sum(1).astype(
                np.float32)),
            t(rng.integers(-1, cap, (cap, M)).astype(np.int32)), v,
            simhash.encode(proj.to(dev), v), simhash.encode(proj.to(dev), q),
            t(live), torch.sqrt((q * q).sum(1).double()).float(),
            torch.sqrt((v * v).sum(1).double()).float().mean()]
    opt = dict(returnable=t(live & (rng.random(cap) >= 0.1)),
               resident=t(rng.random(cap) < 0.5),
               qvecs=t(rng.integers(-127, 128, (cap, dim)).astype(np.int8)),
               qscale=t((2.0 ** rng.integers(-2, 3, cap)).astype(np.float32)),
               active=t(rng.random(bq) >= 0.1))
    return dict(args=args, opt=opt)


def _loop_route(args, opt, *, ef, k, m_bits, eps, rho, max_iters,
                use_filter, n_expand, record_heat=True, fused_fetch=False):
    """The port's loop route over the same operands, fetching through the
    gather kernels, or, with `fused_fetch`, through `prefilter_gather`
    where the trip takes it."""
    qs, entries, entry_d, adj, vecs, codes, code_qs, live, qn, mn = args
    lanes = None if opt.get("resident") is None else (
        opt["resident"], opt["qvecs"], opt["qscale"])

    def fetch_fn(row, eligible, thr):
        return prefilter_gather(qs, vecs, code_qs, codes, row, eligible, thr,
                                tier=lanes)
    if opt.get("resident") is not None:
        res_ = opt["resident"]

        def dist_fn(ids):
            res = res_[ids.clamp_min(0).long()]
            return torch.minimum(
                gather_l2(qs, vecs, torch.where((ids >= 0) & res, ids, -1)),
                gather_l2_q8(qs, opt["qvecs"], opt["qscale"],
                             torch.where((ids >= 0) & ~res, ids, -1)))
    else:
        def dist_fn(ids):
            return gather_l2(qs, vecs, ids)
    r = traversal.beam_search(
        qs, entries, entry_d, _snapshot_adj_fn(adj), dist_fn, codes, code_qs,
        live, cap=adj.shape[0], ef=ef, k=k, m_bits=m_bits, eps=eps, rho=rho,
        max_iters=max_iters, use_filter=use_filter, q_norm=qn, mean_norm=mn,
        n_expand=n_expand, M=adj.shape[1], active=opt.get("active"),
        returnable=opt.get("returnable"),
        fetch_fn=fetch_fn if fused_fetch else None)
    return (r.ids, r.dists, torch.stack(list(r.stats), 1), r.heat_nodes,
            r.heat_mask)


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", ["lazy", "none", "tier", "active"])
@pytest.mark.parametrize("rho,use_filter", [(1.0, True), (0.5, True),
                                            (0.5, False)])
@pytest.mark.parametrize("n_expand", [1, 4])
def test_beam_cuda_kernel_matches_loop_route_and_plain(n_expand, rho,
                                                       use_filter, lanes):
    dev = _cuda()
    for floats in (False, True):
        w = _beam_world(dev, cap=3000, dim=65 if floats else 32, M=8,
                        bq=200, floats=floats, seed=n_expand)
        keep = {"lazy": ["returnable"], "none": [],
                "tier": ["returnable", "resident", "qvecs", "qscale"],
                "active": ["returnable", "active"]}[lanes]
        opt = {n: w["opt"][n] for n in keep}
        kw = dict(ef=24, k=5, m_bits=64, eps=0.1, rho=rho, max_iters=48,
                  use_filter=use_filter, n_expand=n_expand)
        before = fused_beam_search.launches
        got = fused_beam_search(*w["args"], **opt, **kw)
        torch.cuda.synchronize()
        assert fused_beam_search.launches == before + 1
        loop = _loop_route(w["args"], opt, **kw)
        for name, a, b in zip(("ids", "dists", "stats", "heat_nodes",
                               "heat_mask"), got, loop):
            assert torch.equal(a, b), name
        plain = beam_search_ref(*w["args"], **opt, **kw)
        for a, b in zip(got, plain):
            assert torch.equal(a, b)
        assert int(got[2][:, 3].max()) > 1
    off = fused_beam_search(*w["args"], **opt, **kw, record_heat=False)
    for a, b in zip(off[:3], got[:3]):
        assert torch.equal(a, b)
    assert bool((off[3] == -1).all()) and not bool(off[4].any())


@pytest.mark.cuda
@pytest.mark.parametrize("rho", [1.0, 0.5])
@pytest.mark.parametrize("n_expand", [1, 4])
@pytest.mark.parametrize("d", [65, 128])
@pytest.mark.parametrize("bq", [1, 3, 1000])
def test_beam_cuda_kernel_warp_layout(bq, d, n_expand, rho):
    """The warp-per-query layout at query counts that leave the last CTA
    part empty (1, 3) or fill every CTA (1,000), the default M = 16
    (B = 4: two candidates a lane), a ragged and a float4 width, with the
    filter on and off, the lazy lane, the tier split and heat recording
    on and off: bitwise equal to the loop route and the plain version on
    float data."""
    dev = _cuda()
    w = _beam_world(dev, cap=4000, dim=d, M=16, bq=bq, floats=True,
                    seed=bq + d + n_expand)
    for use_filter in (True, False):
        for lanes in ([], ["returnable"],
                      ["returnable", "resident", "qvecs", "qscale"]):
            opt = {n: w["opt"][n] for n in lanes}
            kw = dict(ef=48, k=10, m_bits=64, eps=0.1, rho=rho,
                      max_iters=96, use_filter=use_filter,
                      n_expand=n_expand)
            got = fused_beam_search(*w["args"], **opt, **kw)
            loop = _loop_route(w["args"], opt, **kw)
            plain = beam_search_ref(*w["args"], **opt, **kw)
            torch.cuda.synchronize()
            for name, a, b, c in zip(("ids", "dists", "stats", "heat_nodes",
                                      "heat_mask"), got, loop, plain):
                assert torch.equal(a, b), (name, use_filter, lanes)
                assert torch.equal(a, c), (name, use_filter, lanes)
            assert int(got[2][:, 3].max()) > 1
            off = fused_beam_search(*w["args"], **opt, **kw,
                                    record_heat=False)
            for a, b in zip(off[:3], got[:3]):
                assert torch.equal(a, b)
            assert bool((off[3] == -1).all()) and not bool(off[4].any())


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [32, 128])
def test_beam_cuda_kernel_keeps_a_nan_threshold_like_plain(dim):
    """A table with a row of +inf: its mean norm is inf, the collision
    threshold's cosine inf / inf = NaN, and the plain version's clamp
    keeps NaN, so no neighbour passes the filter while the k-th distance
    is finite.  The kernel must decide the same, bitwise."""
    dev = _cuda()
    w = _beam_world(dev, cap=3000, dim=dim, M=8, bq=200, floats=False,
                    seed=dim)
    qs, entries, entry_d, adj, vecs, codes, code_qs, live, qn, _ = w["args"]
    vecs = vecs.clone()
    vecs[1234] = torch.inf
    mn = torch.sqrt((vecs * vecs).sum(1).double()).float().mean()
    assert torch.isinf(mn)
    args = [qs, entries, entry_d, adj, vecs, codes, code_qs, live, qn, mn]
    for rho, use_filter in ((1.0, True), (0.5, True), (1.0, False)):
        opt = {"returnable": w["opt"]["returnable"]}
        kw = dict(ef=24, k=5, m_bits=64, eps=0.1, rho=rho, max_iters=48,
                  use_filter=use_filter, n_expand=1)
        got = fused_beam_search(*args, **opt, **kw)
        plain = beam_search_ref(*args, **opt, **kw)
        loop = _loop_route(args, opt, **kw)
        torch.cuda.synchronize()
        for name, a, b, c in zip(("ids", "dists", "stats", "heat_nodes",
                                  "heat_mask"), got, plain, loop):
            assert torch.equal(a, b), (name, rho, use_filter)
            assert torch.equal(a, c), (name, rho, use_filter)


def _update_inputs(seed, cap=2000, d=128, M=16):
    rng = np.random.default_rng(seed)
    vecs = rng.normal(size=(cap, d)).astype(np.float32)
    return rng, vecs


@pytest.mark.cuda
@pytest.mark.parametrize("site", ["backlink", "diversity_topm",
                                  "consolidate_rows", "relink", "norm_gram"])
def test_update_paths_card_equals_cpu_on_float_rows(site):
    """The update paths' distances go through gather_l2 on the card and
    its plain version on the CPU: the same bits on float rows, so both
    devices pick the same slots, neighbours and repaired rows."""
    from repro_torch.core import hnsw
    dev = _cuda()
    rng, vecs = _update_inputs(len(site))
    cap, d = vecs.shape
    M = 16

    def run(device):
        v = torch.from_numpy(vecs).to(device)
        if site == "backlink":
            rows = torch.from_numpy(rng_rows).to(device)
            return (hnsw._backlink(rows, v, v[7], 1999),)
        if site == "diversity_topm":
            ids = torch.from_numpy(rng_ids).to(device)
            dists = gather_l2(v[:300], v, ids)
            return hnsw._diversity_topm(ids, dists, v, M)
        if site == "consolidate_rows":
            adj = torch.from_numpy(rng_adj).to(device)
            tomb = torch.from_numpy(rng_tomb).to(device)
            return hnsw._consolidate_rows(v, adj, tomb, ~tomb, ~tomb, M, 512)
        if site == "relink":
            cfg = hnsw.HNSWConfig(cap=cap, dim=d)
            st = hnsw.init(cfg, torch.zeros((cfg.m_bits, d)), device)
            st = st._replace(vectors=v)
            st.levels[:] = 0
            cand = torch.from_numpy(rng_cand).to(device)
            return hnsw._relink(st, cand, cand[-M:], 5, 0, M)
        return hnsw._norm(v), hnsw._gram(v[:1024])

    rng_rows = rng.integers(-1, cap, (M, M)).astype(np.int32)
    rng_ids = rng.integers(-1, cap, (300, 3 * M)).astype(np.int32)
    rng_adj = rng.integers(-1, cap, (cap, M)).astype(np.int32)
    rng_tomb = rng.random(cap) < 0.02
    rng_cand = rng.integers(-1, cap, (M * M + M,)).astype(np.int32)
    card, cpu = run(dev), run("cpu")
    torch.cuda.synchronize()
    for a, b in zip(card, cpu):
        assert torch.equal(a.cpu(), b), site


@pytest.mark.cuda
@pytest.mark.parametrize("m_bits", [32, 64, 128, 256])
@pytest.mark.parametrize("d", [16, 65, 128, 256])
def test_simhash_cuda_kernels_match_plain(d, m_bits):
    """Float data at ragged shapes: N not a multiple of a tile (and 0),
    the narrow tile (16 rows) and the wide one (128 rows, from 16,896 rows
    on), d not a whole DMMA step, one to eight words, m x d past what
    shared memory holds (d = 256, m = 256); ids past both ends of the
    table."""
    dev = _cuda()
    rng = np.random.default_rng(d + m_bits)
    proj = torch.from_numpy(rng.normal(size=(m_bits, d)).astype(
        np.float32)).to(dev)
    for n in (0, 1, 7, 15, 16, 17, 300, 1000, 1024, 4097, 131072):
        x = torch.from_numpy(rng.normal(size=(n, d)).astype(
            np.float32)).to(dev)
        if n:
            x[0] = 0.0                      # every sign of a zero row is +
        before = simhash_encode.launches
        codes = simhash_encode(x, proj)
        torch.cuda.synchronize()
        assert simhash_encode.launches == before + (n > 0)
        assert codes.dtype == torch.int64 and codes.shape == (n, m_bits // 32)
        assert torch.equal(codes, simhash_encode_ref(x, proj)), n
        if n:
            assert int(codes[0].min()) == 2 ** 32 - 1
        if n == 1000:
            table = codes                                 # [1000, W]
    for nq in (1, 17, 300):
        cq = simhash_encode(torch.from_numpy(rng.normal(size=(nq, d)).astype(
            np.float32)).to(dev), proj)
        before = collision_count.launches
        allp = collision_count(cq, table, m_bits)
        torch.cuda.synchronize()
        assert collision_count.launches == before + 1
        assert torch.equal(allp, collision_count_ref(cq, table, m_bits))
        ids = torch.from_numpy(rng.integers(-3, 1003, (nq, 48)).astype(
            np.int32)).to(dev)
        ids[0, :4] = torch.tensor([0, 999, 1000, -1], dtype=torch.int32)
        before = collision_count_rows.launches
        rows = collision_count_rows(cq, table, ids, m_bits)
        torch.cuda.synchronize()
        assert collision_count_rows.launches == before + 1
        assert torch.equal(rows, collision_count_rows_ref(cq, table, ids,
                                                          m_bits))
        # the gathered form is the all-pairs form at the (clamped) ids
        assert torch.equal(rows, allp.gather(1, ids.clamp(0, 999).long()))
    assert collision_count(cq, table[:0], m_bits).shape == (nq, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["unaligned", "many_words", "exact_zeros"])
def test_simhash_cuda_encode_edges_match_plain(case):
    """Bitwise against the plain version: a row block that is not 16-byte
    aligned (x[1:] at d = 65: 4-byte loads), 2,048 projections (more than
    shared memory holds: staged per pass), and integer rows and
    projections whose projections are exactly 0 for every third row
    (every bit of those rows set), on both tiles."""
    dev = _cuda()
    rng = np.random.default_rng(11)

    def t(a):
        return torch.from_numpy(a.astype(np.float32)).to(dev)

    if case == "unaligned":
        x = t(rng.normal(size=(1001, 65)))[1:]
        assert x.data_ptr() % 16 != 0 and x.is_contiguous()
        shapes = [(x, t(rng.normal(size=(64, 65))))]
    elif case == "many_words":
        proj = t(rng.normal(size=(2048, 128)))
        shapes = [(t(rng.normal(size=(n, 128))), proj) for n in (17, 4097)]
    else:
        shapes = []
        for n in (4097, 20000):
            x = rng.integers(-3, 4, (n, 128))
            proj = rng.integers(-3, 4, (64, 128))
            proj[:, 64:] = proj[:, :64]
            x[::3, 64:] = -x[::3, :64]
            shapes.append((t(x), t(proj)))
    for x, proj in shapes:
        codes = simhash_encode(x, proj)
        torch.cuda.synchronize()
        assert torch.equal(codes, simhash_encode_ref(x, proj))
        if case == "exact_zeros":
            assert bool((codes[::3] == 2 ** 32 - 1).all())


@pytest.mark.cuda
def test_simhash_cuda_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    x = torch.zeros((4, 16), device=dev)
    proj = torch.zeros((64, 16), device=dev)
    codes = torch.zeros((4, 2), dtype=torch.int64, device=dev)
    ids = torch.zeros((4, 3), dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        simhash_encode(x.double(), proj.double())
    with pytest.raises(ValueError):
        simhash_encode(x, proj[:40])
    with pytest.raises(ValueError):
        simhash_encode(x, proj.cpu())
    with pytest.raises(ValueError):
        collision_count(codes, codes, 96)
    with pytest.raises(ValueError):
        collision_count(codes.int(), codes.int(), 64)
    with pytest.raises(ValueError):
        collision_count_rows(codes, codes, ids.long(), 64)
    with pytest.raises(ValueError):
        collision_count_rows(codes, codes.T.contiguous().T, ids, 64)


def _prefilter_inputs(dev, *, b, n, d, cap, seed, floats=True):
    """A trip's operands on the card: queries, rows, codes, a row block
    with -1 ids, ids that are not eligible, Hoeffding-like thresholds
    (-inf on every fifth query) and the tier lanes."""
    rng = np.random.default_rng(seed)
    if floats:
        q = rng.normal(size=(b, d))
        table = rng.normal(size=(cap, d))
    else:
        q = rng.integers(-8, 9, (b, d))
        table = rng.integers(-8, 9, (cap, d))
    row = rng.integers(0, cap, (b, n)).astype(np.int32)
    row[rng.random((b, n)) < 0.1] = -1
    eligible = (row >= 0) & (rng.random((b, n)) < 0.75)
    thr = rng.uniform(20.0, 34.0, b).astype(np.float32)
    thr[::5] = -np.inf

    def t(a, dtype=None):
        a = np.ascontiguousarray(a if dtype is None else a.astype(dtype))
        return torch.from_numpy(a).to(dev)

    args = (t(q, np.float32), t(table, np.float32),
            t(rng.integers(0, 2 ** 32, (b, 2))),
            t(rng.integers(0, 2 ** 32, (cap, 2))), t(row), t(eligible),
            t(thr))
    tier = (t(rng.random(cap) < 0.5),
            t(rng.integers(-127, 128, (cap, d)), np.int8),
            t(rng.random(cap) * 0.1, np.float32))
    return args, tier


@pytest.mark.cuda
@pytest.mark.parametrize("tier", [False, True])
@pytest.mark.parametrize("d", [65, 128])
@pytest.mark.parametrize("b,n", [(1000, 16), (1024, 16), (1, 16), (250, 64),
                                 (7, 9)])
def test_prefilter_gather_cuda_kernel_matches_plain(b, n, d, tier):
    """Bitwise on float data, mask and distances: a search trip's
    [1,000, 16], an insert batch's [1,024, 16], a lone item's [1, 16],
    n_expand = 4's [Q, 64] and a ragged chunk; aligned and misaligned
    operands (the scalar loads)."""
    dev = _cuda()
    args, lanes = _prefilter_inputs(dev, b=b, n=n, d=d, cap=20000,
                                    seed=b + n + d)
    lanes = lanes if tier else None
    prefilter_gather.launches = 0
    prefilter_gather.by_class.clear()
    mask, dists = prefilter_gather(*args, tier=lanes)
    torch.cuda.synchronize()
    assert prefilter_gather.launches == 1
    assert dict(prefilter_gather.by_class) == {"tier" if tier else "f32": 1}
    want = prefilter_gather_ref(*args, tier=lanes)
    assert torch.equal(mask, want[0])
    assert torch.equal(dists, want[1])
    if b * n > 100:
        assert bool(mask.any()) and bool((args[5] & ~mask).any())
    q, table = args[0], args[1]
    moved = (_misaligned(q), _misaligned(table)) + args[2:]
    m2, d2 = prefilter_gather(*moved, tier=None if lanes is None else (
        lanes[0], _misaligned(lanes[1]), lanes[2]))
    assert torch.equal(m2, mask) and torch.equal(d2, dists)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [65, 128])
@pytest.mark.parametrize("k", [1, 7, 8, 9, 16, 64])
@pytest.mark.parametrize("b", [1, 1000])
def test_gather_l2_q8_chunked_kernel_matches_plain(b, k, d):
    """The redesigned cold-lane gather (8 ids a warp) at chunk edges,
    bitwise on float data, misaligned too."""
    dev = _cuda()
    rng = np.random.default_rng(b + k + d)
    n = 20000
    qt = torch.from_numpy(rng.integers(-127, 128, (n, d)).astype(
        np.int8)).to(dev)
    sc = torch.from_numpy((rng.random(n) * 0.1).astype(np.float32)).to(dev)
    ids = torch.from_numpy(rng.integers(-1, n, (b, k)).astype(
        np.int32)).to(dev)
    q = torch.from_numpy(rng.normal(size=(b, d)).astype(np.float32)).to(dev)
    gather_l2_q8.launches = 0
    out = gather_l2_q8(q, qt, sc, ids)
    torch.cuda.synchronize()
    assert gather_l2_q8.launches == 1
    assert torch.equal(out, gather_l2_q8_ref(q, qt, sc, ids))
    assert torch.equal(gather_l2_q8(_misaligned(q), _misaligned(qt), sc, ids),
                       out)


@pytest.mark.cuda
@pytest.mark.parametrize("m_bits", [32, 64, 96, 128])
def test_collision_count_rows_code_loads_match_plain(m_bits):
    """The gathered count with 16-byte code-row loads (W even, aligned)
    and with word loads (W odd, or a table one word off alignment)."""
    dev = _cuda()
    rng = np.random.default_rng(m_bits)
    words = m_bits // 32
    codes = torch.from_numpy(rng.integers(0, 2 ** 32, (5000, words))).to(dev)
    cq = torch.from_numpy(rng.integers(0, 2 ** 32, (300, words))).to(dev)
    ids = torch.from_numpy(rng.integers(-2, 5002, (300, 16)).astype(
        np.int32)).to(dev)
    want = collision_count_rows_ref(cq, codes, ids, m_bits)
    collision_count_rows.launches = 0
    for c, q in ((codes, cq), (_misaligned(codes), cq),
                 (codes, _misaligned(cq))):
        assert torch.equal(collision_count_rows(q, c, ids, m_bits), want)
    torch.cuda.synchronize()
    assert collision_count_rows.launches == 3


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", ["lazy", "tier", "active"])
@pytest.mark.parametrize("n_expand", [1, 4])
def test_loop_route_with_fused_fetch_matches_beam_kernel(n_expand, lanes):
    """The loop route taking prefilter_gather (filter on, rho = 1): one
    launch a trip, no separate collision count, and bitwise the beam
    megakernel's and the separate route's results on float data."""
    dev = _cuda()
    w = _beam_world(dev, cap=3000, dim=65, M=8, bq=200, floats=True,
                    seed=7 + n_expand)
    keep = {"lazy": ["returnable"],
            "tier": ["returnable", "resident", "qvecs", "qscale"],
            "active": ["returnable", "active"]}[lanes]
    opt = {n: w["opt"][n] for n in keep}
    kw = dict(ef=24, k=5, m_bits=64, eps=0.1, rho=1.0, max_iters=48,
              use_filter=True, n_expand=n_expand)
    prefilter_gather.launches = 0
    collision_count_rows.launches = 0
    fused = _loop_route(w["args"], opt, fused_fetch=True, **kw)
    torch.cuda.synchronize()
    assert prefilter_gather.launches > 3
    assert collision_count_rows.launches == 0
    separate = _loop_route(w["args"], opt, **kw)
    megakernel = fused_beam_search(*w["args"], **opt, **kw)
    for name, a, b, c in zip(("ids", "dists", "stats", "heat_nodes",
                              "heat_mask"), fused, separate, megakernel):
        assert torch.equal(a, b), name
        assert torch.equal(a, c), name


def _card_index(dev, n=1200, cap=4096, dim=32, seed=3):
    from repro_torch.core.hnsw import HNSWConfig
    from repro_torch.core.index import LSMVecIndex
    from repro_torch.data.synth import make_clustered_vectors
    cfg = HNSWConfig(cap=cap, dim=dim, M=8, M_up=4, ef_search=24,
                     ef_construction=24)
    data = make_clustered_vectors(n + 256, dim, seed=seed, clusters=8)
    idx = LSMVecIndex.build(cfg, data[:n], seed=seed, device=dev)
    return idx, data[n:]


def _same_state(a, b):
    from repro_torch.core import lsm
    sa, sb = lsm.dehydrate(a.state), lsm.dehydrate(b.state)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k


@pytest.mark.cuda
def test_side_stream_repair_equals_the_serving_stream_repair():
    """begin_maintain's repair (a second stream, driven by a worker
    thread) gives the state of maintain("consolidate") on the serving
    stream, bitwise; searches served meanwhile leave it alone, and the
    searches' handles turn ready."""
    from repro_torch.core.backend import SearchParams
    dev = _cuda()
    idx, extra = _card_index(dev)
    idx.delete_batch(np.arange(0, 1200, 7))
    sync = idx.clone()
    assert idx.begin_maintain("consolidate")
    assert idx._pending_repair.side != torch.cuda.current_stream()
    handles = []
    while True:
        rep = idx.poll_maintain()
        if rep is not None:
            break
        handles.append(idx.dispatch_search(
            extra[:64], params=SearchParams(use_snapshot=True)))
        if len(handles) > 50:
            rep = idx.poll_maintain(block=True)
            break
    assert rep is not None and rep.reclaimed == len(range(0, 1200, 7))
    want = sync.maintain("consolidate")
    assert want.reclaimed == rep.reclaimed
    torch.cuda.synchronize()
    _same_state(idx, sync)
    assert all(h.is_ready() for h in handles)
    assert idx.trace_counts()["consolidate_bg"] > 0


@pytest.mark.cuda
def test_card_patched_snapshot_and_variants_settle():
    """On the card: each insert_batch's patched snapshot equals a fresh
    resolve, and the kernel variants each entry point takes stop growing
    after warm-up at a fixed pad width."""
    from repro_torch.core import lsm
    from repro_torch.core.backend import SearchParams
    dev = _cuda()
    idx, extra = _card_index(dev)
    p = SearchParams(use_snapshot=True, pad_to=64)
    counts = []
    for r in range(4):
        idx.search(extra[:50], params=p)
        idx.search(extra[:30])
        idx.insert_batch(extra[64 * r:64 * r + 40], pad_to=64)
        fresh = lsm.snapshot_rows(idx.cfg.lsm_cfg, idx.state.store,
                                  idx.cfg.cap)
        assert torch.equal(idx._snap, fresh)
        counts.append(idx.trace_counts())
    assert idx.snap_patches == 4
    assert counts[-1] == counts[-2]
    assert counts[-1]["search_snapshot"] > 0
    assert counts[-1]["insert_batch_snapshot"] > 0


def _serve_pair(dev, *, n=600, cap=4096, dim=32, seed=5):
    """Two engines over one built state, on the CPU and on the card (the
    build runs once, on the CPU, and its tensors are copied over), and
    the integer rows the stream draws from."""
    from repro_torch.core import lsm
    from repro_torch.core.hnsw import HNSWConfig
    from repro_torch.core.index import LSMVecIndex
    from repro_torch.serve import MaintenancePolicy, ServeConfig, ServeEngine
    rng = np.random.default_rng(seed)
    rows = rng.integers(-3, 4, (n + 512, dim)).astype(np.float32)
    cfg = HNSWConfig(cap=cap, dim=dim, M=8, M_up=4, ef_search=24,
                     ef_construction=24, fused_beam=True)
    cpu = LSMVecIndex.build(cfg, rows[:n], seed=seed, device="cpu")
    card = LSMVecIndex(cfg, seed=seed, device=dev, state=lsm.hydrate(
        cpu.state, {k: t.to(dev) for k, t in
                    lsm.dehydrate(cpu.state).items()}))
    card._rng.set_state(cpu._rng.get_state())
    scfg = ServeConfig(query_batch=32, insert_batch=32, delete_batch=32,
                       maintenance=MaintenancePolicy(
                           tombstone_ratio=None, consolidate_ratio=0.02,
                           heat_budget=None, check_every=2))
    return (ServeEngine(cpu, scfg), ServeEngine(card, scfg), rows[n:], n)


def _serve_rounds(eng, rows, rng, n_rounds, next_del):
    """Rounds of mixed traffic: a few queries, then an insert or a delete
    of a live external id; each round drained.  Returns the tickets."""
    out = []
    for r in range(n_rounds):
        for _ in range(int(rng.integers(1, 40))):
            out.append(eng.submit_query(rows[int(rng.integers(0, len(rows)))]))
        if r % 2 == 0:
            for _ in range(int(rng.integers(1, 40))):
                out.append(eng.submit_insert(
                    rows[int(rng.integers(0, len(rows)))] + 1))
        else:
            for _ in range(int(rng.integers(1, 40))):
                out.append(eng.submit_delete(next_del[0]))
                next_del[0] += 1
        eng.drain()
    return out


@pytest.mark.cuda
def test_card_serves_a_stream_as_the_cpu_does():
    """One short served stream (queries through the beam megakernel,
    inserts, lazy deletes, an overlapped consolidation on the second
    stream): every ticket, the batch log and the final state on the
    card equal the CPU's, bitwise."""
    dev = _cuda()
    cpu, card, rows, _ = _serve_pair(dev)
    got = {}
    for name, eng in (("cpu", cpu), ("card", card)):
        got[name] = [t.result(timeout=120) for t in _serve_rounds(
            eng, rows, np.random.default_rng(1), 10, [0])]
    for a, b in zip(got["cpu"], got["card"]):
        if hasattr(a, "ids"):
            np.testing.assert_array_equal(a.ids, b.ids)
            np.testing.assert_array_equal(a.dists, b.dists)
        else:
            assert a == b
    assert len(got["cpu"]) == len(got["card"])
    assert card.batch_log == cpu.batch_log
    assert card.metrics.maintenance_runs["consolidate"] \
        == cpu.metrics.maintenance_runs["consolidate"] > 0
    torch.cuda.synchronize()
    from repro_torch.core import lsm
    sa, sb = lsm.dehydrate(cpu.backend.state), lsm.dehydrate(
        card.backend.state)
    for k in sa:
        assert torch.equal(sa[k], sb[k].cpu()), k


@pytest.mark.cuda
def test_guarded_steady_state_on_the_card():
    """Serving after warm-up under `forbid_undeclared_sync()` with both
    layers on (the CUDA layer is `set_sync_debug_mode("error")`): nothing
    raises, no new kernel variant is launched, and a consolidation
    overlapped on the second stream runs inside the guarded phase."""
    from repro_torch.core.sentinel import (
        declared_sync,
        forbid_undeclared_sync,
        reset_sync_counts,
        sync_counts,
    )
    dev = _cuda()
    _, card, rows, _ = _serve_pair(dev)
    rng, next_del = np.random.default_rng(2), [0]
    _serve_rounds(card, rows, rng, 12, next_del)
    warm = card.backend.trace_counts()
    before = card.metrics.maintenance_runs["consolidate"]
    assert torch.cuda.get_sync_debug_mode() == 0
    reset_sync_counts()
    with forbid_undeclared_sync():
        assert torch.cuda.get_sync_debug_mode() == 2
        with declared_sync("test escape"):
            assert torch.cuda.get_sync_debug_mode() == 0
        assert torch.cuda.get_sync_debug_mode() == 2
        tickets = _serve_rounds(card, rows, rng, 12, next_del)
    assert torch.cuda.get_sync_debug_mode() == 0
    assert all(t.done for t in tickets)
    assert card.backend.trace_counts() == warm
    assert card.metrics.maintenance_runs["consolidate"] > before
    counts = sync_counts()
    for reason in ("search result materialization", "greedy-descent step",
                   "insert_batch host loop", "repair worker reads",
                   "stats surface fetch"):
        assert counts.get(reason, 0) > 0, (reason, counts)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 3, 7, 8])
def test_sharded_flat_card_equals_cpu_with_padding(p):
    """The flat index's last shard padded with +inf rows (5,003 rows):
    on the card the padded rows' distances are NaN, mapped to +inf, and
    ids and dists equal the CPU's bitwise on integer-valued rows."""
    from repro_torch.core.distributed import ShardedFlatIndex
    dev = _cuda()
    rng = np.random.default_rng(p)
    data = rng.integers(-8, 9, (5003, 128)).astype(np.float32)
    qs = rng.integers(-8, 9, (100, 128)).astype(np.float32)
    before = l2_distance.launches
    got = ShardedFlatIndex(p, devices=[dev]).build(data).search(qs, k=16)
    assert l2_distance.launches == before + p
    want = ShardedFlatIndex(p, devices=["cpu"]).build(data).search(qs, k=16)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    assert got[0].shape == (100, 10) and got[0].max() < len(data)


def _state_equal(a, b):
    from repro_torch.bridge import sharded_backend_to_numpy
    sa, sb = sharded_backend_to_numpy(a), sharded_backend_to_numpy(b)
    assert sa.keys() == sb.keys()
    for k in sa:
        np.testing.assert_array_equal(sa[k], sb[k], err_msg=k)


@pytest.mark.cuda
def test_sharded_backend_card_equals_cpu():
    """Two shards on the card and on the CPU, from one seed over
    integer-valued rows: build, searches on the loop and snapshot
    routes, padded inserts, lazy deletes, an overlapped consolidation
    (each shard's repair on its side stream), compaction and reordering:
    every id, distance, perm and state field bitwise."""
    from repro_torch.core.backend import SearchParams
    from repro_torch.core.distributed import ShardedBackend
    from repro_torch.core.hnsw import HNSWConfig
    dev = _cuda()
    cfg = HNSWConfig(cap=2048, dim=65)
    rng = np.random.default_rng(5)
    base = rng.integers(-4, 5, (1200, 65)).astype(np.float32)
    xs = rng.integers(-4, 5, (128, 65)).astype(np.float32)
    qs = rng.integers(-4, 5, (64, 65)).astype(np.float32)
    bes = [ShardedBackend(cfg, 2, devices=[d]).build(base, seed=3)
           for d in (dev, "cpu")]

    def both(fn):
        out = [fn(be) for be in bes]
        torch.cuda.synchronize()
        return out

    def same_search():
        for kw in (dict(), dict(use_snapshot=True, pad_to=64)):
            a, b = both(lambda be: be.search(qs, 10,
                                             params=SearchParams(**kw)))
            np.testing.assert_array_equal(a.ids, b.ids)
            np.testing.assert_array_equal(a.dists, b.dists)

    same_search()
    a, b = both(lambda be: be.insert_batch(xs, pad_to=64))
    np.testing.assert_array_equal(a.ids, b.ids)
    dels = bes[1].initial_ids()[::40]
    both(lambda be: be.delete_batch(dels, pad_to=32))
    same_search()
    assert all(both(lambda be: be.begin_maintain("consolidate")))
    same_search()
    a, b = both(lambda be: be.poll_maintain(block=True))
    assert a.reclaimed == b.reclaimed == len(dels)
    _state_equal(*bes)
    both(lambda be: be.maintain("compact"))
    a, b = both(lambda be: be.maintain("reorder"))
    np.testing.assert_array_equal(a.perm, b.perm)
    _state_equal(*bes)
    same_search()
    assert bes[0].stats() == bes[1].stats()


@pytest.mark.cuda
def test_diskann_card_equals_cpu():
    """The build's distance blocks through the kernel: the graph, the
    searches and the inserts equal the CPU's, integer-valued rows."""
    from repro_torch.core.baselines import DiskANNIndex
    dev = _cuda()
    rng = np.random.default_rng(6)
    base = rng.integers(-4, 5, (2500, 128)).astype(np.float32)
    qs = rng.integers(-4, 5, (40, 128)).astype(np.float32)
    before = l2_distance.launches
    idx = [DiskANNIndex.build(base, M=12, ef=48, seed=2, device=d)
           for d in (dev, "cpu")]
    assert l2_distance.launches == before + 3     # blocks of 1,024
    assert idx[0].entry == idx[1].entry
    for a, b in zip(idx[0].adj, idx[1].adj):
        np.testing.assert_array_equal(a, b)
    for x in qs[:10]:
        assert idx[0].insert(x) == idx[1].insert(x)
    for a, b in zip(idx[0].search(qs), idx[1].search(qs)):
        np.testing.assert_array_equal(a, b)
    assert [int(v) for v in idx[0].io_stats] \
        == [int(v) for v in idx[1].io_stats]


@pytest.mark.cuda
def test_spfresh_card_equals_cpu():
    """k-means assignments and probes through the kernel: postings and
    search ids equal the CPU's, except where a row's two nearest
    centroids (a query's last probed and first unprobed) lie within
    1e-5 relative of each other (the count is printed)."""
    from repro_torch.core.baselines import SPFreshIndex
    from repro_torch.data.synth import make_clustered_vectors
    dev = _cuda()
    data = make_clustered_vectors(8192, 128, seed=4)
    qs = make_clustered_vectors(100, 128, seed=8)
    idx = [SPFreshIndex.build(data[:8000], posting_cap=64, n_probe=3,
                              seed=1, device=d) for d in (dev, "cpu")]

    def near_tie(d, rank):
        s = np.sort(d)
        return s[rank + 1] - s[rank] <= 1e-5 * s[rank + 1]

    def owners(ix):
        own = np.full(len(ix.vectors), -1)
        for c, p in enumerate(ix.postings):
            own[np.asarray(p, np.int64)] = c
        return own
    for x in data[8000:]:
        assert idx[0].insert(x) == idx[1].insert(x)
    apart = np.flatnonzero(owners(idx[0]) != owners(idx[1]))
    for r in apart:
        assert near_tie(((idx[1].centroids - data[r]) ** 2).sum(1), 0)
    (ia, da), (ib, db) = idx[0].search(qs), idx[1].search(qs)
    rows = np.flatnonzero((ia != ib).any(1))
    for i in rows:
        assert near_tie(((idx[1].centroids - qs[i]) ** 2).sum(1), 2)
    print(f"SPFresh card vs CPU rows apart: postings {len(apart)}, "
          f"search {len(rows)}")
    same = np.setdiff1d(np.arange(len(qs)), rows)
    np.testing.assert_array_equal(da[same], db[same])
