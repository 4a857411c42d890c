"""Hybrid memory/disk hierarchical proximity graph (paper §3.2), on tensors.

The counterpart of `repro.core.hnsw`: lazy (tombstone + consolidate) or
eager (Algorithm 2) deletion, with the tiered store (`tier`) and the
fused beam megakernel (`fused_beam`) as options.  Upper HNSW layers are
memory-resident dense adjacency tensors; the bottom layer lives in the
LSM tree, so every structural update is an out-of-place LSM write.
Vectors sit in one id-sorted tensor fetched by offset through the
`gather_l2` kernel; SimHash codes are memory-resident.

Randomness is injected: `init` takes the SimHash projections `proj`,
and `insert`/`insert_batch`/`bulk_build` take the level uniforms in
[1e-7, 1), so a test can feed the reference's draws.  Data-dependent
control flow that the reference runs under `lax.cond`/`lax.scan` is
decided on the host from a few scalar reads per call.  Functions return
a new state; tensors of the input state are updated in place where
that avoids copying cap-sized arrays (the reference donates them).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from repro_torch.core import lsm, simhash
from repro_torch.core.backend import MemoryBreakdown
from repro_torch.core.iostats import IOStats
from repro_torch.core.traversal import (
    INF,
    BeamResult,
    beam_search,
    greedy_descent,
    stable_topk_asc,
)
from repro_torch.kernels.beam.ops import fused_beam_search
from repro_torch.kernels.gather_l2.ops import gather_l2, gather_l2_q8
from repro_torch.kernels.l2_distance.ops import l2_distance
from repro_torch.kernels.prefilter_gather.ops import prefilter_gather

_I32 = torch.int32


class HNSWConfig(NamedTuple):
    cap: int                 # id-space size (max nodes ever allocated)
    dim: int
    M: int = 16              # bottom-layer degree (LSM row width)
    M_up: int = 8            # upper-layer degree
    num_upper: int = 3       # number of memory-resident upper layers
    ef_search: int = 48
    ef_construction: int = 48
    k: int = 10
    m_bits: int = 64         # SimHash code width
    rho: float = 1.0         # sampling ratio (Eq. 8); 1.0 = no sampling
    eps: float = 0.1         # Hoeffding miss probability (Eq. 6)
    use_filter: bool = True  # hash-threshold filtering on top of rho
    lsm_mem_cap: int = 256
    lsm_levels: int = 3
    lsm_fanout: int = 8
    n_expand: int = 1        # query-path multi-expansion width (B); 1 = classic
    batch_expand: int = 4    # multi-expansion width for insert_batch searches
    #: two-phase lazy deletion: delete only sets a tombstone bit and
    #: `consolidate` splices tombstones out later.  False: the eager
    #: Algorithm-2 route relinks each deleted node's neighbors at once.
    lazy_delete: bool = True
    #: two-lane tiered store: cold nodes answer beam expansions from the
    #: int8 quantized lane and the final candidate window is reranked
    #: against full-precision rows from the cold store.
    tier: bool = False
    #: width of the exact-rerank window over the beam result (clamped to
    #: ef_search).  Recall loss from cold-lane quantization is bounded by
    #: this window: any true neighbor the approximate beam ranks within
    #: the top `rerank` gets its exact distance back before the final cut.
    rerank: int = 32
    #: fused beam-search megakernel: run the whole bottom-layer beam loop
    #: for a query block in one launch (`repro_torch.kernels.beam`)
    #: instead of the batched Python loop.  Only the snapshot serving path
    #: routes through it (plain LSM-probe searches keep the loop); results
    #: are the same either way, so flipping this never changes answers.
    fused_beam: bool = False
    #: scale on the Exp(1) level draw: P(level >= 1) = exp(-1/level_scale)
    level_scale: float = 1.0

    @property
    def lsm_cfg(self) -> lsm.LSMConfig:
        # last level must hold every node's adjacency row
        need = self.cap
        base = max(self.lsm_mem_cap, 64)
        fan = self.lsm_fanout
        lv = self.lsm_levels
        while base * fan ** lv < need:
            fan += 1
        return lsm.LSMConfig(mem_cap=base, num_levels=lv, fanout=fan,
                             row_width=self.M)

    @property
    def max_iters(self) -> int:
        return 2 * self.ef_search

    @property
    def words(self) -> int:
        return self.m_bits // 32


class HNSWState(NamedTuple):
    vectors: torch.Tensor      # f32[cap, dim] — "disk" array, ID-sorted
    norms: torch.Tensor        # f32[cap]
    codes: torch.Tensor        # int64[cap, W] — uint32 words, memory-resident
    levels: torch.Tensor       # int32[cap]: -1 absent/deleted, else 0..num_upper
    upper_adj: torch.Tensor    # int32[num_upper, cap, M_up]
    store: lsm.LSMState        # bottom-layer adjacency
    proj: torch.Tensor         # f32[m_bits, dim] — SimHash projections
    count: torch.Tensor        # int32[] — ids allocated so far
    n_live: torch.Tensor       # int32[]
    entry: torch.Tensor        # int32[]
    max_level: torch.Tensor    # int32[]
    mean_norm: torch.Tensor    # f32[]
    heat: torch.Tensor         # int32[cap, M] — sampled edge heat (§3.4)
    # lazy-deletion lane: tombstoned nodes keep levels >= 0 (routable)
    # but are masked out of result heaps until `consolidate`
    tombstone: torch.Tensor    # bool[cap]
    n_tombstones: torch.Tensor  # int32[]
    n_delete_noops: torch.Tensor  # int32[] — deletes of absent/dead ids
    # tiered hot/cold lanes: `hot` marks nodes whose dense f32 row is
    # RAM-resident; cold nodes are served from (qvecs, qscale) — per-row
    # absmax int8 — and only touch the full-precision row at rerank.
    # `tier_heat` is the demotion policy's EWMA of per-node heat.
    hot: torch.Tensor          # bool[cap] — True = dense lane resident
    qvecs: torch.Tensor        # int8[cap, dim] — cold-lane codes
    qscale: torch.Tensor       # f32[cap] — cold-lane per-row scales
    tier_heat: torch.Tensor    # f32[cap] — heat EWMA (policy state)


def init(cfg: HNSWConfig, proj: torch.Tensor, device=None) -> HNSWState:
    """Empty index state; `proj` f32[m_bits, dim] are the SimHash
    projections (the reference draws them from its key)."""
    proj = torch.as_tensor(proj, dtype=torch.float32, device=device)
    if tuple(proj.shape) != (cfg.m_bits, cfg.dim):
        raise ValueError(f"proj shape {tuple(proj.shape)} != "
                         f"({cfg.m_bits}, {cfg.dim})")
    device = proj.device

    def scalar(v, dtype=_I32):
        return torch.tensor(v, dtype=dtype, device=device)

    return HNSWState(
        vectors=torch.zeros((cfg.cap, cfg.dim), dtype=torch.float32,
                            device=device),
        norms=torch.zeros((cfg.cap,), dtype=torch.float32, device=device),
        codes=torch.zeros((cfg.cap, cfg.words), dtype=torch.int64,
                          device=device),
        levels=torch.full((cfg.cap,), -1, dtype=_I32, device=device),
        upper_adj=torch.full((cfg.num_upper, cfg.cap, cfg.M_up), -1,
                             dtype=_I32, device=device),
        store=lsm.init(cfg.lsm_cfg, device),
        proj=proj,
        count=scalar(0), n_live=scalar(0), entry=scalar(-1),
        max_level=scalar(0), mean_norm=scalar(1.0, torch.float32),
        heat=torch.zeros((cfg.cap, cfg.M), dtype=_I32, device=device),
        tombstone=torch.zeros((cfg.cap,), dtype=torch.bool, device=device),
        n_tombstones=scalar(0), n_delete_noops=scalar(0),
        hot=torch.ones((cfg.cap,), dtype=torch.bool, device=device),
        qvecs=torch.zeros((cfg.cap, cfg.dim), dtype=torch.int8,
                          device=device),
        qscale=torch.zeros((cfg.cap,), dtype=torch.float32, device=device),
        tier_heat=torch.zeros((cfg.cap,), dtype=torch.float32,
                              device=device))


# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------

def _fma32(a, b, c):
    """f32 a*b + c rounded once, as the reference's compiled arithmetic
    contracts it (the product of two f32 values is exact in f64)."""
    return (a.double() * b.double() + c.double()).float()


def _norm(x: torch.Tensor) -> torch.Tensor:
    """Row norms sqrt(sum(x*x)) with a correctly rounded square root, as
    the reference's: PyTorch's CPU f32 sqrt can be one ulp off, so the
    root is taken in f64 (exact for an f32 input) and rounded once.  The
    sum of squares is the distance to the origin through the gather
    kernel, so a norm has the same bits on every device."""
    rows = x.reshape(-1, x.shape[-1]).contiguous()
    origin = torch.zeros((1, rows.shape[1]), dtype=torch.float32,
                         device=x.device)
    sq = gather_l2(rows, origin, torch.zeros((rows.shape[0], 1), dtype=_I32,
                                             device=x.device))
    return torch.sqrt(sq.double()).float().reshape(x.shape[:-1])


def _gram(x: torch.Tensor) -> torch.Tensor:
    """x @ x.T with each dot product summed column by column, one rounded
    product and one rounded add at a time: the same bits on every device
    (a BLAS product sums in an order of its own, so on float data the
    card and the CPU would pick other in-batch neighbors)."""
    acc = torch.zeros((x.shape[0], x.shape[0]), dtype=torch.float32,
                      device=x.device)
    for c in range(x.shape[1]):
        col = x[:, c]
        acc = acc + col[:, None] * col[None, :]
    return acc


def _mean_update(mean: float, n_live: int, xnorm: float) -> np.float32:
    """The running mean-norm update (mean * n + |x|) / max(n + 1, 1) in
    f32, with the reference's fused multiply-add."""
    num = np.float32(np.float64(np.float32(mean)) * np.float64(n_live)
                     + np.float64(np.float32(xnorm)))
    return np.float32(num / np.float32(max(n_live + 1, 1)))


def _set_rows(t: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor,
              ok: torch.Tensor) -> None:
    """In place t[idx[j]] = vals[j] where ok[j]; other entries write
    nothing (the reference's `mode="drop"` scatter).  Entries with ok
    must target distinct rows.  Dropped entries are redirected onto the
    first ok entry (same row, same value), or onto a write-back of a
    row's own value when none is ok, so the scatter stays deterministic
    on every device."""
    j0 = ok.to(torch.int8).argmax()
    any_ok = ok.any()
    fill = torch.where(any_ok, vals[j0], t[idx[j0]])
    bshape = (-1,) + (1,) * (vals.dim() - 1)
    t[torch.where(ok, idx, idx[j0])] = torch.where(
        ok.reshape(bshape), vals, fill)


def _last_writer(keys: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """Values such that a scatter of (keys, vals) with repeated keys
    lands the last entry's value for each key on every device."""
    n = keys.shape[0]
    pos = torch.arange(n, device=keys.device)
    eq = keys[:, None] == keys[None, :]
    last = torch.where(eq, pos[None, :], -1).amax(1)
    return vals[last]


def _row_dists(vectors: torch.Tensor, qs: torch.Tensor,
               ids: torch.Tensor) -> torch.Tensor:
    """Squared L2 from each row of qs [n, dim] to vectors[ids] (ids [n, m],
    +inf where ids < 0), through the gather kernel: every distance of the
    update paths sums in `row_dist.cuh`'s order, on the card and in its
    plain version on the CPU, so both devices write the same graph."""
    return gather_l2(qs.contiguous(), vectors, ids.to(_I32).contiguous())


def _dist_fn(state: HNSWState, qs: torch.Tensor):
    """ids int32[Bq, n] -> squared L2 f32[Bq, n]; -1 ids cost nothing
    (+inf).  The fused gather+distance kernel: the "disk fetch"."""
    qs = qs.contiguous()

    def fn(ids):
        return gather_l2(qs, state.vectors, ids.contiguous())
    return fn


def _exact_resident(state: HNSWState) -> torch.Tensor:
    """bool[cap]: nodes whose f32 row is RAM-resident.

    Hot-lane nodes by definition; upper-layer nodes too, because their
    rows are already in the resident upper routing cache regardless of
    lane — demoting one only drops its bottom-lane dense copy.
    """
    return state.hot | (state.levels > 0)


def _tier_dist_fn(state: HNSWState, qs: torch.Tensor,
                  resident: torch.Tensor):
    """Mixed-lane distance: exact for resident rows (`resident`, from
    `_exact_resident`), dequant+L2 for cold.

    Each id hits exactly one lane (the other contributes +inf), so the
    lanes merge with an elementwise min.  Cold distances are approximate;
    `_tier_rerank` restores exactness for the final candidate window.
    """
    qs = qs.contiguous()

    def fn(ids):
        res = resident[ids.clamp_min(0).long()]
        hot_ids = torch.where((ids >= 0) & res, ids, -1)
        cold_ids = torch.where((ids >= 0) & ~res, ids, -1)
        return torch.minimum(
            gather_l2(qs, state.vectors, hot_ids),
            gather_l2_q8(qs, state.qvecs, state.qscale, cold_ids))
    return fn


def _fetch_fn(state: HNSWState, qs: torch.Tensor, code_q: torch.Tensor):
    """(row, eligible, thr) -> (fetch_mask, dists): a loop-beam trip's
    SimHash prefilter and the fetch of its survivors in one
    `prefilter_gather` launch (the `fetch_fn` of `beam_search`)."""
    qs, code_q = qs.contiguous(), code_q.contiguous()

    def fn(row, eligible, thr):
        return prefilter_gather(qs, state.vectors, code_q, state.codes, row,
                                eligible, thr)
    return fn


def _tier_fetch_fn(state: HNSWState, qs: torch.Tensor,
                   code_q: torch.Tensor, resident: torch.Tensor):
    """`_fetch_fn` over both lanes: a survivor's distance from its f32 row
    where it is resident, else from its int8 row, as `_tier_dist_fn`
    scores it."""
    qs, code_q = qs.contiguous(), code_q.contiguous()
    tier = (resident, state.qvecs, state.qscale)

    def fn(row, eligible, thr):
        return prefilter_gather(qs, state.vectors, code_q, state.codes, row,
                                eligible, thr, tier=tier)
    return fn


def _tier_rerank(cfg: HNSWConfig, state: HNSWState, qs: torch.Tensor,
                 res: BeamResult) -> BeamResult:
    """Exact rerank of the top-`cfg.rerank` beam window (the tier
    contract), for every lane: cold candidates get their full-precision
    row fetched from the cold store (one modeled disk read each, counted
    in n_vec), the window re-sorts on exact distances (stable, as
    `lax.top_k`), and everything past the window keeps its approximate
    ordering."""
    r = max(1, min(cfg.rerank, res.ids.shape[1]))
    ids_r = res.ids[:, :r]
    cold = (ids_r >= 0) & ~_exact_resident(state)[ids_r.clamp_min(0).long()]
    fetch = torch.where(cold, ids_r, -1)
    d_exact = gather_l2(qs.contiguous(), state.vectors, fetch)
    d_new, order = stable_topk_asc(
        torch.where(cold, d_exact, res.dists[:, :r]), r)
    ids = res.ids.clone()
    ids[:, :r] = ids_r.gather(1, order)
    dists = res.dists.clone()
    dists[:, :r] = d_new
    stats = res.stats._replace(
        n_vec=res.stats.n_vec + cold.sum(1, dtype=_I32))
    return res._replace(ids=ids, dists=dists, stats=stats)


def _bottom_adj_fn(cfg: HNSWConfig, state: HNSWState):
    """Batched bottom-layer adjacency: node ids -> one LSM batch lookup."""
    def fn(nodes):
        found, rows, probes = lsm.get_batch(cfg.lsm_cfg, state.store,
                                            nodes.reshape(-1))
        rows = torch.where(found[:, None], rows, -1)
        return rows.reshape(*nodes.shape, cfg.M), probes.reshape(nodes.shape)
    return fn


def _snapshot_adj_fn(snapshot: torch.Tensor):
    """Adjacency served from a resolved dense view (`lsm.snapshot_rows`):
    row-for-row identical to `_bottom_adj_fn` against the frozen tree,
    but each read is one gather.  `n_probes` keeps the 1-read-per-row
    cost model of `lsm.get`."""
    def fn(nodes):
        rows = snapshot[nodes.clamp_min(0).long()]
        return torch.where((nodes >= 0)[..., None], rows, -1), \
            torch.ones_like(nodes)
    return fn


def _upper_adj_fn(adj_u: torch.Tensor):
    """Batched upper-layer adjacency (memory-resident dense rows)."""
    def fn(nodes):
        rows = adj_u[nodes.clamp_min(0).long()]
        return torch.where((nodes >= 0)[..., None], rows, -1), \
            torch.zeros_like(nodes)
    return fn


def _point_dist(state: HNSWState, qs: torch.Tensor, nodes: torch.Tensor):
    """Squared L2 from each query row to its node (ids >= 0), through the
    gather kernel: the same bits on every device."""
    return _dist_fn(state, qs)(nodes.to(_I32).reshape(-1, 1))[:, 0]


def _descend_upper(cfg: HNSWConfig, state: HNSWState, qs: torch.Tensor):
    """Greedy-route every query lane through the upper layers, top down."""
    ep = state.entry.clamp_min(0).expand(qs.shape[0])
    d_ep = _point_dist(state, qs, ep)
    for u in reversed(range(cfg.num_upper)):
        ep, d_ep = greedy_descent(qs, ep, d_ep, state.upper_adj[u],
                                  state.vectors, state.levels > u)
    return ep, d_ep


def _diversity_topm(ids: torch.Tensor, dists: torch.Tensor,
                    vectors: torch.Tensor, m: int):
    """HNSW neighbor-selection heuristic (keepPruned), batched over rows.

    ids [b, C], dists [b, C] -> (ids [b, m], dists [b, m]).  A candidate
    is kept only if it is closer to the base point than to every
    already-kept neighbor; leftover slots take the nearest pruned
    candidates.  Rows go 256 at a time to bound the [b, C, C] pairwise
    block.
    """
    outs = [_diversity_topm_block(ids[s:s + 256], dists[s:s + 256],
                                  vectors, m)
            for s in range(0, ids.shape[0], 256)]
    return (torch.cat([o[0] for o in outs]),
            torch.cat([o[1] for o in outs]))


def _pair_dists(vectors: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """pair[b, i, j] = |v[ids[b, i]] - v[ids[b, j]]|^2 for ids [b, C]
    (+inf where ids[b, j] < 0), one `_row_dists` call over the b*C rows."""
    b, c = ids.shape
    cv = vectors[ids.clamp_min(0).long()].reshape(b * c, -1)
    cols = ids[:, None, :].expand(b, c, c).reshape(b * c, c)
    return _row_dists(vectors, cv, cols).reshape(b, c, c)


def _diversity_topm_block(ids, dists, vectors, m):
    order = torch.sort(dists, dim=1, stable=True).indices
    ids, dists = ids.gather(1, order), dists.gather(1, order)
    c = ids.shape[1]
    pair = _pair_dists(vectors, ids)
    valid = torch.isfinite(dists) & (ids >= 0)
    kept = torch.zeros_like(valid)
    for i in range(c):
        dominated = (kept & (pair[:, i] < dists[:, i:i + 1])).any(1)
        space = kept.sum(1) < m
        kept[:, i] = valid[:, i] & ~dominated & space
    rank = torch.sort((~kept).to(torch.int8), dim=1, stable=True).indices
    ids2, valid2 = ids.gather(1, rank), valid.gather(1, rank)
    return (torch.where(valid2[:, :m], ids2[:, :m], -1),
            dists.gather(1, rank)[:, :m])


def _evict_slot(rows: torch.Tensor, d_new: torch.Tensor) -> torch.Tensor:
    """Backlink slot choice per row: empty slot first, else evict the
    existing neighbor *closest to the incoming node* (most redundant
    direction) — never the farthest, which would strip long-range
    portals.  rows, d_new [n, M] -> int64[n]."""
    return torch.where(rows < 0, INF, -d_new).argmax(1)


def _backlink(rows: torch.Tensor, vectors: torch.Tensor, x: torch.Tensor,
              i: int) -> torch.Tensor:
    """Each neighbor row with its evicted slot set to the new node i."""
    d_new = _row_dists(vectors, x.reshape(1, -1),
                       rows.reshape(1, -1)).reshape(rows.shape)
    slots = _evict_slot(rows, d_new)
    new_rows = rows.clone()
    new_rows[torch.arange(rows.shape[0], device=rows.device), slots] = i
    return new_rows


def _dedup_to_inf(ids: torch.Tensor, dists: torch.Tensor) -> torch.Tensor:
    """Mask duplicate ids (keep the first occurrence of each row) with +inf."""
    eq = ids[..., None, :] == ids[..., :, None]
    dup = torch.tril(eq, diagonal=-1).any(-1)
    return torch.where(dup, INF, dists)


# ---------------------------------------------------------------------------
# search (paper §3.2 "Search in LSM-VEC")
# ---------------------------------------------------------------------------

def _search_knobs(cfg: HNSWConfig, rho, ef, use_filter, n_expand):
    ef = ef or cfg.ef_search
    n_expand = cfg.n_expand if n_expand is None else n_expand
    return (cfg.rho if rho is None else rho, ef,
            cfg.use_filter if use_filter is None else use_filter,
            max(1, min(n_expand, ef)))


def search_batch(cfg: HNSWConfig, state: HNSWState, qs: torch.Tensor,
                 *, rho: float | None = None, ef: int | None = None,
                 use_filter: bool | None = None,
                 n_expand: int | None = None,
                 snapshot: torch.Tensor | None = None,
                 active: torch.Tensor | None = None,
                 record_heat: bool = True) -> BeamResult:
    """Batched search: upper greedy descent -> sampled bottom beam.

    `snapshot` (from `lsm.snapshot_rows`) serves bottom-layer adjacency
    by row gather instead of per-hop LSM probes — identical results
    against an unchanged tree.  `active` (bool[Bq]) masks padded lanes.
    Under `cfg.lazy_delete` tombstoned nodes are routable but never
    returned.  Under `cfg.tier` cold rows are scored from the int8 lane
    and the final window is reranked exactly.

    With `cfg.fused_beam` and a snapshot the bottom beam runs as one
    `fused_beam_search` launch; otherwise as the batched loop, which
    always records heat (`record_heat` is the fused route's skip: False
    returns -1/False heat lanes).
    """
    if cfg.fused_beam and snapshot is not None:
        return _search_batch_fused(cfg, state, qs, snapshot=snapshot,
                                   active=active, rho=rho, ef=ef,
                                   use_filter=use_filter, n_expand=n_expand,
                                   record_heat=record_heat)
    rho, ef, use_filter, n_expand = _search_knobs(cfg, rho, ef, use_filter,
                                                  n_expand)
    routable = state.levels >= 0
    returnable = (routable & ~state.tombstone) if cfg.lazy_delete else None
    ep, d_ep = _descend_upper(cfg, state, qs)
    code_q = simhash.encode(state.proj, qs)
    adj_fn = _bottom_adj_fn(cfg, state) if snapshot is None \
        else _snapshot_adj_fn(snapshot)
    if cfg.tier:
        resident = _exact_resident(state)
        dist_fn = _tier_dist_fn(state, qs, resident)
        fetch_fn = _tier_fetch_fn(state, qs, code_q, resident)
    else:
        dist_fn, fetch_fn = _dist_fn(state, qs), _fetch_fn(state, qs, code_q)
    res = beam_search(
        qs, ep, d_ep, adj_fn, dist_fn,
        state.codes, code_q, routable,
        cap=cfg.cap, ef=ef, k=cfg.k, m_bits=cfg.m_bits, eps=cfg.eps,
        rho=rho, max_iters=2 * ef, use_filter=use_filter,
        q_norm=_norm(qs), mean_norm=state.mean_norm,
        n_expand=n_expand, M=cfg.M, active=active, returnable=returnable,
        fetch_fn=fetch_fn)
    return _tier_rerank(cfg, state, qs, res) if cfg.tier else res


def _search_batch_fused(cfg: HNSWConfig, state: HNSWState, qs: torch.Tensor,
                        *, snapshot: torch.Tensor,
                        active: torch.Tensor | None = None,
                        rho: float | None = None, ef: int | None = None,
                        use_filter: bool | None = None,
                        n_expand: int | None = None,
                        record_heat: bool = True) -> BeamResult:
    """Fused-megakernel route of the snapshot serving path: the prelude
    (upper greedy descent, SimHash query encode, norms) runs per query
    block as the loop route's does, then one `fused_beam_search` launch
    runs the whole bottom beam over the dense operands (snapshot
    adjacency, routable/returnable lanes, tier split), then the tier
    rerank.  Results equal the loop route's."""
    rho, ef, use_filter, n_expand = _search_knobs(cfg, rho, ef, use_filter,
                                                  n_expand)
    routable = state.levels >= 0
    returnable = (routable & ~state.tombstone) if cfg.lazy_delete else None
    ep, d_ep = _descend_upper(cfg, state, qs)
    qs = qs.contiguous()
    ids, dists, stats, heat_nodes, heat_mask = fused_beam_search(
        qs, ep.to(_I32).contiguous(), d_ep.contiguous(), snapshot,
        state.vectors, state.codes, simhash.encode(state.proj, qs),
        routable, _norm(qs), state.mean_norm, returnable=returnable,
        resident=_exact_resident(state) if cfg.tier else None,
        qvecs=state.qvecs if cfg.tier else None,
        qscale=state.qscale if cfg.tier else None, active=active,
        ef=ef, k=cfg.k, m_bits=cfg.m_bits, eps=cfg.eps, rho=rho,
        max_iters=2 * ef, use_filter=use_filter, n_expand=n_expand,
        record_heat=record_heat)
    res = BeamResult(ids, dists, IOStats(*stats.unbind(1)), heat_nodes,
                     heat_mask)
    return _tier_rerank(cfg, state, qs, res) if cfg.tier else res


def search(cfg: HNSWConfig, state: HNSWState, q: torch.Tensor,
           **kw) -> BeamResult:
    """Single-query `search_batch`; fields come back without the lane axis."""
    res = search_batch(cfg, state, q[None, :], **kw)
    return BeamResult(res.ids[0], res.dists[0],
                      IOStats(*(a[0] for a in res.stats)),
                      res.heat_nodes[0], res.heat_mask[0])


# ---------------------------------------------------------------------------
# insert (Algorithm 1)
# ---------------------------------------------------------------------------

def _levels_from_uniform(cfg: HNSWConfig, u01: torch.Tensor) -> torch.Tensor:
    """Paper: Pr(L) ∝ e^{-L/s} -> L = floor(s * Exp(1)), capped.  The
    log is rounded once from f64, so both devices draw the same levels."""
    log_u = torch.log(u01.to(torch.float32).double()).float()
    lvl = torch.floor(-cfg.level_scale * log_u)
    return torch.clamp_max(lvl.to(_I32), cfg.num_upper)


def _upper_backlinks(adj_u: torch.Tensor, vectors: torch.Tensor,
                     nbrs: torch.Tensor, x: torch.Tensor, i: int) -> None:
    """Link node i into the rows of its layer neighbors, in place.  The
    neighbors are distinct beam candidates, so the row updates are
    independent and one vectorized pass equals the sequential one."""
    ok = nbrs >= 0
    ns = nbrs.clamp_min(0).long()
    new_rows = _backlink(adj_u[ns], vectors, x, i)
    _set_rows(adj_u, ns, new_rows, ok)


def _connect_upper(cfg: HNSWConfig, state: HNSWState, u: int, x, code,
                   xnorm, i: int, ep, d_ep, n_expand: int, pool: int,
                   link: bool = True):
    """Connect node i on upper layer u (in place on `state.upper_adj`):
    ef-search the layer, diversity-select among the best `pool`
    candidates, write i's row and its backlinks (all skipped when not
    `link`: the first node of an empty graph).  Returns the next layer's
    (ep, d_ep)."""
    live_u = state.levels > u
    live_u[i] = False
    adj_u = state.upper_adj[u]
    res = beam_search(
        x[None], ep, d_ep, _upper_adj_fn(adj_u), _dist_fn(state, x[None]),
        state.codes, code[None], live_u,
        cap=cfg.cap, ef=cfg.ef_construction, k=cfg.k, m_bits=cfg.m_bits,
        eps=cfg.eps, rho=1.0, max_iters=2 * cfg.ef_construction,
        use_filter=False, q_norm=xnorm[None], mean_norm=state.mean_norm,
        n_expand=n_expand, M=cfg.M_up)
    if link:
        nbrs = _diversity_topm(res.ids[:, :pool], res.dists[:, :pool],
                               state.vectors, cfg.M_up)[0][0]
        adj_u[i] = nbrs
        _upper_backlinks(adj_u, state.vectors, nbrs, x, i)
    ep = torch.where(res.dists[:, 0] < INF, res.ids[:, 0], ep)
    d_ep = torch.minimum(res.dists[:, 0], d_ep)
    return ep, d_ep


def _insert_upper(cfg: HNSWConfig, state: HNSWState, x, code, xnorm,
                  i: int, lvl: int, entry, n_expand: int, pool: int,
                  link: bool = True):
    """Route node i down the upper layers from `entry`: greedy above its
    level, `_connect_upper` on every layer below it.  Returns the entry
    (ep, d_ep) for the bottom layer."""
    ep = entry.clamp_min(0).reshape(1)
    d_ep = _point_dist(state, x[None], ep)
    for u in reversed(range(cfg.num_upper)):
        if u >= lvl:
            live_u = state.levels > u
            live_u[i] = False
            ep, d_ep = greedy_descent(x[None], ep, d_ep, state.upper_adj[u],
                                      state.vectors, live_u)
        else:
            ep, d_ep = _connect_upper(cfg, state, u, x, code, xnorm, i, ep,
                                      d_ep, n_expand, pool, link)
    return ep, d_ep


def _backlink_rows(cfg: HNSWConfig, store: lsm.LSMState,
                   vectors: torch.Tensor, nbrs: torch.Tensor,
                   x: torch.Tensor, i: int) -> lsm.LSMState:
    """Bulk bottom-layer backlink pass: read the M neighbor rows in one
    batched lookup, evict each row's most redundant slot, write them back
    with one `lsm.puts`.  Masked (-1) neighbors land on the reserved dead
    key `cap`, which is never looked up."""
    ok = nbrs >= 0
    nbrs_safe = nbrs.clamp_min(0)
    found, rows, _ = lsm.get_batch(cfg.lsm_cfg, store, nbrs_safe)
    rows = torch.where(found[:, None], rows, -1)
    new_rows = _backlink(rows, vectors, x, i)
    return lsm.puts(cfg.lsm_cfg, store,
                    torch.where(ok, nbrs_safe, cfg.cap), new_rows)


def insert(cfg: HNSWConfig, state: HNSWState, x: torch.Tensor,
           u01) -> Tuple[HNSWState, IOStats]:
    """Insert one vector (Algorithm 1).  `u01` is its level uniform.
    Returns (state, construction IO)."""
    dev = state.vectors.device
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    i, n_live, max_level = torch.stack(
        [state.count, state.n_live, state.max_level]).tolist()
    if i >= cfg.cap:
        raise ValueError(f"index full: cap {cfg.cap} ids allocated")
    lvl_t = _levels_from_uniform(
        cfg, torch.as_tensor(u01, dtype=torch.float32, device=dev))
    lvl = int(lvl_t)

    xnorm = _norm(x)
    code = simhash.encode(state.proj, x[None])[0]
    state.vectors[i] = x
    state.norms[i] = xnorm
    state.codes[i] = code
    state.levels[i] = lvl_t
    mean = _mean_update(float(state.mean_norm), n_live, float(xnorm))
    state = state._replace(mean_norm=torch.tensor(mean, device=dev))
    first = n_live == 0

    # ---- phase 1+2: upper layers (connects search the whole beam) ----------
    ep, d_ep = _insert_upper(cfg, state, x, code, xnorm, i, lvl, state.entry,
                             1, cfg.ef_construction, link=not first)

    # ---- phase 3: bottom layer (disk / LSM) ----------------------------------
    live = state.levels >= 0
    live[i] = False
    res = beam_search(
        x[None], ep, d_ep, _bottom_adj_fn(cfg, state),
        _dist_fn(state, x[None]), state.codes, code[None], live,
        cap=cfg.cap, ef=cfg.ef_construction, k=cfg.k, m_bits=cfg.m_bits,
        eps=cfg.eps, rho=cfg.rho, max_iters=2 * cfg.ef_construction,
        use_filter=cfg.use_filter, q_norm=xnorm[None],
        mean_norm=state.mean_norm, M=cfg.M,
        fetch_fn=_fetch_fn(state, x[None], code[None]))
    nbrs = _diversity_topm(res.ids, res.dists, state.vectors, cfg.M)[0][0]
    if first:
        nbrs = torch.full_like(nbrs, -1)
    store = lsm.put(cfg.lsm_cfg, state.store, i, nbrs)
    store = _backlink_rows(cfg, store, state.vectors, nbrs, x, i)

    state = state._replace(
        store=store, count=state.count + 1, n_live=state.n_live + 1,
        entry=(torch.tensor(i, dtype=_I32, device=dev)
               if first or lvl > max_level else state.entry),
        max_level=torch.clamp_min(state.max_level, lvl))
    stats = res.stats.total()
    return state, stats._replace(n_vec=stats.n_vec + cfg.M)


# ---------------------------------------------------------------------------
# batched updates — the FreshDiskANN-style two-phase pipeline
# ---------------------------------------------------------------------------

def insert_batch(cfg: HNSWConfig, state: HNSWState, xs: torch.Tensor,
                 u01s: torch.Tensor, *, valid: torch.Tensor | None = None,
                 n_expand: int | None = None, return_overlay: bool = False):
    """Insert a batch of vectors; `u01s` are their level uniforms.

    Two phases, as in the reference:
      A (batched): every item's bottom-layer candidate search runs
        against the *pre-batch* graph, resolved once into a dense
        snapshot, with multi-expansion beams; the diversity selection
        also sees the item's nearest earlier batch siblings.
      B (sequential): graph writes item by item.  Upper-layer connects
        run only for items that reach layer >= 1; bottom-layer rows are
        staged in a dense overlay read overlay-first, then the snapshot,
        and the LSM absorbs every staged row in one bulk `puts`.

    `valid` (bool[n], default all-True) masks padding items at the tail;
    they allocate no id and write nothing to the graph.

    Returns (state, stats); with `return_overlay`, (state, stats,
    (overlay_rows int32[cap+1, M], overlay_valid bool[cap+1])): every
    bottom-layer row the batch wrote, final values, which a caller
    holding a fresh snapshot patches in instead of re-resolving the tree
    (the last row, id `cap`, is the masked items' dead slot).
    """
    dev = state.vectors.device
    if n_expand is None:
        n_expand = cfg.batch_expand
    n_expand = max(1, min(n_expand, cfg.ef_construction))
    xs = torch.as_tensor(xs, dtype=torch.float32, device=dev).contiguous()
    n = xs.shape[0]
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=dev)
    valid = torch.as_tensor(valid, dtype=torch.bool, device=dev)
    valid_h = valid.tolist()
    n_valid = sum(valid_h)
    if valid_h != [True] * n_valid + [False] * (n - n_valid):
        raise ValueError("valid items must form a prefix of the batch")
    base_id, n_live, max_level = torch.stack(
        [state.count, state.n_live, state.max_level]).tolist()
    if base_id + n_valid > cfg.cap:
        raise ValueError(f"index full: {base_id} + {n_valid} ids exceed "
                         f"cap {cfg.cap}")
    codes = simhash.encode(state.proj, xs)
    xnorms = _norm(xs)
    lvls = _levels_from_uniform(
        cfg, torch.as_tensor(u01s, dtype=torch.float32, device=dev))
    lvls_h = lvls.tolist()

    # intra-batch neighbor candidates: each item may also link to its
    # nearest *earlier* items, whose ids base_id + j are deterministic
    sq = xnorms * xnorms
    bb = _fma32(xnorms[None, :], xnorms[None, :], sq[:, None]) \
        - 2.0 * _gram(xs)
    lower = torch.tril(torch.ones((n, n), dtype=torch.bool, device=dev), -1)
    bb = torch.where(lower & valid[None, :], bb, INF)
    m_in = max(1, min(cfg.M, n - 1))
    in_d, nb_j = stable_topk_asc(bb, m_in)
    in_ids = torch.where(torch.isfinite(in_d), base_id + nb_j, -1).to(_I32)

    # the batch rows become visible to the diversity selection; nothing
    # in the pre-batch graph points at them, so phase A cannot reach them
    state.vectors[base_id:base_id + n_valid] = xs[:n_valid]

    # ---- phase A: batch-parallel candidate search on the snapshot ---------
    snapshot = lsm.snapshot_rows(cfg.lsm_cfg, state.store, cfg.cap)
    ep, d_ep = _descend_upper(cfg, state, xs)
    res = beam_search(
        xs, ep, d_ep, _snapshot_adj_fn(snapshot), _dist_fn(state, xs),
        state.codes, codes, state.levels >= 0,
        cap=cfg.cap, ef=cfg.ef_construction, k=cfg.k, m_bits=cfg.m_bits,
        eps=cfg.eps, rho=cfg.rho, max_iters=2 * cfg.ef_construction,
        use_filter=cfg.use_filter, q_norm=xnorms,
        mean_norm=state.mean_norm, n_expand=n_expand, M=cfg.M,
        active=valid, fetch_fn=_fetch_fn(state, xs, codes))
    pool = min(2 * cfg.M, res.ids.shape[1])
    cand_nbrs, _ = _diversity_topm(
        torch.cat([res.ids[:, :pool], in_ids], 1),
        torch.cat([res.dists[:, :pool], in_d], 1), state.vectors, cfg.M)

    # ---- phase B: sequential graph writes ---------------------------------
    ids_v = slice(base_id, base_id + n_valid)
    state.norms[ids_v] = xnorms[:n_valid]
    state.codes[ids_v] = codes[:n_valid]
    state.levels[ids_v] = lvls[:n_valid]
    mean = float(state.mean_norm)
    for j, xn in enumerate(xnorms[:n_valid].tolist()):
        mean = _mean_update(mean, n_live + j, xn)
    overlay_rows = torch.full((cfg.cap + 1, cfg.M), -1, dtype=_I32,
                              device=dev)
    overlay_valid = torch.zeros((cfg.cap + 1,), dtype=torch.bool,
                                device=dev)
    dead = cfg.cap
    upper_pool = max(2 * cfg.M_up, cfg.M_up + 4)
    entry = state.entry
    i = base_id
    w_keys_all = []
    for j in range(n):
        v, lvl, x = valid_h[j], lvls_h[j], xs[j]
        first = n_live == 0
        if v and lvl > 0 and not first:
            # upper-layer work only for items that reach layer >= 1
            _insert_upper(cfg, state, x, codes[j], xnorms[j], i, lvl, entry,
                          n_expand, upper_pool)
        nbrs = cand_nbrs[j] if v and not first \
            else torch.full((cfg.M,), -1, dtype=_I32, device=dev)
        # backlink pass against overlay-else-snapshot rows
        ok = nbrs >= 0
        nbrs_safe = nbrs.clamp_min(0).long()
        rows = torch.where(overlay_valid[nbrs_safe][:, None],
                           overlay_rows[nbrs_safe], snapshot[nbrs_safe])
        new_rows = _backlink(rows, state.vectors, x, i)
        w_keys = torch.cat([
            torch.tensor([i if v else dead], device=dev),
            torch.where(ok, nbrs_safe, dead)])
        w_vals = torch.cat([nbrs[None, :], new_rows])
        overlay_rows[w_keys] = _last_writer(w_keys, w_vals)
        overlay_valid[w_keys] = True
        w_keys_all.append(w_keys)
        if v:
            if first or lvl > max_level:
                entry = torch.tensor(i, dtype=_I32, device=dev)
            max_level = max(max_level, lvl)
            n_live += 1
            i += 1

    # one bulk LSM apply: every staged key carries its *final* overlay row
    w_keys = torch.cat(w_keys_all)
    state = state._replace(
        store=lsm.puts(cfg.lsm_cfg, state.store, w_keys,
                       overlay_rows[w_keys]),
        count=torch.tensor(i, dtype=_I32, device=dev),
        n_live=torch.tensor(n_live, dtype=_I32, device=dev),
        entry=entry, max_level=torch.tensor(max_level, dtype=_I32,
                                            device=dev),
        mean_norm=torch.tensor(mean, device=dev))
    # masked lanes already report zero beam stats; backlink re-rankings
    stats = res.stats.total()
    stats = stats._replace(n_vec=stats.n_vec + n_valid * cfg.M)
    if return_overlay:
        return state, stats, (overlay_rows, overlay_valid)
    return state, stats


# ---------------------------------------------------------------------------
# delete: lazy tombstones, or the eager Algorithm-2 relink
# ---------------------------------------------------------------------------

def delete_batch(cfg: HNSWConfig, state: HNSWState,
                 ids: torch.Tensor) -> Tuple[HNSWState, IOStats]:
    """Delete a batch of node ids: the lazy route (`tombstone_batch`)
    under `cfg.lazy_delete`, else the eager Algorithm-2 relink.
    Negative ids are masked no-ops; absent or already-deleted ids are
    counted in `n_delete_noops`."""
    if cfg.lazy_delete:
        return tombstone_batch(cfg, state, ids)
    return _delete_batch_eager(cfg, state, ids)


def delete(cfg: HNSWConfig, state: HNSWState,
           node) -> Tuple[HNSWState, IOStats]:
    """Delete one node: a tombstone under `cfg.lazy_delete`, else the
    paper's Algorithm-2 local relink.  Deleting an absent or already
    deleted id is a counted no-op either way."""
    if cfg.lazy_delete:
        return tombstone_batch(cfg, state, torch.as_tensor(
            node, dtype=_I32, device=state.levels.device).reshape(1))
    return _delete_eager(cfg, state, node)


def _relink(state: HNSWState, cand: torch.Tensor, nbr: torch.Tensor,
            i: int, min_level: int, m: int):
    """Algorithm-2 relink rows of the deleted node i's neighbors `nbr`:
    each row is the best m of the shared 2-hop pool `cand` by distance to
    its neighbor, skipping -1, i, the neighbor itself, nodes below
    `min_level` and tombstoned nodes, with repeated ids at +inf (the
    reference's `_topm`: `lax.top_k`, ties to the lower index, -1 pads).
    Every row derives from the same pool, read before any write, so the
    rows are independent.  Returns (rows [len(nbr), m], dists
    [len(nbr), C])."""
    cs = cand.clamp_min(0).long()
    bad = (cand[None, :] < 0) | (cand[None, :] == i) \
        | (cand[None, :] == nbr[:, None]) \
        | (state.levels[cs][None, :] < min_level) \
        | state.tombstone[cs][None, :]
    masked = torch.where(bad, -1, cand[None, :])
    d = _row_dists(state.vectors, state.vectors[nbr.clamp_min(0).long()],
                   masked)
    d = _dedup_to_inf(masked, d)
    top_d, order = stable_topk_asc(d, m)
    return torch.where(torch.isfinite(top_d), cand[order], -1), d


def _relink_upper_rows(cfg: HNSWConfig, state: HNSWState, u: int,
                       i: int) -> None:
    """Algorithm-2 relink of node i's layer-u neighbors, in place on
    `state.upper_adj[u]`, for a node that reaches layer u: each neighbor
    row is rebuilt from the 2-hop pool of i's row, then i's row is
    cleared."""
    adj_u = state.upper_adj[u]
    nbr = adj_u[i].clone()                                    # [M_up]
    nbr_safe = nbr.clamp_min(0).long()
    cand = torch.cat([adj_u[nbr_safe].reshape(-1), nbr])      # 2-hop pool
    new_rows, _ = _relink(state, cand, nbr, i, u + 1, cfg.M_up)
    _set_rows(adj_u, nbr_safe, new_rows, nbr >= 0)
    adj_u[i] = -1


def _bottom_relink(cfg: HNSWConfig, state: HNSWState, rows_of, i: int,
                   n1: torch.Tensor):
    """Algorithm-2 relink of the bottom-layer neighbors `n1` of node i,
    whose rows `rows_of(ids)` returns.  Returns (write keys: the dead key
    `cap` for -1 slots, new rows, number of finite candidate
    distances)."""
    n1_safe = n1.clamp_min(0)
    cand = torch.cat([rows_of(n1_safe).reshape(-1), n1])     # C = M*M + M
    new_rows, d = _relink(state, cand, n1, i, 0, cfg.M)
    keys = torch.where(n1 >= 0, n1_safe, cfg.cap)
    return keys, new_rows, torch.isfinite(d).sum().to(_I32)


def _delete_ids(cfg: HNSWConfig, ids) -> list:
    ids_h = torch.as_tensor(ids).reshape(-1).tolist()
    if any(i >= cfg.cap for i in ids_h):
        raise ValueError(f"delete: ids must be < cap {cfg.cap}")
    return ids_h


def _delete_eager(cfg: HNSWConfig, state: HNSWState,
                  node) -> Tuple[HNSWState, IOStats]:
    """Delete one node with local neighbor relinking (Algorithm 2): the
    upper layers in place, then the bottom layer as LSM writes — the
    relinked neighbor rows (an absent node's -1 slots land on the dead
    key `cap`), then i's tombstone."""
    (i,) = _delete_ids(cfg, [node])
    if i < 0:
        raise ValueError(f"delete: node id {i} is negative")
    dev = state.levels.device
    lvl = int(state.levels[i])
    was_live = lvl >= 0
    for u in range(min(max(lvl, 0), cfg.num_upper)):
        _relink_upper_rows(cfg, state, u, i)

    found, n1, _ = lsm.get(cfg.lsm_cfg, state.store, i)
    n1 = torch.where(found & was_live, n1, -1)

    def rows_of(ids):
        return lsm.get_batch(cfg.lsm_cfg, state.store, ids)[1]
    keys, new_rows, n_vec = _bottom_relink(cfg, state, rows_of, i, n1)
    store = lsm.puts(cfg.lsm_cfg, state.store, keys, new_rows)
    store = lsm.delete(cfg.lsm_cfg, store, i if was_live else cfg.cap)

    if not was_live:
        return state._replace(
            store=store, n_delete_noops=state.n_delete_noops + 1), \
            IOStats.zero(dev)
    state.levels[i] = -1
    entry = state.entry
    if int(entry) == i:
        # highest remaining level; argmax breaks ties by the lowest id
        entry = state.levels.argmax().to(_I32)
    state = state._replace(
        store=store, entry=entry,
        max_level=state.levels[entry.clamp_min(0).long()].clamp_min(0),
        n_live=state.n_live - 1)
    zero = torch.zeros((), dtype=_I32, device=dev)
    return state, IOStats(torch.tensor(1 + cfg.M, dtype=_I32, device=dev),
                          n_vec, zero, zero)


def _delete_batch_eager(cfg: HNSWConfig, state: HNSWState,
                        ids) -> Tuple[HNSWState, IOStats]:
    """Eager batched delete — Algorithm 2 through an overlay.

    As `insert_batch`'s phase B: the per-item relinks read and stage
    bottom-layer rows in a dense newest-wins overlay seeded from one
    `lsm.resolve_all` of the pre-batch tree, and one bulk `lsm.puts`
    afterwards applies every staged key's final row and liveness, in the
    reference's order ([relinked neighbors, i] per item; the dead key
    `cap` for -1 slots and for no-op items).  The upper layers relink in
    place.  Negative ids are masked no-ops.

    The ids' levels, the entry and its level are mirrored on the host,
    so an item costs no device read unless it deletes the entry.
    """
    M, dead = cfg.M, cfg.cap
    dev = state.levels.device
    ids_h = _delete_ids(cfg, ids)
    if not ids_h:
        return state, IOStats.zero(dev)
    snap_live, snap_rows = lsm.resolve_all(cfg.lsm_cfg, state.store, cfg.cap)
    # spare slot `cap` absorbs masked writes, as in insert_batch
    dlive = torch.cat([snap_live, torch.zeros(1, dtype=torch.int8,
                                              device=dev)])
    drows = torch.cat([snap_rows, torch.full((1, M), lsm.EMPTY, dtype=_I32,
                                             device=dev)])
    safe_h = [max(i, 0) for i in ids_h]
    level_of = dict(zip(safe_h, state.levels[torch.tensor(
        safe_h, device=dev)].tolist()))
    entry = int(state.entry)
    entry_level = int(state.levels[max(entry, 0)])
    n_live, n_noops = int(state.n_live), int(state.n_delete_noops)
    max_level = int(state.max_level)
    zero = torch.zeros((), dtype=_I32, device=dev)
    n_done, n_vec = 0, zero
    w_keys = []

    def rows_of(n1_safe):
        return drows[n1_safe.long()]

    for i in ids_h:
        was_live = i >= 0 and level_of[i] >= 0
        if not was_live:
            # every staged row of an absent id lands on the dead key, the
            # last one its tombstone
            n_noops += i >= 0
            drows[dead] = lsm.EMPTY
            dlive[dead] = 0
            w_keys.append(torch.full((M + 1,), dead, dtype=_I32, device=dev))
            continue
        for u in range(min(level_of[i], cfg.num_upper)):
            _relink_upper_rows(cfg, state, u, i)
        n1 = torch.where(dlive[i] > 0, drows[i], -1)
        keys, new_rows, n_fin = _bottom_relink(cfg, state, rows_of, i, n1)
        drows[keys.long()] = new_rows
        dlive[keys.long()] = 1
        drows[i] = lsm.EMPTY
        dlive[i] = 0
        w_keys.append(torch.cat([keys, torch.tensor([i], dtype=_I32,
                                                    device=dev)]))
        state.levels[i] = -1
        level_of[i] = -1
        if entry == i:
            # highest remaining level; argmax breaks ties by the lowest id
            entry = int(state.levels.argmax())
            entry_level = int(state.levels[entry])
        max_level = max(entry_level, 0)
        n_live -= 1
        n_done += 1
        n_vec = n_vec + n_fin

    keys = torch.cat(w_keys).long()
    state = state._replace(
        store=lsm.puts(cfg.lsm_cfg, state.store, keys, drows[keys],
                       dlive[keys]),
        entry=torch.tensor(entry, dtype=_I32, device=dev),
        max_level=torch.tensor(max_level, dtype=_I32, device=dev),
        n_live=torch.tensor(n_live, dtype=_I32, device=dev),
        n_delete_noops=torch.tensor(n_noops, dtype=_I32, device=dev))
    return state, IOStats(
        torch.tensor(n_done * (1 + M), dtype=_I32, device=dev), n_vec,
        zero, zero)


def tombstone_batch(cfg: HNSWConfig, state: HNSWState,
                    ids: torch.Tensor) -> Tuple[HNSWState, IOStats]:
    """Phase-1 lazy delete: mark `ids` tombstoned (routable but never
    returned) with no graph or LSM writes.  Within-batch duplicates apply
    once; absent, tombstoned or duplicated non-negative ids are counted
    no-ops."""
    dev = state.levels.device
    ids = torch.as_tensor(ids, device=dev).to(_I32)
    valid = (ids >= 0) & (ids < cfg.cap)
    safe = ids.clamp(0, cfg.cap - 1).long()
    eq = (safe[None, :] == safe[:, None]) & valid[None, :]
    first = ~torch.tril(eq, diagonal=-1).any(1)
    applies = valid & first & (state.levels[safe] >= 0) \
        & ~state.tombstone[safe]
    n_new = applies.sum().to(_I32)
    marks = torch.zeros((cfg.cap + 1,), dtype=torch.bool, device=dev)
    # index_fill_, not `marks[idx] = True`: a Python value there becomes
    # a host tensor copied to the card, a blocking copy (a host sync)
    marks.index_fill_(0, torch.where(applies, safe, cfg.cap), True)
    state.tombstone.logical_or_(marks[:cfg.cap])
    state = state._replace(
        n_tombstones=state.n_tombstones + n_new,
        n_live=state.n_live - n_new,
        n_delete_noops=state.n_delete_noops
        + ((ids >= 0) & ~applies).sum().to(_I32))
    return state, IOStats.zero(dev)


def _diversity_block(vectors: torch.Tensor, cand: torch.Tensor,
                     d: torch.Tensor, m: int) -> torch.Tensor:
    """Blocked keepPruned diversity selection over a [b, C] candidate
    block (the reference builds the pairwise matrix as norms + cv@cv^T,
    exact on integer data as the direct sum is).  `d` must already be
    +inf for duplicate/invalid candidates."""
    order = torch.sort(d, dim=1, stable=True).indices
    ids_s = cand.gather(1, order)
    d_s = d.gather(1, order)
    valid = torch.isfinite(d_s) & (ids_s >= 0)
    # sorted by distance, so every valid candidate lies in the first
    # `c` columns and the rest are never kept: the first m of the
    # selection order below come out the same without them
    c = min(cand.shape[1], max(m, int(valid.sum(1).max())))
    ids_s, d_s, valid = ids_s[:, :c], d_s[:, :c], valid[:, :c]
    pair = _pair_dists(vectors, ids_s)
    kept = torch.zeros_like(valid)
    for i in range(c):
        dominated = (kept & (pair[:, i, :] < d_s[:, i:i + 1])).any(1)
        space = kept.sum(1) < m
        kept[:, i] = valid[:, i] & ~dominated & space
    rank = torch.sort((~kept).to(torch.int8), dim=1, stable=True).indices
    ids_r = ids_s.gather(1, rank)[:, :m]
    valid_r = valid.gather(1, rank)[:, :m]
    return torch.where(valid_r, ids_r, -1)


def _consolidate_rows(vectors: torch.Tensor, adj: torch.Tensor,
                      tomb: torch.Tensor, owner: torch.Tensor,
                      member: torch.Tensor, W: int, block: int):
    """Graph-wide splice: every `owner` row holding tombstoned neighbors
    is rebuilt from the row itself plus the tombstoned neighbors'
    out-neighbors (their 2-hop bridge), selecting `member` targets under
    the diversity rule — FreshDiskANN's RobustPrune step.

    Only the rows that change are computed (the reference computes every
    row and keeps the unchanged ones as they were), `block` rows at a
    time.  Returns (new_adj, changed, n_dist).
    """
    rs = adj.clamp_min(0).long()
    parent_tomb = (adj >= 0) & tomb[rs]                      # [cap, W]
    changed = owner & parent_tomb.any(1)
    rows_idx = torch.nonzero(changed).flatten()
    new_adj = adj.clone()
    n_dist = torch.zeros((), dtype=torch.int64, device=adj.device)
    for s in range(0, rows_idx.shape[0], block):
        blk = rows_idx[s:s + block]
        b = blk.shape[0]
        r = adj[blk]
        exp = adj[rs[blk]].reshape(b, W * W)
        exp_ok = parent_tomb[blk].repeat_interleave(W, dim=1)
        cand = torch.cat([r, torch.where(exp_ok, exp, -1)], 1)
        cs = cand.clamp_min(0).long()
        bad = (cand < 0) | (cand == blk[:, None]) | ~member[cs]
        masked = torch.where(bad, -1, cand)
        d = _dedup_to_inf(masked, _row_dists(vectors, vectors[blk], masked))
        new_adj[blk] = _diversity_block(vectors, cand, d, W)
        n_dist += torch.isfinite(d).sum()
    return new_adj, changed, n_dist.to(_I32)


def consolidate(cfg: HNSWConfig, state: HNSWState, *,
                block: int = 1024) -> Tuple[HNSWState, IOStats]:
    """Phase-2 lazy delete: splice every tombstone out and reclaim slots.

    Resolve the bottom layer into a dense view once, rewrite every live
    row that touches a tombstone, do the same for the memory-resident
    upper layers, then emit the surviving rows as one fresh sorted LSM
    run (`lsm.rebuild_from_dense`) — tombstoned ids simply do not appear
    in it, which is the slot reclamation.  Ids are never reused.
    """
    live8, rows = lsm.resolve_all(cfg.lsm_cfg, state.store, cfg.cap)
    tomb = state.tombstone
    routable = state.levels >= 0
    keep = routable & ~tomb
    rows = torch.where((routable & (live8 > 0))[:, None], rows, -1)

    new_rows, changed, n_dist = _consolidate_rows(
        state.vectors, rows, tomb, keep, keep, cfg.M, block)
    store = lsm.rebuild_from_dense(cfg.lsm_cfg, state.store, keep, new_rows)

    uppers = []
    for u in range(cfg.num_upper):
        member_u = keep & (state.levels > u)
        new_u, _, n_dist_u = _consolidate_rows(
            state.vectors, state.upper_adj[u], tomb, member_u, member_u,
            cfg.M_up, block)
        # reclaimed nodes lose their upper rows outright
        uppers.append(torch.where(tomb[:, None], -1, new_u))
        n_dist = n_dist + n_dist_u
    upper_adj = torch.stack(uppers)

    n_reclaimed = state.n_tombstones
    levels = torch.where(tomb, -1, state.levels)
    entry_dead = (state.entry >= 0) & tomb[state.entry.clamp_min(0).long()]
    alt = levels.argmax().to(_I32)
    entry = torch.where(entry_dead, alt, state.entry)
    state = state._replace(
        store=store, upper_adj=upper_adj, levels=levels, entry=entry,
        max_level=torch.clamp_min(levels[entry.clamp_min(0).long()], 0),
        # repaired rows changed slot alignment; their heat restarts
        heat=torch.where((tomb | changed)[:, None], 0, state.heat),
        tombstone=torch.zeros_like(tomb),
        n_tombstones=torch.zeros_like(state.n_tombstones),
        # reclaimed slots leave the tier: back to the (empty) hot lane so
        # per-lane accounting never counts dead ids as cold rows
        hot=torch.where(tomb, True, state.hot),
        qscale=torch.where(tomb, 0.0, state.qscale),
        tier_heat=torch.where(tomb, 0.0, state.tier_heat))
    zero = torch.zeros((), dtype=_I32, device=levels.device)
    stats = IOStats(
        n_adj=((1 + cfg.M) * n_reclaimed + changed.sum()).to(_I32),
        n_vec=n_dist, n_filtered=zero, n_hops=zero)
    return state, stats


# ---------------------------------------------------------------------------
# bulk construction (initial index build)
# ---------------------------------------------------------------------------

def _np_diversity_select(cand: np.ndarray, cand_d: np.ndarray, vecs_np,
                         deg: int):
    """Numpy twin of _diversity_topm (keepPruned heuristic)."""
    order = np.argsort(cand_d)
    cand, cand_d = cand[order], cand_d[order]
    cv = vecs_np[cand]
    diff = cv[:, None, :] - cv[None, :, :]
    pair = np.einsum("ijk,ijk->ij", diff, diff)
    kept: list[int] = []
    kept_idx: list[int] = []
    for ci in range(len(cand)):
        if len(kept) >= deg:
            break
        if all(pair[ci, kj] >= cand_d[ci] for kj in kept_idx):
            kept.append(int(cand[ci]))
            kept_idx.append(ci)
    for ci in range(len(cand)):            # keepPruned fill
        if len(kept) >= deg:
            break
        if int(cand[ci]) not in kept:
            kept.append(int(cand[ci]))
            kept_idx.append(ci)
    return kept, [float(cand_d[j]) for j in kept_idx]


def _incremental_graph(vecs_np: np.ndarray, vecs: torch.Tensor, member_ids,
                       deg: int, seed: int, batch: int = 64) -> np.ndarray:
    """Batched random-order incremental construction of one layer.

    Nodes arrive in random order and connect to a diversity-selected set
    among the already-placed nodes; back-edges evict the placed node's
    most redundant edge.  Host numpy, as in the reference, except the
    per-batch [chunk, placed] distance block: the `l2_distance` kernel
    computes it on the vectors' device and the block is copied back.
    """
    n_total = vecs_np.shape[0]
    rows = np.full((n_total, deg), -1, np.int32)
    rowd = np.full((n_total, deg), np.inf, np.float32)
    ids = np.asarray(member_ids)
    if ids.size == 0:
        return rows
    rng = np.random.default_rng(seed)
    order = ids[rng.permutation(ids.size)]
    # placed nodes are always a prefix of `order`: keep the vectors in
    # arrival order on the device so each block reads a contiguous slice
    vecs_ord = vecs[torch.as_tensor(order, device=vecs.device)].contiguous()
    placed = [int(order[0])]
    # geometric batch ramp: early nodes (the long-range hubs) must connect
    # densely to each other, not just to the seed
    bounds = [1]
    step = 1
    while bounds[-1] < order.size:
        bounds.append(min(bounds[-1] + step, order.size))
        step = min(batch, step * 2)
    for s, e in zip(bounds[:-1], bounds[1:]):
        chunk = order[s:e]
        d_blk = l2_distance(vecs_ord[s:e], vecs_ord[:s]).cpu().numpy()
        # very small builds see the complete placed set as candidates
        kk = len(placed) if ids.size <= max(128, 4 * deg) \
            else min(2 * deg, len(placed))
        top = np.argpartition(d_blk, kk - 1, axis=1)[:, :kk] \
            if kk < len(placed) else \
            np.broadcast_to(np.arange(len(placed)), (len(chunk),
                                                     len(placed)))
        placed_arr = np.asarray(placed)
        for bi, i in enumerate(chunk):
            cand = placed_arr[top[bi]]
            nb, nd = _np_diversity_select(cand, d_blk[bi, top[bi]],
                                          vecs_np, deg)
            rows[i, : len(nb)] = nb
            rowd[i, : len(nd)] = nd
            for p_, d_ in zip(nb, nd):
                free = np.flatnonzero(rows[p_] < 0)
                if free.size:
                    j = int(free[0])
                else:
                    # evict the edge most redundant w.r.t. the newcomer
                    nbr_vecs = vecs_np[rows[p_]]
                    d_to_new = ((nbr_vecs - vecs_np[i]) ** 2).sum(1)
                    j = int(np.argmin(d_to_new))
                rows[p_, j] = i
                rowd[p_, j] = d_
            placed.append(int(i))
    return rows


def _closest_pair(vecs_np: np.ndarray, un: np.ndarray, reach: np.ndarray,
                  allowed: np.ndarray, budget: int = 1 << 24):
    """(bi, bj) of the closest (un[bi], reach[bj]) pair over allowed
    columns — the reference's one [|un|, |reach|] block argmin (first in
    row-major order on ties), taken over row chunks of bounded size."""
    step = max(1, budget // max(1, reach.size * vecs_np.shape[1]))
    best = (np.inf, 0, 0)
    rv = vecs_np[reach][None, :, :]
    for s in range(0, un.size, step):
        d = ((vecs_np[un[s:s + step]][:, None, :] - rv) ** 2).sum(-1)
        d[:, ~allowed] = np.inf
        bi, bj = np.unravel_index(int(np.argmin(d)), d.shape)
        if d[bi, bj] < best[0] or s == 0:
            best = (d[bi, bj], s + bi, bj)
    return int(best[1]), int(best[2])


def _repair_reachability(rows, vecs_np, member_ids, entry: int, deg: int):
    """Guarantee every member is reachable from `entry` over `rows`.

    BFS from the entry; while any member is unreachable, bridge the
    globally closest (reachable, unreachable) pair with a bidirectional
    edge.  Bridge edges are protected: a full row evicts its unprotected
    slot most redundant w.r.t. the new neighbor, never an earlier bridge.
    Anchors with no evictable slot are skipped, and the loop is bounded
    by the member count, so repair always terminates.
    """
    members = np.asarray(member_ids)
    if members.size <= 1:
        return rows
    in_layer = np.zeros(rows.shape[0], bool)
    in_layer[members] = True
    protected = np.zeros(rows.shape, bool)

    def bfs():
        seen = np.zeros(rows.shape[0], bool)
        seen[entry] = True
        frontier = np.asarray([entry])
        while frontier.size:
            nxt = rows[frontier].ravel()
            nxt = np.unique(nxt[nxt >= 0])
            nxt = nxt[in_layer[nxt] & ~seen[nxt]]
            seen[nxt] = True
            frontier = nxt
        return seen

    def add_edge(src: int, dst: int):
        if dst in rows[src]:
            j = int(np.flatnonzero(rows[src] == dst)[0])
            protected[src, j] = True
            return
        free = np.flatnonzero(rows[src] < 0)
        if free.size:
            j = int(free[0])
        else:
            cand = np.flatnonzero(~protected[src])
            if cand.size == 0:
                return      # row is all bridges; caller skips such anchors
            nbr = vecs_np[rows[src, cand]]
            j = int(cand[np.argmin(((nbr - vecs_np[dst]) ** 2).sum(1))])
        rows[src, j] = dst
        protected[src, j] = True

    for _ in range(members.size):
        seen = bfs()
        un = members[~seen[members]]
        if un.size == 0:
            break
        reach = members[seen[members]]
        # only anchors that can still take a bridge edge
        evictable = ((rows[reach] < 0) | ~protected[reach]).any(axis=1)
        if not evictable.any():
            break
        bi, bj = _closest_pair(vecs_np, un, reach, evictable)
        u_node, r_node = int(un[bi]), int(reach[bj])
        add_edge(r_node, u_node)
        add_edge(u_node, r_node)
    return rows


def bulk_build(cfg: HNSWConfig, vectors, proj, u01s, *, batch: int = 64,
               device=None) -> HNSWState:
    """Initial index build: batched incremental construction per layer.

    `proj` are the SimHash projections and `u01s` f32[n] the level
    uniforms (the reference draws both from its key).  Algorithm 1 over
    a random insertion order with exact neighbor search; the bottom
    layer is written into the LSM tree as one sorted run.
    """
    vecs = torch.as_tensor(vectors, dtype=torch.float32,
                           device=device).contiguous()
    n, dim = vecs.shape
    if n > cfg.cap or dim != cfg.dim:
        raise ValueError(f"bulk_build of [{n}, {dim}] does not fit cap "
                         f"{cfg.cap}, dim {cfg.dim}")
    dev = vecs.device
    state = init(cfg, proj, dev)
    vecs_np = vecs.cpu().numpy()
    norms = _norm(vecs)
    codes = simhash.encode(state.proj, vecs)
    u01_np = np.asarray(torch.as_tensor(u01s).cpu(), np.float32)
    lvls_np = np.minimum(
        np.floor(-cfg.level_scale * np.log(u01_np)).astype(np.int32),
        cfg.num_upper)
    lvls_np[0] = cfg.num_upper   # stable entry chain
    ids = torch.arange(n, dtype=_I32, device=dev)

    # entry = node 0 (forced to the top level above); every layer repairs
    # reachability from it so no cluster is stranded as a graph island
    bottom = _incremental_graph(vecs_np, vecs, np.arange(n), cfg.M, seed=0,
                                batch=batch)
    bottom = _repair_reachability(bottom, vecs_np, np.arange(n), 0, cfg.M)
    store = lsm.bulk_load(cfg.lsm_cfg, ids,
                          torch.as_tensor(bottom, device=dev))

    upper = state.upper_adj
    for u in range(cfg.num_upper):
        members = np.flatnonzero(lvls_np > u)
        rows_u = _incremental_graph(vecs_np, vecs, members, cfg.M_up,
                                    seed=u + 1, batch=batch)
        rows_u = _repair_reachability(rows_u, vecs_np, members, 0, cfg.M_up)
        upper[u, :n] = torch.as_tensor(rows_u, device=dev)

    lvls = torch.as_tensor(lvls_np, device=dev)
    entry = lvls.argmax().to(_I32)
    state.vectors[:n] = vecs
    state.norms[:n] = norms
    state.codes[:n] = codes
    state.levels[:n] = lvls
    return state._replace(
        store=store,
        count=torch.tensor(n, dtype=_I32, device=dev),
        n_live=torch.tensor(n, dtype=_I32, device=dev),
        entry=entry,
        max_level=lvls[entry.long()],
        # summed on the host: one reduction order whatever the device
        mean_norm=norms.cpu().mean().to(dev))


# ---------------------------------------------------------------------------
# memory accounting (paper Fig. 6 — what must stay resident)
# ---------------------------------------------------------------------------

def memory_counts(state: HNSWState) -> Tuple[torch.Tensor, ...]:
    """Device-side (n_routable, n_hot, n_upper) for the byte model."""
    routable = state.levels >= 0
    return (routable.sum(), (routable & state.hot).sum(),
            (state.levels > 0).sum())


def memory_breakdown(cfg: HNSWConfig, state: HNSWState,
                     counts=None) -> MemoryBreakdown:
    """Per-component resident bytes, the reference's byte model.

    With tiering off every routable node keeps its dense f32 row
    resident; with tiering on only hot-lane nodes do, and cold nodes cost
    ``dim + 4`` bytes (int8 row + f32 scale).  The bottom adjacency graph
    stays in the LSM tree in both modes.  The tombstone lane, the insert
    overlay's staging buffers and the ext<->int id maps a serving layer
    holds 1:1 with capacity are counted too.  `counts` are host values
    of `memory_counts` a caller already read; else one fused read.
    """
    if counts is None:
        counts = torch.stack(memory_counts(state)).tolist()
    n_routable, n_hot, n_upper = map(int, counts)
    n_cold = n_routable - n_hot
    if not cfg.tier:
        n_hot, n_cold = n_routable, 0
    return MemoryBreakdown(
        hot_vectors=n_hot * cfg.dim * 4,
        cold_codes=n_cold * (cfg.dim + 4),
        upper_graph=n_upper * cfg.M_up * 4 * cfg.num_upper,
        upper_vec_cache=n_upper * cfg.dim * 4,
        simhash_codes=n_routable * cfg.words * 4,
        memtable=cfg.lsm_cfg.mem_cap * (4 + 4 * cfg.M + 1),
        tombstones=cfg.cap,
        insert_overlay=(cfg.cap + 1) * (4 * cfg.M + 1),
        id_maps=2 * cfg.cap * 8,
        misc=4096,
        n_hot=n_hot,
        n_cold=n_cold)


def memory_resident_bytes(cfg: HNSWConfig, state: HNSWState) -> int:
    """Total resident bytes: `memory_breakdown(...).total`."""
    return memory_breakdown(cfg, state).total
