"""Sampling-guided beam search over the hybrid memory/disk graph (§3.3).

The counterpart of `repro.core.traversal`, written batched over a block
of query lanes instead of vmapped.  The bottom-layer traversal is the
paper's hot loop: pop the closest unexpanded candidates, read their
adjacency rows (from the LSM tree, or a resolved snapshot of it — pays
`t_n`), prefilter the neighbors with in-memory SimHash collision counts
(Eq. 5-6), and fetch full vectors only for survivors (each pays `t_v`):
with the filter on and no sampling, both in one `prefilter_gather`
launch per trip (`fetch_fn`); otherwise the `collision_count_rows`
kernel, then the fused gather+distance kernel.

Loop semantics follow the vmapped `lax.while_loop` exactly: every lane
carries its own trip counter and state; each trip computes the body for
all lanes and keeps the result only on lanes whose condition still
holds, so a lane that has finished stays frozen while its siblings run.
The loop condition is read on the host once per trip (`host_any`).

Selection is stable everywhere `lax.top_k`/`argmin` are in the
reference: ties go to the lower index (a stable ascending sort, or
`argmin`/`argmax`, which return the first extremum).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import torch

from repro_torch._device import host_any
from repro_torch.core import simhash
from repro_torch.core.iostats import IOStats
from repro_torch.core.sentinel import declared_sync
from repro_torch.kernels.gather_l2.ops import gather_l2
from repro_torch.kernels.simhash.ops import collision_count_rows

INF = float("inf")


class BeamResult(NamedTuple):
    ids: torch.Tensor        # int32[Bq, ef] — best ids found, ascending distance
    dists: torch.Tensor      # f32[Bq, ef]
    stats: IOStats           # int32[Bq] per field
    # heat arrays have iter_cap * n_expand entries per lane, where
    # iter_cap = min(max_iters, ceil(max_iters / n_expand) + 3)
    heat_nodes: torch.Tensor  # int32[Bq, iter_cap * n_expand] (-1 pad)
    heat_mask: torch.Tensor   # bool[Bq, iter_cap * n_expand, M]


def stable_topk_asc(x: torch.Tensor, k: int):
    """The k smallest entries along the last axis, ties to the lower
    index: `lax.top_k(-x, k)` with its values negated back."""
    vals, idx = torch.sort(x, dim=-1, stable=True)
    return vals[..., :k], idx[..., :k]


def _rank_desc(score: torch.Tensor) -> torch.Tensor:
    """rank[..., i] = position of i when sorting score descending (stable)."""
    order = torch.sort(-score, dim=-1, stable=True).indices
    rank = torch.empty_like(order)
    rank.scatter_(-1, order, torch.arange(
        score.shape[-1], device=score.device).expand_as(order))
    return rank


def _first_occurrence(ids: torch.Tensor) -> torch.Tensor:
    """bool[..., n]: True where no earlier entry of the row holds the
    same value (the reference's comparison triangle)."""
    eq = ids[..., None, :] == ids[..., :, None]
    return ~torch.tril(eq, diagonal=-1).any(-1)


def _keep(go: torch.Tensor, new: torch.Tensor, old: torch.Tensor):
    """Per-lane select: the new value on running lanes, else the old."""
    return torch.where(go.reshape(go.shape + (1,) * (new.dim() - 1)),
                       new, old)


def beam_search(
    q: torch.Tensor,                 # f32[Bq, dim]
    entry: torch.Tensor,             # int32[Bq] — entry node ids
    entry_dist: torch.Tensor,        # f32[Bq] — distance(q, entry)
    adj_fn: Callable,                # nodes int32[Bq, B] -> (rows [Bq, B, M], probes [Bq, B])
    dist_fn: Callable,               # ids int32[Bq, n] -> f32[Bq, n] (inf for id<0)
    codes: torch.Tensor,             # int64[cap, W] in-memory hash codes
    code_q: torch.Tensor,            # int64[Bq, W]
    live: torch.Tensor,              # bool[cap] — node liveness (routable)
    *,
    cap: int,
    ef: int,
    k: int,
    m_bits: int,
    eps: float,
    rho: float,                      # sampling ratio: fetch ceil(rho * |eligible|)
    max_iters: int,
    use_filter: bool,
    q_norm: torch.Tensor,            # f32[Bq]
    mean_norm: torch.Tensor,         # f32[]
    n_expand: int = 1,               # B: frontier nodes expanded per iteration
    M: int,                          # adjacency row width of `adj_fn`
    active: torch.Tensor | None = None,      # bool[Bq] — False: inert lane
    returnable: torch.Tensor | None = None,  # bool[cap] — None: all of `live`
    fetch_fn: Callable | None = None,        # (row, eligible, thr) -> (mask, dists)
) -> BeamResult:
    """Batched sampling-guided beam search; one lane per query row.

    `adj_fn` is the batched adjacency reader: the B popped node ids of
    every lane at once (-1 for inactive expansion slots, which must
    yield all -1 rows).  `live` is the routable mask; `returnable`
    (optional) is the stricter mask of nodes allowed in the final result
    list — the lazy-deletion contract: tombstoned nodes stay routable
    but are re-packed out of the heap after the loop.

    `max_iters` budgets expansions, not loop trips; a lane runs until
    the budget, its trip cap or its frontier is exhausted.  An inactive
    lane (`active` False) never enters the loop, returns all -1/inf,
    records no heat and contributes zero IOStats.

    `fetch_fn` (optional) is a trip's whole fetch in one call: row
    int32[Bq, n], eligible bool[Bq, n] and the Hoeffding threshold
    thr f32[Bq] (-inf where the k-th beam distance is not finite) ->
    (fetch_mask, dists), as `kernels.prefilter_gather` computes them
    with the codes and rows it closes over.  It is taken where the
    filter is on and nothing samples (rho >= 1); elsewhere a trip
    counts through `collision_count_rows` and fetches through `dist_fn`,
    and the results are the same either way.
    """
    dev = q.device
    nq = q.shape[0]
    B = max(1, min(n_expand, ef))
    iter_cap = min(max_iters, -(-max_iters // B) + 3)
    heat_len = iter_cap
    i32 = torch.int32
    lanes = torch.arange(nq, device=dev)

    entry = entry.to(i32)
    entry_dist = entry_dist.to(torch.float32)
    if active is None:
        entry_n_vec = torch.ones(nq, dtype=i32, device=dev)
    else:
        entry_dist = torch.where(active, entry_dist, INF)
        entry = torch.where(active, entry, -1)
        entry_n_vec = active.to(i32)
    beam_ids = torch.full((nq, ef), -1, dtype=i32, device=dev)
    beam_ids[:, 0] = entry
    beam_d = torch.full((nq, ef), INF, dtype=torch.float32, device=dev)
    beam_d[:, 0] = entry_dist
    expanded = torch.zeros((nq, ef), dtype=torch.bool, device=dev)
    visited = torch.zeros((nq, cap + 1), dtype=torch.bool, device=dev)
    visited[lanes, entry.clamp_min(0).long()] = entry >= 0
    # one spare trip row takes the writes of frozen lanes
    heat_nodes = torch.full((nq, heat_len + 1, B), -1, dtype=i32, device=dev)
    heat_mask = torch.zeros((nq, heat_len + 1, B, M), dtype=torch.bool,
                            device=dev)
    zero = torch.zeros(nq, dtype=i32, device=dev)
    n_adj, n_vec, n_filt, n_hops = zero, entry_n_vec, zero, zero
    it = zero

    # frontier threshold: stop expanding once every candidate within the
    # 3k-th best has been visited
    fidx = min(ef, 3 * k) - 1
    live_pad = torch.cat([live.to(torch.bool),
                          torch.zeros(1, dtype=torch.bool, device=dev)])
    static_all = isinstance(rho, (int, float)) and rho >= 1.0
    fused_fetch = fetch_fn is not None and use_filter and static_all

    while True:
        thresh = beam_d[:, fidx]
        frontier = (~expanded) & torch.isfinite(beam_d) \
            & (beam_d <= thresh[:, None])
        go = (it < iter_cap) & (n_hops < max_iters) & frontier.any(1)
        with declared_sync("loop-trip exit"):
            if not host_any(go):
                break

        # -- pop the B closest unexpanded candidates -----------------------
        frontier_d = torch.where(expanded, INF, beam_d)
        if B == 1:
            slots = frontier_d.argmin(1, keepdim=True)
        else:
            slots = stable_topk_asc(frontier_d, B)[1]
        sel_d = frontier_d.gather(1, slots)
        act = torch.isfinite(sel_d) & (sel_d <= thresh[:, None])
        new_expanded = expanded.scatter(
            1, slots, expanded.gather(1, slots) | act)
        nodes = torch.where(act, beam_ids.gather(1, slots), -1)

        # -- batched adjacency read (t_n) ----------------------------------
        rows, n_probes = adj_fn(nodes)                  # [Bq, B, M], [Bq, B]
        row = rows.reshape(nq, B * M)
        valid = (row >= 0) & (row <= cap - 1)
        safe = torch.where(valid, row, cap).long()
        seen = visited.gather(1, safe)
        alive = valid & live_pad[safe]
        eligible = valid & (~seen) & alive
        if B > 1:
            # duplicates across the B rows would enter the beam twice
            eligible = eligible & _first_occurrence(safe)

        # -- SimHash prefilter (Eq. 5-6), in-memory, whole block: counts
        #    against the codes of the row's ids (out-of-range ids are
        #    clamped by the kernel and masked by `eligible`).  Without the
        #    filter and the sampling cap nothing reads them, so they are
        #    not counted (the reference computes them and its compiled
        #    form drops the dead value) ---------------------------------
        delta_sq = beam_d[:, k - 1]
        if use_filter:
            cos = simhash.cos_from_l2(delta_sq, q_norm, mean_norm)
            thr = simhash.hoeffding_threshold(m_bits, eps, cos)
        if fused_fetch:
            # the prefilter and the fetch of its survivors (t_v each) in
            # one call; an unfilled beam (k-th distance +inf) keeps every
            # eligible id, as `| ~isfinite(delta_sq)` does below (a squared
            # distance is never -inf, so `< INF` is that test in one
            # launch where `isfinite` takes several on the card)
            thr = torch.where(delta_sq < INF, thr, -INF)
            fetch_mask, dists = fetch_fn(row.contiguous(), eligible, thr)
            fetch_ids = torch.where(fetch_mask, row, -1)
        else:
            if use_filter or not static_all:
                cols = collision_count_rows(code_q, codes, row.contiguous(),
                                            m_bits)
            if use_filter:
                pass_thr = (cols.to(torch.float32) >= thr[:, None]) \
                    | ~torch.isfinite(delta_sq)[:, None]
                pre_mask = eligible & pass_thr
            else:
                pre_mask = eligible

            # -- sampling cap (Eq. 8): evaluate only rho of the survivors,
            #    keeping the most-colliding ones --------------------------
            if static_all:
                fetch_mask = pre_mask
            else:
                score = torch.where(pre_mask, cols, -1)
                rank = _rank_desc(score)
                n_elig = pre_mask.sum(1, dtype=i32)
                cap_dyn = torch.ceil(rho * n_elig.to(torch.float32)).to(i32)
                fetch_mask = pre_mask & (rank < cap_dyn[:, None])
            fetch_ids = torch.where(fetch_mask, row, -1)

            # -- one fused gather+distance call over the B*M block (t_v
            #    each) -----------------------------------------------------
            dists = dist_fn(fetch_ids)

        # -- bookkeeping ----------------------------------------------------
        # in place: frozen lanes write only to the spare slot `cap`,
        # which is never read as a real node's flag
        visited.scatter_(
            1, torch.where(fetch_mask & go[:, None], safe, cap), True)
        n_fetch = fetch_mask.sum(1, dtype=i32)
        new_stats = (
            n_adj + torch.where(act, n_probes, 0).sum(1, dtype=i32),
            n_vec + n_fetch,
            n_filt + eligible.sum(1, dtype=i32) - n_fetch,
            n_hops + act.sum(1, dtype=i32))
        trip = torch.where(go, it, heat_len).long()
        heat_nodes[lanes, trip] = nodes
        heat_mask[lanes, trip] = fetch_mask.reshape(nq, B, M)

        # -- single merge of the whole block into the beam ------------------
        all_ids = torch.cat([beam_ids, fetch_ids], 1)
        all_d = torch.cat([beam_d, dists], 1)
        # new candidates are unexpanded; masked ones are marked expanded
        all_exp = torch.cat([new_expanded, ~fetch_mask], 1)
        top_d, order = stable_topk_asc(all_d, ef)

        beam_ids = _keep(go, all_ids.gather(1, order), beam_ids)
        beam_d = _keep(go, top_d, beam_d)
        expanded = _keep(go, all_exp.gather(1, order), expanded)
        n_adj, n_vec, n_filt, n_hops = (
            _keep(go, new, old) for new, old in
            zip(new_stats, (n_adj, n_vec, n_filt, n_hops)))
        it = it + go.to(i32)

    if returnable is not None:
        # routable-but-not-returnable entries (tombstones) are demoted to
        # +inf/-1 and the survivors re-packed to the front
        ok = (beam_ids >= 0) & returnable[beam_ids.clamp(0, cap - 1).long()]
        beam_d = torch.where(ok, beam_d, INF)
        beam_d, order = stable_topk_asc(beam_d, ef)
        beam_ids = torch.where(torch.isfinite(beam_d),
                               beam_ids.gather(1, order), -1)
    return BeamResult(beam_ids, beam_d, IOStats(n_adj, n_vec, n_filt, n_hops),
                      heat_nodes[:, :heat_len].reshape(nq, heat_len * B),
                      heat_mask[:, :heat_len].reshape(nq, heat_len * B, M))


def greedy_descent(
    q: torch.Tensor,               # f32[Bq, dim]
    entry: torch.Tensor,           # int32[Bq]
    entry_dist: torch.Tensor,      # f32[Bq]
    adj: torch.Tensor,             # int32[cap, M_up] — one upper layer
    vectors: torch.Tensor,         # f32[cap, dim]
    live: torch.Tensor,            # bool[cap]
    *,
    max_steps: int = 64,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy routing in one memory-resident upper layer (Alg. 1 lines
    6-8), batched over lanes; a lane stops when no neighbor improves.

    Upper-layer nodes are <1% of the data and their vectors are cached
    in RAM (paper §3.2), so these reads cost no slow-tier I/O.
    """
    cap = adj.shape[0]
    q = q.to(torch.float32).contiguous()
    ep = entry.to(torch.int32)
    d_ep = entry_dist.to(torch.float32)
    step = 0
    moved = torch.ones(ep.shape, dtype=torch.bool, device=q.device)
    while step < max_steps:
        with declared_sync("greedy-descent step"):
            if not host_any(moved):
                break
        row = adj[ep.long()]                                  # [Bq, M_up]
        valid = (row >= 0) & live[row.clamp(0, cap - 1).long()]
        # the gather kernel sums in one order on every device, so the
        # entry distance handed to the beam has the same bits everywhere
        d = gather_l2(q, vectors, torch.where(valid, row, -1))
        j = d.argmin(1, keepdim=True)
        dj = d.gather(1, j)[:, 0]
        better = moved & (dj < d_ep)
        ep = torch.where(better, row.gather(1, j)[:, 0], ep)
        d_ep = torch.where(better, dj, d_ep)
        moved = better
        step += 1
    return ep, d_ep
