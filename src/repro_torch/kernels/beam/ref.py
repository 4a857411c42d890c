"""Plain PyTorch version of the fused beam-search megakernel.

`beam_search_ref` runs the whole bottom-layer beam search for a block of
queries over dense operands — the counterpart of
`repro.kernels.beam.ref.beam_search_ref`, written batched over the query
lanes instead of vmapped.  It is the CPU route of
`ops.fused_beam_search` and the plain version `csrc/beam.cu` is held
against on the card.

It follows the port's `core.traversal.beam_search` op for op (the same
trip cap, stable tie-breaks, SimHash / Hoeffding / rho arithmetic,
lazy-delete repack and heat lanes), specialized to the serving path's
operands: adjacency from a resolved snapshot (one gather per popped
node, one read each in `n_adj`), distances from the dense vector table
(`gather_l2_ref`) and, under the tier split, the int8 cold lane
(`gather_l2_q8_ref`) merged by elementwise min.

The loop is the kernel's: a fixed `iter_cap` trips with a monotone `go`
mask and no host read.  A trip whose continuation test fails selects
nothing (`act` is all False), so it fetches nothing and its merge keeps
the sorted heap as it was; the stopped lane's results equal those of a
loop that left early.
"""

from __future__ import annotations

import torch

from repro_torch.core import simhash
from repro_torch.core.traversal import (
    _first_occurrence,
    _rank_desc,
    stable_topk_asc,
)
from repro_torch.kernels.gather_l2.ref import gather_l2_q8_ref, gather_l2_ref

INF = float("inf")


def beam_iter_cap(max_iters: int, n_expand: int, ef: int) -> int:
    """Trip cap shared with `traversal.beam_search` (heat arrays are
    sized by it, so callers on either path see identical shapes)."""
    b = max(1, min(n_expand, ef))
    return min(max_iters, -(-max_iters // b) + 3)


def beam_search_ref(qs, entries, entry_dists, adjacency, vectors, codes,
                    code_qs, live, q_norms, mean_norm, *, returnable=None,
                    resident=None, qvecs=None, qscale=None, active=None,
                    ef, k, m_bits, eps, rho, max_iters, use_filter,
                    n_expand=1, record_heat=True):
    """Whole-block beam search over dense operands.

    qs f32[Bq, dim]; entries int32[Bq]; entry_dists f32[Bq]; adjacency
    int32[cap, M] (resolved snapshot rows, -1 pads); vectors f32[cap,
    dim]; codes int64[cap, W]; code_qs int64[Bq, W]; live bool[cap]
    (routable); q_norms f32[Bq]; mean_norm f32[].  Optional lanes:
    `returnable` bool[cap] (lazy-delete repack), `resident`/`qvecs`/
    `qscale` (tier split), `active` bool[Bq] (pad-lane masking).
    Returns ``(ids [Bq, ef], dists [Bq, ef], stats int32[Bq, 4],
    heat_nodes [Bq, iter_cap*B], heat_mask [Bq, iter_cap*B, M])`` with
    the stats columns (n_adj, n_vec, n_filtered, n_hops).
    """
    dev = qs.device
    nq = qs.shape[0]
    cap, M = adjacency.shape
    B = max(1, min(n_expand, ef))
    iter_cap = beam_iter_cap(max_iters, n_expand, ef)
    i32 = torch.int32
    lanes = torch.arange(nq, device=dev)
    tier = resident is not None

    def dist_fn(ids):
        if not tier:
            return gather_l2_ref(qs, vectors, ids)
        res = resident[ids.clamp_min(0).long()]
        hot_ids = torch.where((ids >= 0) & res, ids, -1)
        cold_ids = torch.where((ids >= 0) & ~res, ids, -1)
        return torch.minimum(gather_l2_ref(qs, vectors, hot_ids),
                             gather_l2_q8_ref(qs, qvecs, qscale, cold_ids))

    entry = entries.to(i32)
    entry_d = entry_dists.to(torch.float32)
    if active is None:
        n_vec = torch.ones(nq, dtype=i32, device=dev)
    else:
        entry = torch.where(active, entry, -1)
        entry_d = torch.where(active, entry_d, INF)
        n_vec = active.to(i32)
    beam_ids = torch.full((nq, ef), -1, dtype=i32, device=dev)
    beam_ids[:, 0] = entry
    beam_d = torch.full((nq, ef), INF, dtype=torch.float32, device=dev)
    beam_d[:, 0] = entry_d
    expanded = torch.zeros((nq, ef), dtype=torch.bool, device=dev)
    visited = torch.zeros((nq, cap + 1), dtype=torch.bool, device=dev)
    visited[lanes, entry.clamp_min(0).long()] = entry >= 0
    heat_nodes = torch.full((nq, iter_cap, B), -1, dtype=i32, device=dev)
    heat_mask = torch.zeros((nq, iter_cap, B, M), dtype=torch.bool,
                            device=dev)
    zero = torch.zeros(nq, dtype=i32, device=dev)
    n_adj, n_filt, n_hops = zero, zero, zero
    go = torch.ones(nq, dtype=torch.bool, device=dev)
    fidx = min(ef, 3 * k) - 1
    live_pad = torch.cat([live.to(torch.bool),
                          torch.zeros(1, dtype=torch.bool, device=dev)])
    static_all = isinstance(rho, (int, float)) and rho >= 1.0

    for it in range(iter_cap):
        thresh = beam_d[:, fidx]
        frontier = (~expanded) & torch.isfinite(beam_d) \
            & (beam_d <= thresh[:, None])
        go = go & (n_hops < max_iters) & frontier.any(1)

        # -- pop the B closest unexpanded candidates ------------------------
        frontier_d = torch.where(expanded, INF, beam_d)
        slots = stable_topk_asc(frontier_d, B)[1]
        sel_d = frontier_d.gather(1, slots)
        act = go[:, None] & torch.isfinite(sel_d) \
            & (sel_d <= thresh[:, None])
        expanded = expanded.scatter(1, slots, expanded.gather(1, slots) | act)
        nodes = torch.where(act, beam_ids.gather(1, slots), -1)

        # -- snapshot adjacency: one gather per popped row ------------------
        rows = adjacency[nodes.clamp_min(0).long()]
        row = torch.where((nodes >= 0)[..., None], rows, -1).reshape(
            nq, B * M)
        valid = (row >= 0) & (row <= cap - 1)
        safe = torch.where(valid, row, cap).long()
        eligible = valid & ~visited.gather(1, safe) & live_pad[safe]
        if B > 1:
            # duplicates across the B rows would enter the beam twice
            eligible = eligible & _first_occurrence(safe)

        # -- SimHash prefilter (Eq. 5-6) -------------------------------------
        cand_codes = codes[safe.clamp_max(cap - 1)]
        cols = simhash.collisions(code_qs[:, None, :], cand_codes, m_bits)
        if use_filter:
            delta_sq = beam_d[:, k - 1]
            cos = simhash.cos_from_l2(delta_sq, q_norms, mean_norm)
            thr = simhash.hoeffding_threshold(m_bits, eps, cos)
            pre_mask = eligible & ((cols.to(torch.float32) >= thr[:, None])
                                   | ~torch.isfinite(delta_sq)[:, None])
        else:
            pre_mask = eligible

        # -- sampling cap (Eq. 8) --------------------------------------------
        if static_all:
            fetch_mask = pre_mask
        else:
            rank = _rank_desc(torch.where(pre_mask, cols, -1))
            n_elig = pre_mask.sum(1, dtype=i32)
            cap_dyn = torch.ceil(rho * n_elig.to(torch.float32)).to(i32)
            fetch_mask = pre_mask & (rank < cap_dyn[:, None])
        fetch_ids = torch.where(fetch_mask, row, -1)
        dists = dist_fn(fetch_ids)

        # -- bookkeeping -----------------------------------------------------
        visited.scatter_(1, torch.where(fetch_mask, safe, cap), True)
        n_fetch = fetch_mask.sum(1, dtype=i32)
        n_act = act.sum(1, dtype=i32)
        n_adj = n_adj + n_act
        n_vec = n_vec + n_fetch
        n_filt = n_filt + eligible.sum(1, dtype=i32) - n_fetch
        n_hops = n_hops + n_act
        if record_heat:
            heat_nodes[:, it] = nodes
            heat_mask[:, it] = fetch_mask.reshape(nq, B, M)

        # -- one merge of the whole block into the heap ----------------------
        all_ids = torch.cat([beam_ids, fetch_ids], 1)
        all_d = torch.cat([beam_d, dists], 1)
        all_exp = torch.cat([expanded, ~fetch_mask], 1)
        beam_d, order = stable_topk_asc(all_d, ef)
        beam_ids = all_ids.gather(1, order)
        expanded = all_exp.gather(1, order)

    if returnable is not None:
        ok = (beam_ids >= 0) & returnable[beam_ids.clamp(0, cap - 1).long()]
        beam_d, order = stable_topk_asc(torch.where(ok, beam_d, INF), ef)
        beam_ids = torch.where(torch.isfinite(beam_d),
                               beam_ids.gather(1, order), -1)
    stats = torch.stack([n_adj, n_vec, n_filt, n_hops], 1)
    return (beam_ids, beam_d, stats, heat_nodes.reshape(nq, iter_cap * B),
            heat_mask.reshape(nq, iter_cap * B, M))
