"""Connectivity-aware graph reordering (paper §3.4, Eq. 10-12).

The counterpart of `repro.core.reorder`.  Chooses a node permutation phi
that maximizes the windowed edge score

    F(phi) = sum_{0 < phi(v) - phi(u) <= w} S(u, v)           (Eq. 12)

with the paper's sampling-driven score

    S(u, v) = S_s(u, v) + S_n(u, v) * (1 + lambda * heat(u, v))   (Eq. 11)

where S_s counts shared in-neighbors, S_n direct edges (Gorder, Eq. 10),
and `heat` is the per-edge fetch count the traversal records.

The greedy window placement follows Gorder [Wei et al., SIGMOD'16]: place
the unplaced node with the largest score against the current w-window;
placing u credits +S to candidates sharing an in-neighbor with or adjacent
to u, and nodes sliding out of the window debit their contribution.

This is the compaction-time path, a host pass piggybacked on LSM
compaction: the placement is plain numpy, the reference's arithmetic in
the reference's order (f64 gains, `np.add.at`), so it returns the
reference's permutation exactly.  `apply_permutation` rewrites the index
state's tensors and LSM keys on their device, so that physical id order
matches the new layout.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch.core import hnsw, lsm


def _csr_from_rows(rows: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """rows int32[n, M] (-1 padded) -> CSR (indptr, indices) of out-edges."""
    n = rows.shape[0]
    mask = rows >= 0
    deg = mask.sum(axis=1)
    indptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=indptr[1:])
    indices = rows[mask].astype(np.int64)
    return indptr, indices


def _reverse_csr(indptr, indices, n) -> Tuple[np.ndarray, np.ndarray]:
    rdeg = np.bincount(indices, minlength=n)
    rptr = np.zeros(n + 1, np.int64)
    np.cumsum(rdeg, out=rptr[1:])
    ridx = np.empty(indices.shape[0], np.int64)
    fill = rptr[:-1].copy()
    src = np.repeat(np.arange(n, dtype=np.int64), np.diff(indptr))
    for s, d in zip(src, indices):
        ridx[fill[d]] = s
        fill[d] += 1
    return rptr, ridx


def gorder_permutation(rows: np.ndarray, heat: np.ndarray | None = None,
                       *, window: int = 8, lam: float = 1.0,
                       live: np.ndarray | None = None) -> np.ndarray:
    """Greedy windowed placement maximizing Eq. 12.

    rows: int32[n, M] adjacency (-1 padded); heat: int32[n, M] edge fetch
    counts aligned with `rows`; returns perm int32[n] with perm[old] = new.
    Dead nodes (live == False) are placed last, preserving relative order.
    """
    n, m = rows.shape
    rows = np.asarray(rows)
    live = np.ones(n, bool) if live is None else np.asarray(live).astype(bool)
    heat = np.zeros_like(rows) if heat is None else np.asarray(heat)

    # per-edge weight for the S_n term: 1 + lam * normalized heat
    hmax = max(float(heat.max()), 1.0)
    w_edge = np.where(rows >= 0, 1.0 + lam * heat / hmax, 0.0)

    indptr, indices = _csr_from_rows(np.where(live[:, None], rows, -1))
    edge_w = w_edge[np.where(live[:, None], rows, -1) >= 0]
    rptr, ridx = _reverse_csr(indptr, indices, n)

    gain = np.zeros(n, np.float64)
    placed = np.zeros(n, bool)
    order: list[int] = []
    window_nodes: list[int] = []

    def neighbors(u):
        return indices[indptr[u]:indptr[u + 1]], edge_w[indptr[u]:indptr[u + 1]]

    def in_neighbors(u):
        return ridx[rptr[u]:rptr[u + 1]]

    def credit(u, sign):
        # S_n: direct out- and in-edges of u (weighted by heat)
        nbr, wts = neighbors(u)
        np.add.at(gain, nbr, sign * wts)
        inn = in_neighbors(u)
        np.add.at(gain, inn, sign * 1.0)
        # S_s: nodes sharing an in-neighbor with u
        for w_ in inn:
            sib, _ = neighbors(w_)
            np.add.at(gain, sib, sign * 1.0)

    live_ids = np.flatnonzero(live)
    dead_ids = np.flatnonzero(~live)
    if live_ids.size:
        # seed: highest-degree live node
        deg = np.diff(indptr)
        start = int(live_ids[np.argmax(deg[live_ids])])
        order.append(start)
        placed[start] = True
        window_nodes.append(start)
        credit(start, +1.0)
        for _ in range(live_ids.size - 1):
            masked = np.where(placed | ~live, -np.inf, gain)
            u = int(np.argmax(masked))
            if not np.isfinite(masked[u]):
                u = int(live_ids[~placed[live_ids]][0] if
                        (~placed[live_ids]).any() else -1)
            order.append(u)
            placed[u] = True
            window_nodes.append(u)
            credit(u, +1.0)
            if len(window_nodes) > window:
                old = window_nodes.pop(0)
                credit(old, -1.0)
    order.extend(dead_ids.tolist())   # one batched conversion, not per-id

    perm = np.empty(n, np.int32)
    perm[np.asarray(order, np.int64)] = np.arange(n, dtype=np.int32)
    return perm


def layout_score(rows: np.ndarray, perm: np.ndarray,
                 heat: np.ndarray | None = None, *, window: int = 8,
                 lam: float = 1.0) -> float:
    """Evaluate Eq. 12 for a layout: windowed sum of edge scores."""
    rows = np.asarray(rows)
    n, m = rows.shape
    heat = np.zeros_like(rows) if heat is None else np.asarray(heat)
    hmax = max(float(heat.max()), 1.0)
    src = np.repeat(np.arange(n), m)
    dst = rows.reshape(-1)
    wts = (1.0 + lam * heat.reshape(-1) / hmax)
    ok = dst >= 0
    src, dst, wts = src[ok], dst[ok], wts[ok]
    gap = np.abs(perm[dst].astype(np.int64) - perm[src].astype(np.int64))
    return float(np.sum(wts * ((gap > 0) & (gap <= window))))


def block_io_count(fetch_sequences: list[np.ndarray], perm: np.ndarray,
                   *, block_rows: int = 8) -> int:
    """I/O blocks touched if vectors are laid out by `perm` (Fig. 4 metric).

    Each element of `fetch_sequences` is the array of node ids fetched in
    one traversal hop; ids in the same physical block cost one read.
    """
    total = 0
    for ids in fetch_sequences:
        if ids.size == 0:
            continue
        blocks = np.unique(perm[ids] // block_rows)
        total += blocks.size
    return int(total)


def apply_permutation(cfg: hnsw.HNSWConfig, state: hnsw.HNSWState,
                      perm: np.ndarray) -> hnsw.HNSWState:
    """Physically relayout the index: node id k moves to perm[k] (ids past
    `perm`'s length keep theirs).  Every per-node lane moves with it —
    vectors, norms, codes, levels, upper rows, heat, the tombstone lane
    and the tier lanes — and every stored id (upper and LSM rows, LSM
    keys, the entry) is renamed.  Applied at a major LSM compaction (the
    paper piggybacks the rewrite on work the LSM does anyway)."""
    dev = state.vectors.device
    n = perm.shape[0]
    full = np.arange(cfg.cap, dtype=np.int32)
    full[:n] = perm
    perm_t = torch.as_tensor(full, device=dev)
    inv = torch.empty_like(perm_t)                  # inv[new] = old
    inv[perm_t.long()] = torch.arange(cfg.cap, dtype=torch.int32,
                                      device=dev)
    inv = inv.long()

    def remap_rows(rows):
        return torch.where(rows >= 0, perm_t[rows.clamp_min(0).long()], rows)

    return state._replace(
        vectors=state.vectors[inv],
        norms=state.norms[inv],
        codes=state.codes[inv],
        levels=state.levels[inv],
        upper_adj=remap_rows(state.upper_adj)[:, inv, :],
        store=lsm.remap_ids(cfg.lsm_cfg, state.store, perm_t),
        entry=torch.where(state.entry >= 0,
                          perm_t[state.entry.clamp_min(0).long()],
                          state.entry),
        heat=state.heat[inv],
        tombstone=state.tombstone[inv],
        hot=state.hot[inv],
        qvecs=state.qvecs[inv],
        qscale=state.qscale[inv],
        tier_heat=state.tier_heat[inv])
