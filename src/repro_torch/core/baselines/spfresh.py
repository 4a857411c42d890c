"""SPFresh-like baseline: coarse clustering index with in-place updates
(the counterpart of `repro.core.baselines.spfresh`).

Models the system the paper compares against (§2.3 / §5):
 - offline k-means partitions; centroids RAM-resident, posting lists on
   disk;
 - search probes the P closest centroids and scans *entire* postings —
   the coarse-partition recall ceiling the paper attributes to SPFresh
   (similar vectors split across cluster boundaries);
 - insert appends to the nearest posting *in place* (fast, one write);
   a posting that outgrows its page splits into two via 2-means (the
   LIRE-style local split), reassigning only that posting;
 - delete compacts the posting in place;
 - memory stays flat (centroids + page table only) — Fig. 6's stable
   curve.

Host-side numpy, as in the reference; the k-means assignments and the
probe distances go through the `l2_distance` kernel on the index's
device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from repro_torch._device import resolve, upload
from repro_torch.core.iostats import IOStats
from repro_torch.kernels.l2_distance.ops import l2_distance


class SPFreshIndex:
    def __init__(self, dim: int, posting_cap: int = 128, n_probe: int = 8,
                 seed: int = 0, device=None):
        self.dim = dim
        self.posting_cap = posting_cap
        self.n_probe = n_probe
        self.device = resolve(device)
        self.rng = np.random.default_rng(seed)
        self.vectors = np.zeros((0, dim), np.float32)
        self.live = np.zeros((0,), bool)
        self.centroids = np.zeros((0, dim), np.float32)
        self.postings: list[list[int]] = []
        self.io_stats = IOStats.zero()
        self._zero()

    def _zero(self):
        self._n_adj = 0   # posting-list page reads/writes
        self._n_vec = 0   # vector fetches (posting scans)
        self._n_hops = 0

    def _flush(self):
        self.io_stats = self.io_stats + IOStats(*(
            torch.tensor(v, dtype=torch.int32)
            for v in (self._n_adj, self._n_vec, 0, self._n_hops)))
        self._zero()

    # -- construction ---------------------------------------------------------

    @classmethod
    def build(cls, vectors, posting_cap: int = 128, n_probe: int = 8,
              seed: int = 0, kmeans_iters: int = 8,
              device=None) -> "SPFreshIndex":
        vectors = np.asarray(vectors, np.float32)
        n, dim = vectors.shape
        idx = cls(dim, posting_cap=posting_cap, n_probe=n_probe, seed=seed,
                  device=device)
        idx.vectors = vectors.copy()
        idx.live = np.ones(n, bool)
        k = max(4, int(np.ceil(2 * n / posting_cap)))
        rng = np.random.default_rng(seed)
        cent = vectors[rng.choice(n, k, replace=False)].copy()
        table = upload(np.ascontiguousarray(vectors), idx.device)

        def assign():
            # the first minimum on ties, as numpy's argmin
            d = l2_distance(table, upload(cent, idx.device))
            return d.argmin(1).cpu().numpy()

        for _ in range(kmeans_iters):
            asg = assign()
            for c in range(k):
                sel = vectors[asg == c]
                if len(sel):
                    cent[c] = sel.mean(0)
        asg = assign()
        idx.centroids = cent
        idx.postings = [list(np.flatnonzero(asg == c)) for c in range(k)]
        # enforce page capacity from the start
        for c in range(k):
            while len(idx.postings[c]) > idx.posting_cap:
                idx._split(c)
        return idx

    # -- search ---------------------------------------------------------------

    def search(self, queries, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        ids = np.full((len(queries), k), -1, np.int64)
        dists = np.full((len(queries), k), np.inf, np.float32)
        dc = l2_distance(upload(np.ascontiguousarray(queries), self.device),
                         upload(self.centroids, self.device)).cpu().numpy()
        for i, q in enumerate(queries):
            probe = np.argsort(dc[i])[: self.n_probe]
            cand: list[int] = []
            for c in probe:
                self._n_adj += 1            # posting page read
                cand.extend(self.postings[c])
            cand = [v for v in cand if self.live[v]]
            self._n_hops += 1
            if not cand:
                continue
            self._n_vec += len(cand)       # full posting scans
            dv = ((self.vectors[cand] - q) ** 2).sum(1)
            top = np.argsort(dv)[:k]
            ids[i, : len(top)] = np.asarray(cand)[top]
            dists[i, : len(top)] = dv[top]
        self._flush()
        return ids, dists

    # -- updates --------------------------------------------------------------

    def _nearest_centroid(self, x) -> int:
        d = ((self.centroids - x) ** 2).sum(1)
        return int(d.argmin())

    def _split(self, c: int) -> None:
        """LIRE-style local split: 2-means within one overflowing posting."""
        members = self.postings[c]
        pts = self.vectors[members]
        a, b = self.rng.choice(len(members), 2, replace=False)
        ca, cb = pts[a].copy(), pts[b].copy()
        for _ in range(4):
            da = ((pts - ca) ** 2).sum(1)
            db = ((pts - cb) ** 2).sum(1)
            to_a = da <= db
            if to_a.any():
                ca = pts[to_a].mean(0)
            if (~to_a).any():
                cb = pts[~to_a].mean(0)
        da = ((pts - ca) ** 2).sum(1)
        db = ((pts - cb) ** 2).sum(1)
        to_a = da <= db
        self.centroids[c] = ca
        self.centroids = np.vstack([self.centroids, cb[None]])
        self.postings[c] = [m for m, t in zip(members, to_a) if t]
        self.postings.append([m for m, t in zip(members, to_a) if not t])
        self._n_adj += 2                    # two page writes
        self._n_vec += len(members)         # reassignment scan

    def insert(self, x) -> int:
        x = np.asarray(x, np.float32)
        new_id = len(self.vectors)
        self.vectors = np.vstack([self.vectors, x[None]])
        self.live = np.append(self.live, True)
        c = self._nearest_centroid(x)
        self._n_vec += 1                    # centroid compare is in RAM;
        self._n_adj += 1                    # one in-place page append
        self.postings[c].append(new_id)
        if len(self.postings[c]) > self.posting_cap:
            self._split(c)
        self._flush()
        return new_id

    def delete(self, node_id: int) -> None:
        self.live[node_id] = False
        c = self._nearest_centroid(self.vectors[node_id])
        if node_id in self.postings[c]:
            self.postings[c].remove(node_id)
        else:                                # split may have moved it
            for p in self.postings:
                if node_id in p:
                    p.remove(node_id)
                    break
        self._n_adj += 1                    # in-place page rewrite
        self._flush()

    # -- accounting -----------------------------------------------------------

    def memory_bytes(self) -> int:
        """Centroids + page table are RAM-resident; postings are on disk."""
        page_table = len(self.postings) * 16
        return self.centroids.nbytes + page_table + self.live.nbytes

    @property
    def size(self) -> int:
        return int(self.live.sum())

    def reset_stats(self):
        self.io_stats = IOStats.zero()
