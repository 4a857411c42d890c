"""DiskANN-like baseline: static disk graph with degraded dynamic behavior
(the counterpart of `repro.core.baselines.diskann`).

Models the system the paper compares against (§2.2 / §5):
 - offline-built pruned proximity graph (alpha-pruned greedy graph a la
   Vamana), medoid entry point;
 - search = best-first beam with *exhaustive* neighbor evaluation — every
   neighbor of every visited node costs one slow-tier vector fetch (no
   sampling filter, Eq. 7's full cost);
 - inserts are appended: the new node gets out-edges from a search, but
   back-edges are written in-place into neighbors' fixed-size rows only
   when there is free room (no relayout; paper: "appended ... without being
   properly integrated"), and the delta graph + vectors stay RAM-resident
   until the next full rebuild (Fig. 6's memory growth);
 - deletes are tombstones only; the graph fragments over time (recall drop
   in the Delete-heavy workload, Fig. 5a).

Host-side numpy, as in the reference; the build's dense distance blocks
go through the `l2_distance` kernel on the index's device.
"""

from __future__ import annotations

import heapq
from typing import Tuple

import numpy as np
import torch

from repro_torch._device import resolve, upload
from repro_torch.core.iostats import IOStats
from repro_torch.kernels.l2_distance.ops import l2_distance


class DiskANNIndex:
    def __init__(self, dim: int, M: int = 16, ef: int = 48,
                 alpha: float = 1.2, seed: int = 0, device=None):
        self.dim = dim
        self.M = M
        self.ef = ef
        self.alpha = alpha
        self.device = resolve(device)
        self.rng = np.random.default_rng(seed)
        self.vectors = np.zeros((0, dim), np.float32)
        self.adj: list[np.ndarray] = []
        self.live = np.zeros((0,), bool)
        self.entry = 0
        self.n_base = 0          # size at last full build (on-disk part)
        self.io_stats = IOStats.zero()
        self._zero_stats()

    def _zero_stats(self):
        self._n_adj = 0
        self._n_vec = 0
        self._n_hops = 0
        self._n_write = 0

    def _flush_stats(self):
        # in-place sector updates are read-modify-write: 2 I/Os per write
        # (the update-cost asymmetry the paper's LSM design removes)
        self.io_stats = self.io_stats + IOStats(*(
            torch.tensor(v, dtype=torch.int32) for v in (
                self._n_adj + 2 * self._n_write, self._n_vec, 0,
                self._n_hops)))
        self._zero_stats()

    # -- construction ---------------------------------------------------------

    @classmethod
    def build(cls, vectors, M: int = 16, ef: int = 48, seed: int = 0,
              block: int = 1024, device=None) -> "DiskANNIndex":
        vectors = np.asarray(vectors, np.float32)
        n, dim = vectors.shape
        idx = cls(dim, M=M, ef=ef, seed=seed, device=device)
        idx.vectors = vectors.copy()
        idx.live = np.ones(n, bool)
        # alpha-pruned graph (offline, "free" — not counted as I/O).
        # Vamana starts from a random graph, so the candidate pool mixes
        # the 4M nearest with random long-range nodes — without the random
        # arm, well-separated clusters would disconnect.
        rng = np.random.default_rng(seed)
        table = upload(np.ascontiguousarray(vectors), idx.device)
        rows = []
        for s in range(0, n, block):
            d = l2_distance(table[s:s + block], table).cpu().numpy()
            for r, row_d in enumerate(d):
                row_d[s + r] = np.inf
                near = np.argpartition(row_d, 4 * M)[: 4 * M]
                far = rng.integers(0, n, 2 * M)
                cand = np.unique(np.concatenate([near, far]))
                cand = cand[cand != s + r]
                cand = cand[np.argsort(row_d[cand])]
                rows.append(idx._alpha_prune(s + r, cand, row_d[cand]))
        idx.adj = rows
        idx.entry = int(np.argmin(
            ((vectors - vectors.mean(0)) ** 2).sum(1)))  # medoid
        idx.n_base = n
        return idx

    def _alpha_prune(self, node: int, cand: np.ndarray,
                     cand_d: np.ndarray) -> np.ndarray:
        """Vamana alpha-pruning: keep diverse close neighbors."""
        keep: list[int] = []
        for c, dc in zip(cand, cand_d):
            if len(keep) >= self.M:
                break
            ok = True
            for kpt in keep:
                d_ck = float(((self.vectors[c] - self.vectors[kpt]) ** 2).sum())
                if self.alpha * d_ck < dc:
                    ok = False
                    break
            if ok:
                keep.append(int(c))
        return np.asarray(keep, np.int64)

    # -- search ---------------------------------------------------------------

    def _beam(self, q: np.ndarray, ef: int) -> list[tuple[float, int]]:
        d0 = float(((q - self.vectors[self.entry]) ** 2).sum())
        self._n_vec += 1
        visited = {self.entry}
        cand = [(d0, self.entry)]
        result = [(-d0, self.entry)]
        while cand:
            d, u = heapq.heappop(cand)
            if result and d > -result[0][0] and len(result) >= ef:
                break
            self._n_adj += 1
            self._n_hops += 1
            nbrs = [v for v in self.adj[u] if v not in visited]
            visited.update(nbrs)
            if not nbrs:
                continue
            # exhaustive evaluation: every neighbor fetched (Eq. 7)
            dv = ((self.vectors[nbrs] - q) ** 2).sum(1)
            self._n_vec += len(nbrs)
            for v, dvv in zip(nbrs, dv):
                dvv = float(dvv)
                if len(result) < ef or dvv < -result[0][0]:
                    heapq.heappush(cand, (dvv, int(v)))
                    heapq.heappush(result, (-dvv, int(v)))
                    if len(result) > ef:
                        heapq.heappop(result)
        out = sorted((-nd, v) for nd, v in result)
        return out

    def search(self, queries, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        queries = np.atleast_2d(np.asarray(queries, np.float32))
        ids = np.full((len(queries), k), -1, np.int64)
        dists = np.full((len(queries), k), np.inf, np.float32)
        for i, q in enumerate(queries):
            res = [(d, v) for d, v in self._beam(q, self.ef)
                   if self.live[v]][:k]
            for j, (d, v) in enumerate(res):
                ids[i, j] = v
                dists[i, j] = d
        self._flush_stats()
        return ids, dists

    # -- updates --------------------------------------------------------------

    def insert(self, x) -> int:
        x = np.asarray(x, np.float32)
        new_id = len(self.vectors)
        self.vectors = np.vstack([self.vectors, x[None]])
        self.live = np.append(self.live, True)
        res = self._beam(x, self.ef)
        nbrs = np.asarray([v for _, v in res[: 4 * self.M]], np.int64)
        nd = np.asarray([d for d, _ in res[: 4 * self.M]], np.float32)
        self.adj.append(self._alpha_prune(new_id, nbrs, nd))
        self._n_write += 1
        # back-edges only where a fixed-size row has room (in-place limit)
        for v in self.adj[new_id]:
            if len(self.adj[v]) < self.M:
                self.adj[v] = np.append(self.adj[v], new_id)
                self._n_write += 1
        self._flush_stats()
        return new_id

    def delete(self, node_id: int) -> None:
        # tombstone only — graph keeps routing through the corpse
        self.live[node_id] = False
        self._n_write += 1
        self._flush_stats()

    # -- accounting -----------------------------------------------------------

    def memory_bytes(self) -> int:
        """DiskANN keeps the full graph + update-delta vectors in RAM.

        The base vectors live on disk, but the graph rows and every vector
        inserted since the last rebuild are memory-resident (Fig. 6).
        """
        graph_bytes = sum(a.nbytes for a in self.adj)
        delta = len(self.vectors) - self.n_base
        delta_bytes = max(delta, 0) * self.dim * 4
        # in-memory quantized base vectors guide the search (PQ sketch ~ d bytes)
        pq_bytes = self.n_base * self.dim
        return graph_bytes + delta_bytes + pq_bytes + self.live.nbytes

    @property
    def size(self) -> int:
        return int(self.live.sum())

    def reset_stats(self):
        self.io_stats = IOStats.zero()
