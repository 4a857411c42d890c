"""Sharded vector search on PyTorch — the counterpart of
`repro.core.distributed`.

The corpus is split into P shards, a query fans out to every shard,
each shard computes its local top-k, and a global top-k merge produces
the answer.  Recall of the merged result equals single-shard recall
because every shard is searched (SPANN-style partition serving).

The reference places shards on a JAX mesh (`shard_map`, `all_gather`).
PyTorch has neither: here shard s lives on ``devices[s % len(devices)]``
(by default the one card), its work is enqueued on that device, and the
merge runs on ``devices[0]`` (the flat index) or on the host
(`ShardedBackend`, through `merge_topk`).  Copies between cards are
plain ``.to``; there is no process group.

Two shard-local engines:
 - `ShardedFlatIndex`: exact blocked L2 scan through the `l2_distance`
   kernel;
 - `ShardedBackend`: P full `LSMVecIndex` shards behind the
   `VectorBackend` protocol — hash-partitioned routing, per-shard
   updates/tombstones/consolidation, fan-out search.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch._device import resolve, upload
from repro_torch.checkpoint import ckpt
from repro_torch.core import hnsw, iostats
from repro_torch.core.backend import (
    BackendStats,
    MaintenanceReport,
    SearchParams,
    SearchResult,
    UpdateResult,
    merge_topk,
    shard_of_seq,
)
from repro_torch.core.index import LSMVecIndex
from repro_torch.core.sentinel import declared_sync
from repro_torch.core.traversal import stable_topk_asc
from repro_torch.kernels.l2_distance.ops import l2_distance


def _devices(devices, n_shards: int) -> list:
    """Shard s's device: ``devices[s % len(devices)]``, the card when
    `devices` is None."""
    devs = [resolve(None)] if devices is None \
        else [resolve(d) for d in devices]
    return [devs[s % len(devs)] for s in range(n_shards)]


class ShardedFlatIndex:
    """Exact partitioned search over `n_shards` shards.

    The last shard is padded with rows of +inf, as the reference pads
    its mesh shards: a padded row's squared distance is inf - inf = NaN
    (the `l2_distance` kernel keeps NaN as its plain version does),
    which the search maps to +inf, so padded rows stay out of every
    top-k.
    """

    def __init__(self, n_shards: int, devices: Optional[Sequence] = None):
        self.n_shards = n_shards
        self.devices = _devices(devices, n_shards)
        self.shards: list = []        # f32[n_per, d] per shard
        self.n_per = 0

    def build(self, vectors: np.ndarray) -> "ShardedFlatIndex":
        p = self.n_shards
        n, d = vectors.shape
        n_per = -(-n // p)
        pad = n_per * p - n
        vecs = np.pad(vectors, ((0, pad), (0, 0)),
                      constant_values=np.inf).astype(np.float32)
        self.shards = [upload(vecs[s * n_per:(s + 1) * n_per], dev)
                       for s, dev in enumerate(self.devices)]
        self.n_per = n_per
        return self

    def search(self, queries, k: int = 10) -> Tuple[np.ndarray, np.ndarray]:
        """Top-10 of the merge, cut to `k` columns: the reference merges
        a fixed 10, so `k > 10` returns 10 columns.  Ties go to the lower
        position at both steps, as `lax.top_k` breaks them."""
        qs = np.ascontiguousarray(np.atleast_2d(queries), np.float32)
        k_loc = min(16, self.n_per)
        home = self.devices[0]
        all_d, all_i = [], []
        for s, (vecs, dev) in enumerate(zip(self.shards, self.devices)):
            d2 = l2_distance(upload(qs, dev), vecs)          # [Q, n_per]
            d2 = torch.where(torch.isfinite(d2), d2, torch.inf)
            dist, idx = stable_topk_asc(d2, k_loc)
            all_d.append(dist.to(home))
            all_i.append((idx + s * self.n_per).to(home))   # global ids
        dist, pos = stable_topk_asc(torch.cat(all_d, 1), 10)
        ids = torch.take_along_dim(torch.cat(all_i, 1), pos, 1)
        with declared_sync("search result materialization"):
            ids = ids.to(torch.int32).cpu().numpy()
            dist = dist.cpu().numpy()
        return ids[:, :k], dist[:, :k]


class ShardedDispatch:
    """`SearchHandle` over the per-shard in-flight handles.

    Dispatch already happened (all shards' device work is enqueued);
    `collect()` collects shard by shard, maps local ids into the
    block-encoded global space, and runs the stable `merge_topk` host
    merge.
    """

    __slots__ = ("_handles", "_cap", "_k")

    def __init__(self, handles, cap: int, k: int):
        self._handles = handles
        self._cap = cap
        self._k = k

    def is_ready(self) -> bool:
        return all(h.is_ready() for h in self._handles)

    def collect(self) -> SearchResult:
        gids, dists = [], []
        for s, h in enumerate(self._handles):
            res = h.collect()
            base = np.int64(s) * self._cap
            gids.append(np.where(res.ids >= 0,
                                 res.ids.astype(np.int64) + base, -1))
            dists.append(res.dists)
        return merge_topk(gids, dists, self._k)


class ShardedBackend:
    """P independent LSM-VEC shards behind one `VectorBackend` surface.

    Every shard is a complete `LSMVecIndex` with seed ``seed + s``
    (insert/delete/lazy-delete/consolidate/compact/reorder), on
    ``devices[s % len(devices)]``, by default the one card; the class
    owns only routing and merging:

    - **id space** — block-encoded global ids: shard s's local id l is
      global id ``s * cfg.cap + l``.  With one shard the encoding is
      the identity, so one shard equals a bare `LSMVecIndex`.
    - **routing** — a new vector goes to shard
      ``hash(allocation_seq) % P`` (`shard_of_seq`): deterministic,
      load-balanced, content-independent.  Deletes/reorders route by
      the shard block encoded in the id.
    - **search** — fan out the query batch to every shard; each shard
      computes its local top-k on its device; the host merge
      (`merge_topk`) is a stable P-way merge of the distance-sorted
      rows.
    - **maintenance** — per-shard triggers: `consolidate(ratio=r)`
      consolidates exactly the shards whose own tombstone ratio
      reached r; `reorder` composes per-shard permutations into one
      global permutation for the serving layer's id map.
    """

    def __init__(self, cfg: hnsw.HNSWConfig, n_shards: int, *,
                 devices: Optional[Sequence] = None, seed: int = 0):
        self.cfg = cfg
        self.n_shards = n_shards
        self.seed = seed
        self.devices = _devices(devices, n_shards)
        # shard states are cap-sized: made on first use, so build(),
        # clone() and restore(), which install their own, never pay for
        # throwaway empties
        self._shards: Optional[list] = None
        self._n_routed = 0           # global allocation counter (routing)
        self._alloc: list[int] = []  # global ids in allocation order
        self.consolidations = [0] * n_shards   # per-shard maintenance log
        # overlapped consolidation: per-shard reports already claimed
        # while other shards' repairs are still in flight
        self._claimed: dict = {}

    def _empty_shard(self, s: int) -> LSMVecIndex:
        return LSMVecIndex(self.cfg, seed=self.seed + s,
                           device=self.devices[s])

    @property
    def shards(self) -> list:
        if self._shards is None:
            self._shards = [self._empty_shard(s)
                            for s in range(self.n_shards)]
        return self._shards

    # -- construction ---------------------------------------------------------

    def build(self, vectors: np.ndarray, seed: int = 0) -> "ShardedBackend":
        """Bulk-build the shards from `vectors`, routed like a stream.

        Row j routes to `shard_of_seq(j)` — the same rule later inserts
        follow — so a build is indistinguishable from inserting the
        rows one by one.  `initial_ids()` returns the global id of each
        row in build order for seeding an external-id map.
        """
        n = len(vectors)
        vectors = np.asarray(vectors, np.float32)
        self.seed = seed
        asg = np.asarray(shard_of_seq(np.arange(n), self.n_shards))
        shards = []
        local = np.zeros(n, np.int64)
        for s in range(self.n_shards):
            rows = np.flatnonzero(asg == s)
            local[rows] = np.arange(len(rows))
            shards.append(LSMVecIndex.build(
                self.cfg, vectors[rows], seed=seed + s,
                device=self.devices[s]) if len(rows)
                else self._empty_shard(s))
        self._shards = shards
        self._alloc = (asg.astype(np.int64) * self.cfg.cap + local).tolist()
        self._n_routed = n
        return self

    # -- backend protocol -----------------------------------------------------

    @property
    def cap(self) -> int:
        return self.n_shards * self.cfg.cap

    @property
    def lazy_delete(self) -> bool:
        return self.cfg.lazy_delete

    @property
    def snapshot_stale(self) -> bool:
        return any(sh.snapshot_stale for sh in self.shards)

    def _split(self, gid: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Global id [N] -> (shard [N], local id [N]); -1 passes through."""
        gid = np.asarray(gid, np.int64)
        shard = np.where(gid >= 0, gid // self.cfg.cap, -1)
        local = np.where(gid >= 0, gid % self.cfg.cap, -1)
        return shard, local

    def dispatch_search(self, queries, k: Optional[int] = None, *,
                        params: Optional[SearchParams] = None
                        ) -> ShardedDispatch:
        """Fan-out: every shard's search is started before any result is
        collected.  All per-query knobs forward to the shards unchanged,
        so the merged result at one shard is the bare index's."""
        k = k or self.cfg.k
        handles = [sh.dispatch_search(queries, k=k, params=params)
                   for sh in self.shards]
        return ShardedDispatch(handles, self.cfg.cap, k)

    def search(self, queries, k: Optional[int] = None, *,
               params: Optional[SearchParams] = None) -> SearchResult:
        """Fan-out search: dispatch to every shard, then the stable
        `merge_topk` host merge."""
        return self.dispatch_search(queries, k, params=params).collect()

    def insert_batch(self, xs, *,
                     pad_to: Optional[int] = None) -> UpdateResult:
        """Route each vector by its allocation sequence number, insert
        per shard, and return the global ids in submission order."""
        xs = np.atleast_2d(np.asarray(xs, np.float32))
        if xs.size == 0:
            return UpdateResult(ids=np.zeros((0,), np.int64), n_applied=0)
        n = len(xs)
        asg = np.asarray(shard_of_seq(
            np.arange(self._n_routed, self._n_routed + n), self.n_shards))
        self._n_routed += n
        gids = np.full(n, -1, np.int64)
        for s in range(self.n_shards):
            rows = np.flatnonzero(asg == s)
            if len(rows) == 0:
                continue
            res = self.shards[s].insert_batch(xs[rows], pad_to=pad_to)
            gids[rows] = np.asarray(res.ids, np.int64) \
                + np.int64(s) * self.cfg.cap
        # allocation order = submission order: each shard's sub-batch
        # keeps it
        self._alloc.extend(gids.tolist())
        return UpdateResult(ids=gids, n_applied=n)

    def delete_batch(self, ids, *,
                     pad_to: Optional[int] = None) -> UpdateResult:
        """Route global ids to their owning shard blocks; negative or
        out-of-range ids are masked no-ops (the pad-and-mask serving
        contract) and are excluded from `n_applied`."""
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if len(ids) == 0:
            return UpdateResult(ids=ids, n_applied=0)
        shard, local = self._split(ids)
        routable = (shard >= 0) & (shard < self.n_shards)
        for s in range(self.n_shards):
            sub = local[shard == s]
            if len(sub):
                self.shards[s].delete_batch(sub.astype(np.int32),
                                            pad_to=pad_to)
        return UpdateResult(ids=ids, n_applied=int(routable.sum()))

    def maintain(self, op: str, **params) -> MaintenanceReport:
        """Uniform maintenance over all shards.  Per-shard reports add
        up; for "reorder" the per-shard permutations compose into one
        global permutation."""
        if op == "consolidate":
            # overlapped repairs still in flight are this consolidation:
            # claim them, then run the synchronous trigger on the rest
            pre = self.poll_maintain(block=True)
            total = pre.reclaimed if pre is not None else 0
            total += self.consolidate(ratio=params.get("ratio"))
            return MaintenanceReport(op=op, applied=total > 0,
                                     reclaimed=total)
        if op == "compact":
            self.compact()
            return MaintenanceReport(op=op, applied=True)
        if op == "reorder":
            perm = self.reorder(window=int(params.get("window", 8)),
                                lam=float(params.get("lam", 1.0)))
            return MaintenanceReport(op=op, applied=True, perm=perm)
        if op == "tier":
            moved = self.tier_maintain(params["policy"])
            return MaintenanceReport(
                op=op, applied=(moved["demoted"] + moved["promoted"]) > 0,
                demoted=moved["demoted"], promoted=moved["promoted"])
        raise ValueError(f"unknown maintenance op {op!r}")

    def begin_maintain(self, op: str, **params) -> bool:
        """Start an overlapped consolidation on every shard whose own
        tombstone-ratio trigger passes (on the card, each shard's repair
        on its own side stream, `index._Repair`).  True iff at least one
        shard started."""
        if op != "consolidate":
            return False
        started = False
        for sh in self.shards:
            started |= sh.begin_maintain(op, **params)
        return started

    def poll_maintain(self, *, block: bool = False
                      ) -> Optional[MaintenanceReport]:
        """Claim finished per-shard repairs; once no shard repair is
        left in flight, return the aggregated report (None while any is
        still running, or when nothing was pending at all)."""
        for s, sh in enumerate(self.shards):
            rep = sh.poll_maintain(block=block)
            if rep is not None and rep.applied:
                self.consolidations[s] += 1
                self._claimed[s] = rep
        if any(sh.maintenance_pending for sh in self.shards):
            return None
        if not self._claimed:
            return None
        claimed, self._claimed = self._claimed, {}
        return MaintenanceReport(
            op="consolidate", applied=True,
            reclaimed=sum(r.reclaimed for r in claimed.values()),
            detail={"overlapped": True, "shards": sorted(claimed)})

    @property
    def maintenance_pending(self) -> bool:
        """A repair is in flight or a finished report awaits claim."""
        return bool(self._claimed) or any(sh.maintenance_pending
                                          for sh in self.shards)

    def consolidate(self, *, ratio: Optional[float] = None) -> int:
        """Per-shard trigger rule: each shard consolidates iff its own
        tombstone ratio reached `ratio` (None = every shard with any
        tombstones).  Returns total slots reclaimed."""
        total = 0
        for s, sh in enumerate(self.shards):
            got = sh.consolidate(ratio=ratio)
            if got:
                self.consolidations[s] += 1
            total += got
        return total

    def compact(self) -> None:
        for sh in self.shards:
            sh.compact()

    def reorder(self, *, window: int = 8, lam: float = 1.0) -> np.ndarray:
        """Per-shard relayout composed into one global permutation
        (identity outside the permuted per-shard prefixes), so the
        serving layer folds it into its id map as for one index."""
        perm = np.arange(self.cap, dtype=np.int64)
        for s, sh in enumerate(self.shards):
            ps = np.asarray(sh.reorder(window=window, lam=lam), np.int64)
            base = np.int64(s) * self.cfg.cap
            perm[base:base + len(ps)] = base + ps
        return perm

    def stats(self) -> BackendStats:
        full = [sh.stats() for sh in self.shards]
        per = tuple(f.shards[0] for f in full)
        mem = full[0].memory
        for f in full[1:]:
            mem = mem + f.memory
        return BackendStats(
            size=sum(p.size for p in per),
            n_tombstones=sum(p.n_tombstones for p in per),
            delete_noops=sum(p.delete_noops for p in per),
            max_tombstone_ratio=max(p.tombstone_ratio for p in per),
            shards=per, memory=mem)

    def tier_maintain(self, policy) -> dict:
        """Run the tier policy on every shard (each shard holds its own
        hot budget: heat is shard-local).  Returns total moves."""
        moved = {"demoted": 0, "promoted": 0}
        for sh in self.shards:
            got = sh.tier_maintain(policy)
            for k in moved:
                moved[k] += got[k]
        return moved

    def heat_total(self) -> int:
        return sum(sh.heat_total() for sh in self.shards)

    def reset_heat(self) -> None:
        for sh in self.shards:
            sh.reset_heat()

    def initial_ids(self) -> np.ndarray:
        return np.asarray(self._alloc, np.int64)

    def trace_counts(self) -> dict:
        """Kernel-variant counts summed across shards."""
        out: dict = {}
        for sh in self.shards:
            for key, v in sh.trace_counts().items():
                out[key] = out.get(key, 0) + v
        return out

    def sync(self) -> None:
        for sh in self.shards:
            sh.sync()

    def clone(self) -> "ShardedBackend":
        """Deep-copy shard states into a fresh backend on the same
        devices.  Per-shard generators, routing state and the
        maintenance log carry over."""
        other = ShardedBackend(self.cfg, self.n_shards,
                               devices=self.devices, seed=self.seed)
        other._shards = [sh.clone() for sh in self.shards]
        other._n_routed = self._n_routed
        other._alloc = list(self._alloc)
        other.consolidations = list(self.consolidations)
        return other

    # -- durability -----------------------------------------------------------

    def save(self, ckpt_dir: str, *, lsn: int = 0,
             extra: Optional[dict] = None, meta: Optional[dict] = None,
             keep: int = 3, _pre_publish=None) -> str:
        """Atomic whole-backend checkpoint: per-shard subdirs + a
        shard-layout manifest, staged and renamed as one unit.

        Layout under ``step_<lsn>/``: ``shard_XX/`` (each shard's own
        `LSMVecIndex.save`), ``engine/`` (caller `extra` arrays),
        ``alloc.npz`` (global ids in allocation order) and
        ``layout.json`` recording shard count, routing counter and the
        covering LSN — the reference's layout, so either package
        restores the other's checkpoint.
        """
        self.sync()
        os.makedirs(ckpt_dir, exist_ok=True)
        ckpt.sweep_stale_tmp(ckpt_dir)
        final = os.path.join(ckpt_dir, f"step_{int(lsn):08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp)
        for s, sh in enumerate(self.shards):
            sh.save(os.path.join(tmp, f"shard_{s:02d}"), lsn=lsn, keep=1)
        if extra:
            ckpt.save_checkpoint(
                os.path.join(tmp, "engine"), step=int(lsn),
                tree={k: np.asarray(v) for k, v in extra.items()},
                metadata={}, keep=1)
        layout = {"n_shards": self.n_shards, "cap": self.cfg.cap,
                  "dim": self.cfg.dim, "lsn": int(lsn), "seed": self.seed,
                  "n_routed": self._n_routed,
                  "consolidations": list(self.consolidations),
                  "metadata": meta or {}}
        with open(os.path.join(tmp, "alloc.npz"), "wb") as f:
            np.savez(f, alloc=np.asarray(self._alloc, np.int64))
            f.flush()
            os.fsync(f.fileno())
        with open(os.path.join(tmp, "layout.json"), "w") as f:
            json.dump(layout, f)
            f.flush()
            os.fsync(f.fileno())
        if _pre_publish is not None:
            _pre_publish()
        os.rename(tmp, final)   # atomic publish
        fd = os.open(ckpt_dir, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        steps = sorted(ckpt._list_steps(ckpt_dir))
        for st in steps[:-keep]:
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{st:08d}"),
                          ignore_errors=True)
        return final

    @classmethod
    def restore(cls, cfg: hnsw.HNSWConfig, ckpt_dir: str, *,
                n_shards: Optional[int] = None,
                devices: Optional[Sequence] = None,
                step: Optional[int] = None
                ) -> Tuple["ShardedBackend", dict, dict]:
        """Rebuild the backend from its latest (or `step`-th) checkpoint,
        its shards on `devices` (the card unless told otherwise).

        Refuses a layout mismatch: shard count (if the caller states an
        expectation), cap/dim vs `cfg`, and each shard's covering LSN vs
        the layout's — a torn multi-shard state must never restore.
        Returns (backend, metadata, extras) like `LSMVecIndex.restore`.
        """
        if step is None:
            step = ckpt.latest_step(ckpt_dir)
            if step is None:
                raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
        path = os.path.join(ckpt_dir, f"step_{step:08d}")
        with open(os.path.join(path, "layout.json")) as f:
            layout = json.load(f)
        if n_shards is not None and n_shards != layout["n_shards"]:
            raise ValueError(f"checkpoint has {layout['n_shards']} shards, "
                             f"caller expects {n_shards}")
        if layout["cap"] != cfg.cap or layout["dim"] != cfg.dim:
            raise ValueError(
                f"checkpoint cap/dim ({layout['cap']}/{layout['dim']}) "
                f"!= config ({cfg.cap}/{cfg.dim})")
        be = cls(cfg, layout["n_shards"], devices=devices,
                 seed=int(layout["seed"]))
        shards = []
        for s in range(be.n_shards):
            sh, smd, _ = LSMVecIndex.restore(
                cfg, os.path.join(path, f"shard_{s:02d}"),
                device=be.devices[s])
            if int(smd["lsn"]) != int(layout["lsn"]):
                raise ValueError(f"shard {s} covering lsn {smd['lsn']} != "
                                 f"layout {layout['lsn']} (torn checkpoint)")
            shards.append(sh)
        be._shards = shards
        be._n_routed = int(layout["n_routed"])
        be._alloc = np.load(os.path.join(path, "alloc.npz"))["alloc"].tolist()
        be.consolidations = [int(c) for c in layout["consolidations"]]
        extras = {}
        eng_dir = os.path.join(path, "engine")
        if os.path.isdir(eng_dir):
            extras, _, _ = ckpt.load_arrays(eng_dir)
        metadata = {**layout["metadata"], "lsn": int(layout["lsn"])}
        return be, metadata, extras

    # -- aggregate accounting -------------------------------------------------

    def reset_stats(self) -> None:
        for sh in self.shards:
            sh.reset_stats()

    def io_cost(self, model: iostats.CostModel = iostats.DISK) -> float:
        return sum(sh.io_cost(model) for sh in self.shards)

    def memory_breakdown(self):
        mem = self.shards[0].memory_breakdown()
        for sh in self.shards[1:]:
            mem = mem + sh.memory_breakdown()
        return mem

    def memory_bytes(self) -> int:
        return sum(sh.memory_bytes() for sh in self.shards)

    @property
    def size(self) -> int:
        return sum(sh.size for sh in self.shards)

    @property
    def n_tombstones(self) -> int:
        return sum(sh.n_tombstones for sh in self.shards)
