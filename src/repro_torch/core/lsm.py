"""A fixed-capacity LSM-tree for graph adjacency storage, on tensors.

The counterpart of `repro.core.lsm`: a log-structured merge tree whose
*values* are fixed-degree adjacency rows of the bottom HNSW layer.  All
state lives in statically shaped tensors on one device; writes are
out-of-place at the level of the tree (a put appends to the memtable, a
flush merges sorted runs), the paper's central storage property (§3.2).

Layout
------
- memtable: unsorted (key, row, live) triples, newest at the highest slot.
- levels 0..L-1: sorted runs of exponentially growing capacity, padded
  with INT32_MAX keys so `searchsorted` lookups stay branch-free.
- tombstones: live == 0 rows; dropped when they reach the last level.

Newest-wins resolution order: memtable (highest slot first) > L0 > L1 > ...

Control flow that the reference runs under `lax.cond` (flush when the
memtable fills, cascade when a level passes 3/4 of its capacity) is
decided here on the host, from one scalar read each.  Functions return a
new `LSMState` and leave the input state's tensors as they were.

Unlike the reference, a config with fanout < 4 is refused: there a merge
of a full level into the next can exceed the next level's capacity, and
the reference drops the overflow without notice.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

PAD_KEY = 2 ** 31 - 1   # sorted-run padding; sorts after any real key
EMPTY = -1              # padding inside adjacency rows
_I32 = torch.int32


class LSMConfig(NamedTuple):
    """Static configuration of the tree. All fields are Python ints."""

    mem_cap: int = 256          # memtable capacity (entries)
    num_levels: int = 4         # number of sorted on-"disk" levels
    fanout: int = 8             # capacity ratio between adjacent levels
    row_width: int = 16         # fixed adjacency-row width (HNSW M)

    @property
    def level_caps(self) -> Tuple[int, ...]:
        return tuple(self.mem_cap * self.fanout ** (i + 1)
                     for i in range(self.num_levels))

    @property
    def total_cap(self) -> int:
        return self.mem_cap + sum(self.level_caps)


class LSMState(NamedTuple):
    """Tensors of the tree. `level_*` are tuples (one entry per level)."""

    mem_keys: torch.Tensor           # int32[mem_cap]
    mem_vals: torch.Tensor           # int32[mem_cap, row_width]
    mem_live: torch.Tensor           # int8[mem_cap]  1=value, 0=tombstone
    mem_count: torch.Tensor          # int32[]
    level_keys: Tuple[torch.Tensor, ...]   # int32[cap_l], sorted, padded
    level_vals: Tuple[torch.Tensor, ...]   # int32[cap_l, row_width]
    level_live: Tuple[torch.Tensor, ...]   # int8[cap_l]
    level_counts: Tuple[torch.Tensor, ...]  # int32[]
    write_seq: torch.Tensor          # int32[] monotone write counter
    n_flushes: torch.Tensor          # int32[]
    n_compactions: torch.Tensor      # int32[]


def check_config(cfg: LSMConfig) -> None:
    """Refuse configs whose merges can overflow a level (fanout < 4)."""
    if cfg.fanout < 4:
        raise ValueError(
            f"LSM fanout {cfg.fanout} < 4: a merge of a level past 3/4 "
            "full into the next can exceed its capacity and drop entries")


def _scalar(v: int, device) -> torch.Tensor:
    return torch.tensor(v, dtype=_I32, device=device)


def init(cfg: LSMConfig, device=None) -> LSMState:
    check_config(cfg)
    lk, lv, ll, lc = [], [], [], []
    for cap in cfg.level_caps:
        lk.append(torch.full((cap,), PAD_KEY, dtype=_I32, device=device))
        lv.append(torch.full((cap, cfg.row_width), EMPTY, dtype=_I32,
                             device=device))
        ll.append(torch.zeros((cap,), dtype=torch.int8, device=device))
        lc.append(_scalar(0, device))
    return LSMState(
        torch.full((cfg.mem_cap,), PAD_KEY, dtype=_I32, device=device),
        torch.full((cfg.mem_cap, cfg.row_width), EMPTY, dtype=_I32,
                   device=device),
        torch.zeros((cfg.mem_cap,), dtype=torch.int8, device=device),
        _scalar(0, device), tuple(lk), tuple(lv), tuple(ll), tuple(lc),
        _scalar(0, device), _scalar(0, device), _scalar(0, device))


# ---------------------------------------------------------------------------
# merge machinery
# ---------------------------------------------------------------------------

def _lexsort(keys: torch.Tensor, prio: torch.Tensor) -> torch.Tensor:
    """Permutation sorting by (keys, prio, position): `jnp.lexsort((prio,
    keys))`, as two stable sorts (minor key first)."""
    o1 = torch.sort(prio, stable=True).indices
    o2 = torch.sort(keys[o1], stable=True).indices
    return o1[o2]


def _drop_dups_and_pad(keys, vals, live, extra_drop=None):
    """Shared tail of a merge: drop repeats of a key (the first, newest
    entry wins) and PAD keys, move survivors to the front in key order,
    and re-pad the keys past the survivor count.  Returns (keys, vals,
    live, count, front); `vals` and `live` of dropped entries stay behind
    the survivors, as the reference leaves them."""
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=keys.device),
                     keys[1:] == keys[:-1]])
    drop = dup | (keys == PAD_KEY)
    if extra_drop is not None:
        drop = drop | extra_drop
    keep_order = torch.sort(drop.to(_I32), stable=True).indices
    keys, vals, live = keys[keep_order], vals[keep_order], live[keep_order]
    count = (~drop).sum().to(_I32)
    front = torch.arange(keys.shape[0], device=keys.device) < count
    return torch.where(front, keys, PAD_KEY), vals, live, count, front


def _merge_runs(keys_new, vals_new, live_new, keys_old, vals_old, live_old,
                out_cap: int, drop_tombstones: bool):
    """Merge two sorted-ish runs; `new` shadows `old` on key collisions.

    Both runs are PAD_KEY-padded.  Output is a PAD_KEY-padded sorted run
    of static size `out_cap`.  Returns (keys, vals, live, count).
    """
    keys = torch.cat([keys_new, keys_old])
    vals = torch.cat([vals_new, vals_old])
    live = torch.cat([live_new, live_old])
    # priority: 0 for the newer run, 1 for the older — newest first in a key
    prio = torch.cat([torch.zeros_like(keys_new), torch.ones_like(keys_old)])
    order = _lexsort(keys, prio)
    keys, vals, live = keys[order], vals[order], live[order]
    keys, vals, live, count, front = _drop_dups_and_pad(
        keys, vals, live, (live == 0) if drop_tombstones else None)
    live = torch.where(front, live, 0).to(torch.int8)
    return keys[:out_cap], vals[:out_cap], live[:out_cap], \
        torch.clamp_max(count, out_cap)


def _sorted_memtable(cfg: LSMConfig, st: LSMState):
    """Sort the memtable into a run; duplicate keys resolved newest-wins."""
    idx = torch.arange(cfg.mem_cap, device=st.mem_keys.device)
    keys = torch.where(idx < st.mem_count, st.mem_keys, PAD_KEY)
    # newer writes sit at higher slots: negative slot puts them first
    order = _lexsort(keys, (-idx).to(_I32))
    keys, vals, live, count, _ = _drop_dups_and_pad(
        keys[order], st.mem_vals[order], st.mem_live[order])
    return keys, vals, live, count


def flush(cfg: LSMConfig, st: LSMState) -> LSMState:
    """Flush memtable into L0, then cascade compactions down the levels."""
    check_config(cfg)
    run_k, run_v, run_l, _ = _sorted_memtable(cfg, st)
    lk = list(st.level_keys)
    lv = list(st.level_vals)
    ll = list(st.level_live)
    lc = list(st.level_counts)

    # memtable -> L0 (leveled compaction: merge directly)
    lk[0], lv[0], ll[0], lc[0] = _merge_runs(
        run_k, run_v, run_l, lk[0], lv[0], ll[0], cfg.level_caps[0],
        drop_tombstones=(cfg.num_levels == 1))

    n_comp = st.n_compactions
    # cascade: a level past 3/4 of its capacity merges into the next
    for i in range(cfg.num_levels - 1):
        thresh = int(cfg.level_caps[i] * 0.75)
        if int(lc[i]) <= thresh:
            continue
        last = (i + 1 == cfg.num_levels - 1)
        lk[i + 1], lv[i + 1], ll[i + 1], lc[i + 1] = _merge_runs(
            lk[i], lv[i], ll[i], lk[i + 1], lv[i + 1], ll[i + 1],
            cfg.level_caps[i + 1], drop_tombstones=last)
        lk[i] = torch.full_like(lk[i], PAD_KEY)
        lv[i] = torch.full_like(lv[i], EMPTY)
        ll[i] = torch.zeros_like(ll[i])
        lc[i] = torch.zeros_like(lc[i])
        n_comp = n_comp + 1

    return st._replace(
        mem_keys=torch.full_like(st.mem_keys, PAD_KEY),
        mem_vals=torch.full_like(st.mem_vals, EMPTY),
        mem_live=torch.zeros_like(st.mem_live),
        mem_count=torch.zeros_like(st.mem_count),
        level_keys=tuple(lk), level_vals=tuple(lv),
        level_live=tuple(ll), level_counts=tuple(lc),
        n_flushes=st.n_flushes + 1, n_compactions=n_comp)


# ---------------------------------------------------------------------------
# point operations
# ---------------------------------------------------------------------------

def _raw_put(cfg: LSMConfig, st: LSMState, key, val, live: int) -> LSMState:
    slot = int(st.mem_count)
    mem_keys = st.mem_keys.clone()
    mem_vals = st.mem_vals.clone()
    mem_live = st.mem_live.clone()
    mem_keys[slot] = key
    mem_vals[slot] = val
    mem_live[slot] = live
    st = st._replace(mem_keys=mem_keys, mem_vals=mem_vals,
                     mem_live=mem_live, mem_count=st.mem_count + 1,
                     write_seq=st.write_seq + 1)
    return flush(cfg, st) if slot + 1 >= cfg.mem_cap else st


def put(cfg: LSMConfig, st: LSMState, key, val) -> LSMState:
    """Insert/overwrite `key` with adjacency row `val` (out-of-place)."""
    return _raw_put(cfg, st, key, val, 1)


def delete(cfg: LSMConfig, st: LSMState, key) -> LSMState:
    """Write a tombstone for `key`."""
    return _raw_put(cfg, st, key, EMPTY, 0)


def get_batch(cfg: LSMConfig, st: LSMState, keys: torch.Tensor):
    """Newest-wins lookup of a key vector.

    Returns (found: bool[n], value: int32[n, row_width], n_probes:
    int32[n]).  `found` is False for missing keys *and* tombstoned keys.
    `n_probes` models the paper's t_n unit: ONE disk read per lookup (a
    graph-LSM consults in-memory bloom filters per run, so only the
    resolving tier touches disk).
    """
    keys = keys.to(_I32)
    idx = torch.arange(cfg.mem_cap, device=keys.device)
    match = (st.mem_keys[None, :] == keys[:, None]) \
        & (idx < st.mem_count)[None, :]                     # [n, mem_cap]
    any_mem = match.any(1)
    newest = torch.where(match, idx, -1).argmax(1)
    found = any_mem
    alive = any_mem & (st.mem_live[newest] > 0)
    val = torch.where(any_mem[:, None], st.mem_vals[newest], EMPTY)

    for lvl in range(cfg.num_levels):
        lkeys = st.level_keys[lvl]
        pos = torch.searchsorted(lkeys, keys)
        pos_c = torch.clamp_max(pos, lkeys.shape[0] - 1)
        hit = lkeys[pos_c] == keys
        take = (~found) & hit
        val = torch.where(take[:, None], st.level_vals[lvl][pos_c], val)
        alive = torch.where(take, st.level_live[lvl][pos_c] > 0, alive)
        found = found | hit

    probes = torch.ones(keys.shape, dtype=_I32, device=keys.device)
    return found & alive, val, probes


def get(cfg: LSMConfig, st: LSMState, key):
    """Newest-wins point lookup: (found bool[], value int32[M], probes)."""
    keys = torch.as_tensor(key, dtype=_I32,
                           device=st.mem_keys.device).reshape(1)
    found, val, probes = get_batch(cfg, st, keys)
    return found[0], val[0], probes[0]


def _append_run(cfg: LSMConfig, st: LSMState, keys, vals, lives) -> LSMState:
    """Append one batch (size <= mem_cap) to the memtable in one scatter,
    flushing around it as needed."""
    b = keys.shape[0]
    count = int(st.mem_count)
    # pre-flush so the whole batch fits ...
    if count + b > cfg.mem_cap:
        st = flush(cfg, st)
        count = 0
    mem_keys = st.mem_keys.clone()
    mem_vals = st.mem_vals.clone()
    mem_live = st.mem_live.clone()
    mem_keys[count:count + b] = keys
    mem_vals[count:count + b] = vals
    mem_live[count:count + b] = lives
    st = st._replace(mem_keys=mem_keys, mem_vals=mem_vals,
                     mem_live=mem_live, mem_count=st.mem_count + b,
                     write_seq=st.write_seq + b)
    # ... post-flush to restore the `mem_count < mem_cap` rest invariant
    # that point puts rely on for their append slot
    return flush(cfg, st) if count + b >= cfg.mem_cap else st


def puts(cfg: LSMConfig, st: LSMState, keys, vals, lives=None) -> LSMState:
    """Bulk put: one memtable append per mem_cap-sized chunk.

    Equivalent to sequential `put` calls — newest-wins is by slot order,
    so duplicate keys within the batch resolve to the later entry — but
    the tree flushes *before* a chunk that would overflow rather than
    exactly at the high-water mark.  `lives` (int8, default all-1) writes
    tombstones where 0, making this the bulk form of `delete` too.
    """
    device = st.mem_keys.device
    keys = torch.as_tensor(keys, device=device).to(_I32)
    vals = torch.as_tensor(vals, device=device).to(_I32)
    if lives is None:
        lives = torch.ones(keys.shape, dtype=torch.int8, device=device)
    else:
        lives = torch.as_tensor(lives, device=device).to(torch.int8)
    for s in range(0, keys.shape[0], cfg.mem_cap):
        st = _append_run(cfg, st, keys[s:s + cfg.mem_cap],
                         vals[s:s + cfg.mem_cap], lives[s:s + cfg.mem_cap])
    return st


# ---------------------------------------------------------------------------
# maintenance / introspection
# ---------------------------------------------------------------------------

def _with_last_level(st: LSMState, lk, lv, ll, count) -> LSMState:
    return st._replace(level_keys=st.level_keys[:-1] + (lk,),
                       level_vals=st.level_vals[:-1] + (lv,),
                       level_live=st.level_live[:-1] + (ll,),
                       level_counts=st.level_counts[:-1] + (count,))


def bulk_load(cfg: LSMConfig, keys: torch.Tensor, vals: torch.Tensor
              ) -> LSMState:
    """Build a tree whose last level holds `keys`/`vals` directly (sorted):
    the offline "write one big sorted run" path of the initial build."""
    device = keys.device
    st = init(cfg, device)
    cap = cfg.level_caps[-1]
    n = keys.shape[0]
    if n > cap:
        raise ValueError(f"bulk_load of {n} rows exceeds last-level cap {cap}")
    order = torch.sort(keys.to(_I32), stable=True).indices
    lk = torch.full((cap,), PAD_KEY, dtype=_I32, device=device)
    lv = torch.full((cap, cfg.row_width), EMPTY, dtype=_I32, device=device)
    ll = torch.zeros((cap,), dtype=torch.int8, device=device)
    lk[:n] = keys.to(_I32)[order]
    lv[:n] = vals.to(_I32)[order]
    ll[:n] = 1
    return _with_last_level(st, lk, lv, ll, _scalar(n, device))


def rebuild_from_dense(cfg: LSMConfig, st: LSMState, keep: torch.Tensor,
                       rows: torch.Tensor) -> LSMState:
    """Rewrite the whole tree from a dense view in one pass.

    `keep` (bool[id_space]) selects which ids survive; `rows` carries
    their final adjacency.  The result is a fresh tree whose last level
    holds exactly the kept rows (sorted, tombstone-free) — a major
    compaction that also drops the reclaimed ids.  Requires id_space <=
    last-level capacity.  Write/flush counters carry forward; the rewrite
    counts as one compaction.
    """
    id_space = keep.shape[0]
    cap = cfg.level_caps[-1]
    if id_space > cap:
        raise ValueError(
            f"rebuild_from_dense of {id_space} ids exceeds last-level "
            f"cap {cap}")
    device = keep.device
    keep = keep.to(torch.bool)
    ids = torch.arange(id_space, dtype=_I32, device=device)
    keys = torch.where(keep, ids, PAD_KEY)
    order = torch.sort(keys, stable=True).indices
    n_keep = keep.sum().to(_I32)
    lk = torch.full((cap,), PAD_KEY, dtype=_I32, device=device)
    lv = torch.full((cap, cfg.row_width), EMPTY, dtype=_I32, device=device)
    ll = torch.zeros((cap,), dtype=torch.int8, device=device)
    lk[:id_space] = keys[order]
    lv[:id_space] = rows.to(_I32)[order]
    ll[:id_space] = keep[order].to(torch.int8)
    fresh = _with_last_level(init(cfg, device), lk, lv, ll, n_keep)
    return fresh._replace(write_seq=st.write_seq + n_keep,
                          n_flushes=st.n_flushes.clone(),
                          n_compactions=st.n_compactions + 1)


def compact_all(cfg: LSMConfig, st: LSMState) -> LSMState:
    """Force-merge everything into the last level (major compaction):
    flush the memtable, then merge each level into the next, dropping
    tombstones at the last."""
    st = flush(cfg, st)
    lk = list(st.level_keys)
    lv = list(st.level_vals)
    ll = list(st.level_live)
    lc = list(st.level_counts)
    for i in range(cfg.num_levels - 1):
        last = (i + 1 == cfg.num_levels - 1)
        lk[i + 1], lv[i + 1], ll[i + 1], lc[i + 1] = _merge_runs(
            lk[i], lv[i], ll[i], lk[i + 1], lv[i + 1], ll[i + 1],
            cfg.level_caps[i + 1], drop_tombstones=last)
        lk[i] = torch.full_like(lk[i], PAD_KEY)
        lv[i] = torch.full_like(lv[i], EMPTY)
        ll[i] = torch.zeros_like(ll[i])
        lc[i] = torch.zeros_like(lc[i])
    return st._replace(level_keys=tuple(lk), level_vals=tuple(lv),
                       level_live=tuple(ll), level_counts=tuple(lc),
                       n_compactions=st.n_compactions + 1)


def remap_ids(cfg: LSMConfig, st: LSMState, perm_map) -> LSMState:
    """Rename node ids everywhere: key k -> perm_map[k], and the same for
    row entries (EMPTY entries stay).  Runs a major compaction first, so
    only the last level needs remapping (connectivity-aware reordering,
    §3.4, relabels nodes at compaction).

    Ids past the end of `perm_map` read its last entry, as the
    reference's clamped gather does: the dead key `cap` that batched
    updates write to becomes `cap - 1`."""
    st = compact_all(cfg, st)
    device = st.mem_keys.device
    perm_map = torch.as_tensor(perm_map, device=device).to(_I32)
    top = perm_map.shape[0] - 1
    keys = st.level_keys[-1]
    vals = st.level_vals[-1]
    is_real = keys != PAD_KEY
    safe_keys = torch.where(is_real, keys, 0).clamp_max(top).long()
    new_keys = torch.where(is_real, perm_map[safe_keys], PAD_KEY)
    safe_vals = torch.where(vals >= 0, vals, 0).clamp_max(top).long()
    new_vals = torch.where(vals >= 0, perm_map[safe_vals], vals)
    order = torch.sort(new_keys, stable=True).indices
    return _with_last_level(st, new_keys[order], new_vals[order],
                            st.level_live[-1][order], st.level_counts[-1])


def resolve_all(cfg: LSMConfig, st: LSMState, id_space: int):
    """Dense newest-wins view: (live int8[id_space], rows int32[id_space, M]).

    The snapshot-resolve primitive: the read path and the batched update
    pipelines materialize the whole tree into this view once per write
    epoch, then serve adjacency by row gather.  Cost O(id_space +
    total_cap).
    """
    device = st.mem_keys.device
    # spare slot at id_space absorbs padding/out-of-range writes
    live = torch.zeros((id_space + 1,), dtype=torch.int8, device=device)
    rows = torch.full((id_space + 1, cfg.row_width), EMPTY, dtype=_I32,
                      device=device)
    runs = [(st.level_keys[lvl], st.level_live[lvl], st.level_vals[lvl])
            for lvl in range(cfg.num_levels - 1, -1, -1)]
    run_k, run_v, run_l, _ = _sorted_memtable(cfg, st)
    runs.append((run_k, run_l, run_v))
    # oldest level first, newest memtable last — later writes overwrite;
    # within a run real keys are distinct, so only the spare slot ever
    # sees repeated writes
    for keys, lives, vals in runs:
        ok = (keys != PAD_KEY) & (keys < id_space)
        safe = torch.where(ok, keys, id_space).long()
        live[safe] = lives.to(torch.int8)
        rows[safe] = vals
    return live[:id_space], rows[:id_space]


def snapshot_rows(cfg: LSMConfig, st: LSMState, id_space: int
                  ) -> torch.Tensor:
    """Resolve the tree into dense adjacency rows int32[id_space, M].

    Rows of absent/tombstoned keys come back all -1 — the `found &
    alive`-masked contract of `get`, so a gather from this view is
    interchangeable with per-hop lookups against the frozen tree.
    """
    live, rows = resolve_all(cfg, st, id_space)
    return torch.where(live[:, None] > 0, rows, EMPTY)


def memory_bytes(cfg: LSMConfig) -> int:
    """Bytes the *memory-resident* part occupies (memtable only)."""
    return cfg.mem_cap * (4 + 4 * cfg.row_width + 1) + 64


def disk_bytes(cfg: LSMConfig) -> int:
    """Bytes the on-"disk" levels occupy at full capacity."""
    return sum(c * (4 + 4 * cfg.row_width + 1) for c in cfg.level_caps)


# ---------------------------------------------------------------------------
# durable state (de)hydration
# ---------------------------------------------------------------------------

def dehydrate(state, prefix: str = ""):
    """Flatten a state NamedTuple into ``{path: tensor}`` with explicit,
    stable string keys ("mem_keys", "level_keys/0", ...).

    Nested NamedTuples and tuples of tensors flatten through the same
    walk, so an `HNSWState` (its tree under "store") does too.  The keys
    are the checkpoint manifest's schema and the reference's, letter for
    letter: they must stay stable for old checkpoints to restore.
    """
    out = {}

    def walk(node, path):
        if hasattr(node, "_fields"):
            for name in node._fields:
                walk(getattr(node, name), f"{path}/{name}" if path else name)
        elif isinstance(node, (tuple, list)):
            for i, item in enumerate(node):
                walk(item, f"{path}/{i}" if path else str(i))
        else:
            out[path] = node

    walk(state, prefix.rstrip("/"))
    return out


def hydrate(template, leaves, prefix: str = ""):
    """Inverse of :func:`dehydrate`: rebuild `template`'s structure from
    a flat ``{path: tensor}`` dict.  `template` supplies structure only;
    every leaf comes from `leaves`.  Raises KeyError if a path the
    structure requires is missing."""

    def walk(node, path):
        if hasattr(node, "_fields"):
            vals = (walk(getattr(node, n), f"{path}/{n}" if path else n)
                    for n in node._fields)
            return type(node)(*vals)
        if isinstance(node, (tuple, list)):
            return tuple(walk(item, f"{path}/{i}" if path else str(i))
                         for i, item in enumerate(node))
        return leaves[path]

    return walk(template, prefix.rstrip("/"))
