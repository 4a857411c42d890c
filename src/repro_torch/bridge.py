"""Carry index state across from the reference and back, as numpy.

The reference exports a state with stable string keys — `lsm.dehydrate`
("mem_keys", "level_keys/0", ...; an `HNSWState` flattens the same way,
with its tree under "store/") — and `*_from_numpy` builds the port's
tensors from such a dict.  `*_to_numpy` is the inverse, so a test can
compare the two packages field by field, the tier lanes ("hot",
"qvecs", "qscale", "tier_heat") included.  SimHash words are uint32 in
the reference and int64 here.  A sharded backend crosses shard by shard
(each state under "shard_XX/") with its routing state beside it; the
baselines' state is numpy in both packages and needs no bridge.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import hnsw, lsm
from repro_torch.core.distributed import ShardedBackend
from repro_torch.core.index import LSMVecIndex


def _tensor(a, device, dtype=None) -> torch.Tensor:
    # copy: the reference hands out read-only buffers
    arr = np.array(a, dtype=dtype)
    return torch.from_numpy(arr).to(device)


def lsm_state_from_numpy(d: dict, device=None,
                         prefix: str = "") -> lsm.LSMState:
    """`LSMState` from a flat dict with `lsm.dehydrate` keys."""
    num_levels = sum(1 for k in d if k.startswith(prefix + "level_keys/"))

    def get(name):
        return _tensor(d[prefix + name], device)

    def levels(name):
        return tuple(get(f"{name}/{i}") for i in range(num_levels))

    return lsm.LSMState(
        mem_keys=get("mem_keys"), mem_vals=get("mem_vals"),
        mem_live=get("mem_live"), mem_count=get("mem_count"),
        level_keys=levels("level_keys"), level_vals=levels("level_vals"),
        level_live=levels("level_live"), level_counts=levels("level_counts"),
        write_seq=get("write_seq"), n_flushes=get("n_flushes"),
        n_compactions=get("n_compactions"))


def lsm_state_to_numpy(st: lsm.LSMState, prefix: str = "") -> dict:
    """Flat numpy dict of an `LSMState` with `lsm.dehydrate` keys."""
    out = {}
    for name in st._fields:
        val = getattr(st, name)
        if isinstance(val, tuple):
            for i, t in enumerate(val):
                out[f"{prefix}{name}/{i}"] = t.cpu().numpy()
        else:
            out[prefix + name] = val.cpu().numpy()
    return out


def hnsw_state_from_numpy(d: dict, device=None) -> hnsw.HNSWState:
    """`HNSWState` from a flat dict of the reference's state (tree under
    "store/"); uint32 codes become int64 words."""
    fields = {}
    for name in hnsw.HNSWState._fields:
        if name == "store":
            fields[name] = lsm_state_from_numpy(d, device, prefix="store/")
        elif name == "codes":
            fields[name] = _tensor(d[name], device, np.int64)
        else:
            fields[name] = _tensor(d[name], device)
    return hnsw.HNSWState(**fields)


def hnsw_state_to_numpy(st: hnsw.HNSWState) -> dict:
    """Flat numpy dict of an `HNSWState`, keyed and typed like the
    reference's export (codes back to uint32)."""
    out = {}
    for name in st._fields:
        val = getattr(st, name)
        if name == "store":
            out.update(lsm_state_to_numpy(val, prefix="store/"))
        elif name == "codes":
            out[name] = val.cpu().numpy().astype(np.uint32)
        else:
            out[name] = val.cpu().numpy()
    return out


def sharded_backend_from_numpy(cfg: hnsw.HNSWConfig, d: dict,
                               devices=None) -> ShardedBackend:
    """A `ShardedBackend` from a flat dict: shard s's state under
    "shard_XX/" (keyed as for `hnsw_state_from_numpy`) and the routing
    state: "n_shards", "seed", "n_routed" (the allocation counter),
    "alloc" (global ids in allocation order) and "consolidations" (the
    per-shard log)."""
    n = int(d["n_shards"])
    be = ShardedBackend(cfg, n, devices=devices, seed=int(d["seed"]))
    shards = []
    for s in range(n):
        pre = f"shard_{s:02d}/"
        sub = {k[len(pre):]: v for k, v in d.items() if k.startswith(pre)}
        dev = be.devices[s]
        shards.append(LSMVecIndex(cfg, seed=be.seed + s, device=dev,
                                  state=hnsw_state_from_numpy(sub, dev)))
    be._shards = shards
    be._n_routed = int(d["n_routed"])
    be._alloc = np.asarray(d["alloc"], np.int64).tolist()
    be.consolidations = [int(c) for c in d["consolidations"]]
    return be


def sharded_backend_to_numpy(be: ShardedBackend) -> dict:
    """The inverse of `sharded_backend_from_numpy`."""
    out = {"n_shards": be.n_shards, "seed": be.seed,
           "n_routed": be._n_routed,
           "alloc": np.asarray(be._alloc, np.int64),
           "consolidations": np.asarray(be.consolidations, np.int64)}
    for s, sh in enumerate(be.shards):
        out.update({f"shard_{s:02d}/{k}": v
                    for k, v in hnsw_state_to_numpy(sh.state).items()})
    return out
