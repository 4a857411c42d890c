"""Shared set-up of the port's serving tests (`tests/test_torch_serve*.py`,
`test_torch_sentinel.py`, `test_torch_durability.py`).

One small configuration (cap 1,024, d = 16, as `test_transfer_guard.py`
uses), integer-valued vectors so both packages are bitwise, and a pair
of indexes at the same built state: the reference's, and the port's on
the CPU carried across by the bridge and handed the reference's level
draws, so that both engines see the same graph at every step.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.core import hnsw as jax_hnsw
from repro.core import index as ref_index
from repro.core import iostats as ref_iostats
from repro.core import lsm as ref_lsm
from repro_torch.bridge import hnsw_state_from_numpy, hnsw_state_to_numpy
from repro_torch.core import hnsw
from repro_torch.core.index import LSMVecIndex

JCFG = jax_hnsw.HNSWConfig(cap=1024, dim=16, M=8, M_up=4, num_upper=2,
                           ef_search=32, ef_construction=32, k=5,
                           rho=1.0, use_filter=False, lsm_mem_cap=128,
                           lsm_levels=2, lsm_fanout=8, batch_expand=4)
N_BASE = 160         # past BATCH_MIN_GRAPH with room for the deletes
W = 8                # every op's batch cap and pad width


def tcfg(jcfg):
    """The port's config with the reference config's fields."""
    return hnsw.HNSWConfig(**{f: getattr(jcfg, f)
                              for f in hnsw.HNSWConfig._fields})


def ints(rng, shape):
    return rng.integers(-3, 4, shape).astype(np.float32)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class RefDraws:
    """The level uniforms the reference index draws for each padded
    `insert_batch` chunk, from a copy of its key chain: installed as the
    port index's `_uniforms`, it hands the port the same levels."""

    def __init__(self, key):
        self.key = key

    def __call__(self, n):
        self.key, sub = jax.random.split(self.key)
        keys = jax.random.split(sub, n)
        u = jax.vmap(lambda kk: jax.random.uniform(
            kk, (), jnp.float32, 1e-7, 1.0))(keys)
        return torch.from_numpy(np.array(u))


def np_state(jidx):
    return {k: np.asarray(v)
            for k, v in ref_lsm.dehydrate(jidx.state).items()}


@functools.lru_cache(maxsize=None)
def built(jcfg=JCFG, seed=7):
    """(reference index, its numpy state, a copy of its state) built over
    integer rows, once per configuration in a process: `pair` reuses the
    index, so its jitted functions compile once."""
    base = ints(np.random.default_rng(seed), (N_BASE, jcfg.dim))
    jidx = ref_index.LSMVecIndex.build(jcfg, base, seed=0)
    return jidx, np_state(jidx), jax.tree.map(jnp.copy, jidx.state)


def pair(jcfg, jidx, state, jstate):
    """A (reference, port) index pair at the built state.  The reference
    index is `jidx` itself, put back to that state: its jitted functions
    belong to the instance, so reusing it compiles each of them once."""
    jidx.state = jax.tree.map(jnp.copy, jstate)
    jidx._rng = jax.random.key(1)
    jidx._count = N_BASE
    jidx._version = 0
    jidx._snap, jidx._snap_version = None, -1
    jidx.snap_patches = 0
    jidx._pending_repair = jidx._done_report = None
    jidx.io_stats = ref_iostats.IOStats.zero()
    tidx = LSMVecIndex(tcfg(jcfg), state=hnsw_state_from_numpy(state, "cpu"),
                       device="cpu")
    tidx._uniforms = RefDraws(jidx._rng)
    return jidx, tidx


def assert_same_state(tidx, jidx):
    got = hnsw_state_to_numpy(tidx.state)
    want = np_state(jidx)
    assert got.keys() == want.keys()
    for k, v in got.items():
        np.testing.assert_array_equal(v, want[k], err_msg=k)
    assert tidx._count == jidx._count


def mixed_stream(rng, n_ops, n_base, dim):
    """Chunks of (kind, payload) ops, 60 % queries of integer rows, 25 %
    inserts of fresh ones, 15 % deletes of external ids that are live
    when the chunk starts (acked in an earlier chunk, never deleted
    twice)."""
    live = list(range(n_base))
    next_ext = n_base
    chunks, cur = [], []
    for i in range(n_ops):
        r = rng.random()
        if r < 0.6:
            cur.append(("query", ints(rng, (dim,))))
        elif r < 0.85:
            cur.append(("insert", ints(rng, (dim,))))
        else:
            cur.append(("delete", live.pop(int(rng.integers(0, len(live))))))
        if len(cur) == 24 or i == n_ops - 1:
            # inserts of this chunk become deletable in the next one
            n_ins = sum(1 for k, _ in cur if k == "insert")
            live.extend(range(next_ext, next_ext + n_ins))
            next_ext += n_ins
            chunks.append(cur)
            cur = []
    return chunks


def submit(eng, kind, payload):
    if kind == "query":
        return eng.submit_query(payload)
    if kind == "insert":
        return eng.submit_insert(payload)
    return eng.submit_delete(payload)
