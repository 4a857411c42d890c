"""The port's LSM tree against the reference and a dict model.

After identical op sequences (point puts and deletes, bulk puts with
tombstones, flushes with cascading compactions) every `LSMState` field
is bitwise equal to the reference's, and every lookup agrees with a
plain dict.  Unlike the reference, the port refuses fanout < 4, where a
merge can overflow a level (ROADMAP fault R1).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hnsw as jax_hnsw
from repro.core import lsm as ref
from repro_torch.bridge import lsm_state_to_numpy
from repro_torch.core import hnsw, lsm

torch.set_num_threads(1)

SMALL = lsm.LSMConfig(mem_cap=8, num_levels=3, fanout=8, row_width=4)
# the tree an HNSW index of cap 1024 uses (fanout grown to cover cap)
FROM_HNSW = hnsw.HNSWConfig(cap=1024, dim=16, M=8, lsm_mem_cap=64,
                            lsm_levels=2).lsm_cfg
PUTS_B = 11   # one bulk-put width, so each jitted reference op compiles once


def _ref_cfg(cfg):
    return ref.LSMConfig(*cfg)


def assert_same_state(port_st, ref_st):
    want = {k: np.asarray(v) for k, v in ref.dehydrate(ref_st).items()}
    got = lsm_state_to_numpy(port_st)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.fixture(scope="module", params=[SMALL, FROM_HNSW],
                ids=["small", "from_hnsw"])
def ref_ops(request):
    cfg = request.param
    rc = _ref_cfg(cfg)
    id_space = 7 * cfg.mem_cap + 20
    return cfg, id_space, dict(
        put=jax.jit(lambda st, k, v: ref.put(rc, st, k, v)),
        delete=jax.jit(lambda st, k: ref.delete(rc, st, k)),
        puts=jax.jit(lambda st, k, v, lv: ref.puts(rc, st, k, v, lv)),
        flush=jax.jit(lambda st: ref.flush(rc, st)),
        get=jax.jit(lambda st, ks: ref.get_batch(rc, st, ks)),
        resolve=jax.jit(lambda st: ref.resolve_all(rc, st, id_space)),
        snapshot=jax.jit(lambda st: ref.snapshot_rows(rc, st, id_space)))


def test_op_sequence_matches_reference_and_dict(ref_ops):
    cfg, id_space, J = ref_ops
    rng = np.random.default_rng(cfg.mem_cap)
    st_t = lsm.init(cfg)
    st_j = ref.init(_ref_cfg(cfg))
    model = {}
    n_ops = 40 * cfg.mem_cap // PUTS_B + 30
    for _ in range(n_ops):
        op = rng.choice(["put", "delete", "puts", "flush"],
                        p=[0.3, 0.15, 0.5, 0.05])
        if op == "put":
            key = int(rng.integers(0, id_space))
            val = rng.integers(-1, id_space, cfg.row_width).astype(np.int32)
            st_t = lsm.put(cfg, st_t, key, torch.from_numpy(val))
            st_j = J["put"](st_j, key, jnp.asarray(val))
            model[key] = val
        elif op == "delete":
            key = int(rng.integers(0, id_space))
            st_t = lsm.delete(cfg, st_t, key)
            st_j = J["delete"](st_j, key)
            model.pop(key, None)
        elif op == "puts":
            keys = rng.integers(0, id_space, PUTS_B).astype(np.int32)
            vals = rng.integers(-1, id_space,
                                (PUTS_B, cfg.row_width)).astype(np.int32)
            lives = (rng.random(PUTS_B) > 0.2).astype(np.int8)
            st_t = lsm.puts(cfg, st_t, torch.from_numpy(keys),
                            torch.from_numpy(vals), torch.from_numpy(lives))
            st_j = J["puts"](st_j, jnp.asarray(keys), jnp.asarray(vals),
                             jnp.asarray(lives))
            for k_, v_, l_ in zip(keys.tolist(), vals, lives.tolist()):
                if l_:
                    model[k_] = v_
                else:
                    model.pop(k_, None)
        else:
            st_t = lsm.flush(cfg, st_t)
            st_j = J["flush"](st_j)
        assert_same_state(st_t, st_j)

    assert int(st_t.n_compactions) > 0, "sequence never cascaded"
    keys = np.arange(-1, id_space + 1, dtype=np.int32)
    found, vals, probes = lsm.get_batch(cfg, st_t, torch.from_numpy(keys))
    fj, vj, pj = J["get"](st_j, jnp.asarray(keys))
    np.testing.assert_array_equal(found.numpy(), np.asarray(fj))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(probes.numpy(), np.asarray(pj))
    for key, f, v in zip(keys.tolist(), found.numpy(), vals.numpy()):
        assert f == (key in model), key
        if f:
            np.testing.assert_array_equal(v, model[key])
        one = lsm.get(cfg, st_t, key)
        assert bool(one[0]) == f

    live, rows = lsm.resolve_all(cfg, st_t, id_space)
    lj, rj = J["resolve"](st_j)
    np.testing.assert_array_equal(live.numpy(), np.asarray(lj))
    np.testing.assert_array_equal(rows.numpy(), np.asarray(rj))
    snap = lsm.snapshot_rows(cfg, st_t, id_space).numpy()
    np.testing.assert_array_equal(snap, np.asarray(J["snapshot"](st_j)))
    for key in range(id_space):
        want = model.get(key, np.full(cfg.row_width, -1, np.int32))
        np.testing.assert_array_equal(snap[key], want)


def test_bulk_load_and_rebuild_from_dense_match():
    cfg = FROM_HNSW
    rc = _ref_cfg(cfg)
    assert rc == jax_hnsw.HNSWConfig(cap=1024, dim=16, M=8, lsm_mem_cap=64,
                                     lsm_levels=2).lsm_cfg
    rng = np.random.default_rng(1)
    n = 300
    keys = rng.permutation(n).astype(np.int32)
    vals = rng.integers(-1, n, (n, cfg.row_width)).astype(np.int32)
    st_t = lsm.bulk_load(cfg, torch.from_numpy(keys), torch.from_numpy(vals))
    st_j = ref.bulk_load(rc, jnp.asarray(keys), jnp.asarray(vals))
    assert_same_state(st_t, st_j)
    st_t = lsm.puts(cfg, st_t, torch.from_numpy(keys[:70]),
                    torch.from_numpy(vals[::-1][:70].copy()))
    st_j = ref.puts(rc, st_j, jnp.asarray(keys[:70]),
                    jnp.asarray(vals[::-1][:70].copy()))
    keep = rng.random(cfg.mem_cap * 5) > 0.3
    rows = rng.integers(-1, n, (keep.size, cfg.row_width)).astype(np.int32)
    st_t = lsm.rebuild_from_dense(cfg, st_t, torch.from_numpy(keep),
                                  torch.from_numpy(rows))
    st_j = ref.rebuild_from_dense(rc, st_j, jnp.asarray(keep),
                                  jnp.asarray(rows))
    assert_same_state(st_t, st_j)
    assert lsm.memory_bytes(cfg) == ref.memory_bytes(rc)
    assert lsm.disk_bytes(cfg) == ref.disk_bytes(rc)


@pytest.mark.parametrize("fanout", [2, 3])
def test_fanout_below_four_is_refused(fanout):
    cfg = lsm.LSMConfig(mem_cap=4, num_levels=3, fanout=fanout, row_width=2)
    with pytest.raises(ValueError, match="fanout"):
        lsm.init(cfg)
    with pytest.raises(ValueError, match="fanout"):
        lsm.flush(cfg, lsm.init(cfg._replace(fanout=4)))
