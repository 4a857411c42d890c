"""The slice as a whole through the functional API: bulk_build ->
search -> insert_batch -> delete_batch -> consolidate, port against
reference.

Integer-valued vectors make every distance an exact integer in f32,
so the port must reproduce the reference's decisions exactly: the
SimHash projections and level uniforms are the reference's draws,
injected.  After each step every state field is bitwise equal (the
mean norm, a float sum, allclose), and so are the search ids, dists
and IOStats on both read routes (LSM probes and the snapshot).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hnsw as ref
from repro.core import lsm as ref_lsm
from repro_torch.bridge import (
    hnsw_state_from_numpy,
    hnsw_state_to_numpy,
    lsm_state_to_numpy,
)
from repro_torch.core import hnsw, lsm

torch.set_num_threads(1)

JCFG = ref.HNSWConfig(cap=512, dim=16, M=8, M_up=4, num_upper=2,
                      ef_search=16, ef_construction=16, k=5, lsm_mem_cap=64,
                      lsm_levels=2, lsm_fanout=8)
TCFG = hnsw.HNSWConfig(**{f: getattr(JCFG, f)
                          for f in hnsw.HNSWConfig._fields})
N_BASE, N_INS, N_PAD, N_Q = 200, 40, 4, 12


def _ints(rng, shape):
    return rng.integers(-4, 5, shape).astype(np.float32)


def _np_state(st):
    return {k: np.asarray(v) for k, v in ref_lsm.dehydrate(st).items()}


def assert_same_state(port_st, ref_np):
    got = hnsw_state_to_numpy(port_st)
    for k, v in got.items():
        want = ref_np[k]
        assert v.dtype == want.dtype and v.shape == want.shape, k
        if k == "mean_norm":     # a float sum: order differs
            np.testing.assert_allclose(v, want, rtol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(v, want, err_msg=k)


@pytest.fixture(scope="module")
def ref_run():
    """The reference's run of the slice, exported as numpy."""
    rng = np.random.default_rng(5)
    base = _ints(rng, (N_BASE, JCFG.dim))
    xs = np.zeros((N_INS + N_PAD, JCFG.dim), np.float32)
    xs[:N_INS] = _ints(rng, (N_INS, JCFG.dim))
    valid = np.arange(N_INS + N_PAD) < N_INS
    qs = _ints(rng, (N_Q, JCFG.dim))
    dels = np.concatenate([rng.choice(N_BASE + N_INS, 20, replace=False),
                           [3, 3, -1, N_BASE + N_INS + 7]]).astype(np.int32)

    key = jax.random.key(0)
    k_init, k_lvl = jax.random.split(key)
    u01_build = jax.random.uniform(k_lvl, (N_BASE,), jnp.float32, 1e-7, 1.0)
    ins_keys = jax.random.split(jax.random.key(1), N_INS + N_PAD)
    u01_ins = jax.vmap(lambda kk: jax.random.uniform(
        kk, (), jnp.float32, 1e-7, 1.0))(ins_keys)

    search = jax.jit(lambda st, q: ref.search_batch(JCFG, st, q))
    search_snap = jax.jit(lambda st, q, snap: ref.search_batch(
        JCFG, st, q, snapshot=snap))
    resolve = jax.jit(lambda st: ref_lsm.snapshot_rows(
        JCFG.lsm_cfg, st.store, JCFG.cap))
    insert_batch = jax.jit(lambda st, x, k, v: ref.insert_batch(
        JCFG, st, x, k, valid=v))
    consolidate = jax.jit(lambda st: ref.consolidate(JCFG, st))

    out = dict(base=base, xs=xs, valid=valid, qs=qs, dels=dels,
               proj=np.array(ref.init(JCFG, k_init).proj),
               u01_build=np.array(u01_build), u01_ins=np.array(u01_ins),
               steps=[])

    def record(name, st, io=None):
        res = jax.tree.map(np.asarray, search(st, jnp.asarray(qs)))
        res_snap = jax.tree.map(np.asarray, search_snap(
            st, jnp.asarray(qs), resolve(st)))
        out["steps"].append((name, _np_state(st), res, res_snap,
                             None if io is None else
                             jax.tree.map(np.asarray, io)))

    st = ref.bulk_build(JCFG, jnp.asarray(base), key)
    record("bulk_build", st)
    st, io = insert_batch(st, jnp.asarray(xs), ins_keys, jnp.asarray(valid))
    record("insert_batch", st, io)
    st, io = ref.delete_batch(JCFG, st, jnp.asarray(dels))
    record("delete_batch", st, io)
    st, io = consolidate(st)
    record("consolidate", st, io)
    out["single"] = jax.tree.map(np.asarray, jax.jit(
        lambda st, q: ref.search(JCFG, st, q))(st, jnp.asarray(qs[1])))
    return out


def _check_search(cfg, st, want, want_snap, qs):
    snap = lsm.snapshot_rows(cfg.lsm_cfg, st.store, cfg.cap)
    for res, ref_res in ((hnsw.search_batch(cfg, st, qs), want),
                         (hnsw.search_batch(cfg, st, qs, snapshot=snap),
                          want_snap)):
        np.testing.assert_array_equal(res.ids.numpy(), ref_res.ids)
        np.testing.assert_array_equal(res.dists.numpy(), ref_res.dists)
        for a, b in zip(res.stats, ref_res.stats):
            np.testing.assert_array_equal(a.numpy(), b)
        np.testing.assert_array_equal(res.heat_nodes.numpy(),
                                      ref_res.heat_nodes)
        np.testing.assert_array_equal(res.heat_mask.numpy(),
                                      ref_res.heat_mask)


def test_slice_matches_reference_step_by_step(ref_run):
    r = ref_run
    qs = torch.from_numpy(r["qs"])
    st = hnsw.bulk_build(TCFG, torch.from_numpy(r["base"]),
                         torch.from_numpy(r["proj"]),
                         torch.from_numpy(r["u01_build"]), device="cpu")
    steps = iter(r["steps"])

    name, ref_np, want, want_snap, _ = next(steps)
    assert_same_state(st, ref_np)
    _check_search(TCFG, st, want, want_snap, qs)

    st, io = hnsw.insert_batch(TCFG, st, torch.from_numpy(r["xs"]),
                               torch.from_numpy(r["u01_ins"]),
                               valid=torch.from_numpy(r["valid"]))
    name, ref_np, want, want_snap, ref_io = next(steps)
    assert_same_state(st, ref_np)
    assert [int(a) for a in io] == [int(a) for a in ref_io]
    _check_search(TCFG, st, want, want_snap, qs)

    st, io = hnsw.delete_batch(TCFG, st, torch.from_numpy(r["dels"]))
    name, ref_np, want, want_snap, ref_io = next(steps)
    assert_same_state(st, ref_np)
    assert int(st.n_delete_noops) == 2      # the repeat and the unallocated id
    _check_search(TCFG, st, want, want_snap, qs)
    assert not np.isin(want.ids, r["dels"][r["dels"] >= 0]).any()

    st, io = hnsw.consolidate(TCFG, st)
    name, ref_np, want, want_snap, ref_io = next(steps)
    assert_same_state(st, ref_np)
    assert [int(a) for a in io] == [int(a) for a in ref_io]
    _check_search(TCFG, st, want, want_snap, qs)

    one = hnsw.search(TCFG, st, qs[1])
    np.testing.assert_array_equal(one.ids.numpy(), r["single"].ids)
    np.testing.assert_array_equal(one.heat_mask.numpy(),
                                  r["single"].heat_mask)
    assert [int(a) for a in one.stats] == [int(a) for a in r["single"].stats]


def test_each_step_matches_from_the_bridged_state(ref_run):
    """Each update applied to the reference's own previous state (carried
    across by the bridge) lands on the reference's next state."""
    r = ref_run
    states = [s[1] for s in r["steps"]]
    st = hnsw_state_from_numpy(states[0], "cpu")
    st, _ = hnsw.insert_batch(TCFG, st, torch.from_numpy(r["xs"]),
                              torch.from_numpy(r["u01_ins"]),
                              valid=torch.from_numpy(r["valid"]))
    assert_same_state(st, states[1])
    st = hnsw_state_from_numpy(states[1], "cpu")
    st, _ = hnsw.delete_batch(TCFG, st, torch.from_numpy(r["dels"]))
    assert_same_state(st, states[2])
    st = hnsw_state_from_numpy(states[2], "cpu")
    st, _ = hnsw.consolidate(TCFG, st, block=7)
    assert_same_state(st, states[3])
    np.testing.assert_array_equal(hnsw_state_to_numpy(
        hnsw_state_from_numpy(states[3], "cpu"))["codes"], states[3]["codes"])


def test_eager_delete_is_not_ported():
    """Eager delete was once refused here; it is ported now
    (`tests/test_torch_delete.py` holds it against the reference).  On an
    empty index every id is absent: a counted no-op, as in the
    reference, whose counters and tree this checks."""
    cfg = TCFG._replace(lazy_delete=False)
    st = hnsw.init(cfg, torch.zeros((cfg.m_bits, cfg.dim)), "cpu")
    jcfg = JCFG._replace(lazy_delete=False)
    ref_st, ref_io = ref.delete_batch(jcfg, ref.init(jcfg, jax.random.key(0)),
                                      jnp.asarray([0, -1, 0], jnp.int32))
    st, io = hnsw.delete_batch(cfg, st, torch.tensor([0, -1, 0]))
    assert int(st.n_delete_noops) == int(ref_st.n_delete_noops) == 2
    assert [int(a) for a in io] == [int(a) for a in ref_io] == [0, 0, 0, 0]
    got = lsm_state_to_numpy(st.store)
    for k, v in _np_state(ref_st.store).items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)
