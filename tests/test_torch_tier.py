"""The port's tiered store (`repro_torch.tier`, the int8 lane of
`gather_l2_q8`) against the reference's `repro.tier`.

`quantize_rows` is compared with the reference's compiled form, which
is what its `tier_maintain` runs (run op by op, the reference divides by
127 where compiled code multiplies by the rounded reciprocal; the two
differ in the last place of some scales).  `tier_maintain` runs on the
same synthetic state in both packages, pass after pass, and every tier
lane, the move counts and the IOStats stay bitwise equal, at the
default EWMA weight of 0.5 and at 0.3, where the reference's FMA
contraction of the EWMA shows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hnsw as jax_hnsw
from repro.core import lsm as ref_lsm
from repro.kernels.gather_l2.ref import gather_l2_q8_ref as jax_q8_ref
from repro.tier import TierPolicy as RefPolicy
from repro.tier import quant as ref_quant
from repro.tier import tier_maintain as ref_tier_maintain
from repro_torch.bridge import hnsw_state_from_numpy, hnsw_state_to_numpy
from repro_torch.core import hnsw
from repro_torch.kernels.gather_l2.ops import gather_l2_q8
from repro_torch.kernels.gather_l2.ref import gather_l2_q8_ref
from repro_torch.tier import (
    TierPolicy,
    dequantize_rows,
    quantize_rows,
    tier_maintain,
)

torch.set_num_threads(1)

JCFG = jax_hnsw.HNSWConfig(cap=256, dim=24, M=8, M_up=4, num_upper=2,
                           ef_search=16, ef_construction=16, k=5,
                           lsm_mem_cap=64, lsm_levels=2, lsm_fanout=8,
                           tier=True, rerank=8)
TCFG = hnsw.HNSWConfig(**{f: getattr(JCFG, f)
                          for f in hnsw.HNSWConfig._fields})


def test_quantize_rows_matches_compiled_reference():
    rng = np.random.default_rng(0)
    rows = (rng.standard_normal((500, 24)) * 5).astype(np.float32)
    rows[3] = 0.0                              # the all-zero row
    rows[4, :] = np.float32(2.5)               # round half to even
    codes, scales = quantize_rows(torch.from_numpy(rows))
    want_c, want_s = jax.jit(ref_quant.quantize_rows)(jnp.asarray(rows))
    assert codes.dtype == torch.int8 and scales.dtype == torch.float32
    np.testing.assert_array_equal(codes.numpy(), np.asarray(want_c))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(want_s))
    assert (codes[3] == 0).all()
    np.testing.assert_array_equal(
        dequantize_rows(codes, scales).numpy(),
        np.asarray(ref_quant.dequantize_rows(want_c, want_s)))
    # the quantizer's own contract: error at most half a step
    err = (dequantize_rows(codes, scales) - torch.from_numpy(rows)).abs()
    assert bool((err <= scales[:, None] * 0.5 + 1e-6).all())


@pytest.mark.parametrize("pow2", [True, False])
def test_gather_l2_q8_ref_matches_reference(pow2):
    """Bitwise where every distance is exact (integer queries, power-of-
    two scales); otherwise within 1e-5 (the two sum in other orders)."""
    rng = np.random.default_rng(1 + pow2)
    table = rng.integers(-127, 128, (300, 65)).astype(np.int8)
    if pow2:
        scales = (2.0 ** rng.integers(-3, 3, 300)).astype(np.float32)
        q = rng.integers(-20, 21, (7, 65)).astype(np.float32)
    else:
        scales = (rng.random(300) * 0.1).astype(np.float32)
        q = rng.normal(size=(7, 65)).astype(np.float32)
    ids = rng.integers(-1, 300, (7, 16)).astype(np.int32)
    ids[0, 0] = -1
    args = [torch.from_numpy(a) for a in (q, table, scales, ids)]
    got = gather_l2_q8(*args)
    assert torch.equal(got, gather_l2_q8_ref(*args))
    want = np.asarray(jax_q8_ref(*(jnp.asarray(a)
                                   for a in (q, table, scales, ids))))
    assert bool(torch.isinf(got[0, 0])) and np.isinf(want[0, 0])
    if pow2:
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def _states():
    """One synthetic state in both packages: live, dead and tombstoned
    slots, random heat and an EWMA already under way."""
    rng = np.random.default_rng(3)
    cap, dim = JCFG.cap, JCFG.dim
    st = jax_hnsw.init(JCFG, jax.random.key(0))
    n = 200
    levels = np.full(cap, -1, np.int32)
    levels[:n] = rng.integers(0, 3, n)
    tomb = np.zeros(cap, bool)
    tomb[rng.choice(n, 12, replace=False)] = True
    st = st._replace(
        vectors=jnp.asarray((rng.standard_normal((cap, dim)) * 3).astype(
            np.float32)),
        levels=jnp.asarray(levels), tombstone=jnp.asarray(tomb),
        n_live=jnp.int32(n - 12),
        heat=jnp.asarray(rng.integers(0, 4, (cap, JCFG.M)).astype(np.int32)),
        tier_heat=jnp.asarray((rng.random(cap) * 9).astype(np.float32)))
    d = {k: np.asarray(v) for k, v in ref_lsm.dehydrate(st).items()}
    return st, hnsw_state_from_numpy(d, "cpu")


@pytest.mark.parametrize("ewma,hyst", [(0.5, 0.05), (0.3, 0.1)])
def test_tier_maintain_matches_reference(ewma, hyst):
    jst, tst = _states()
    jpol = RefPolicy(hot_frac=0.25, ewma=ewma, hysteresis=hyst,
                     max_demote=96, max_promote=16)
    tpol = TierPolicy(**vars(jpol))
    moved_any = {"demoted": 0, "promoted": 0}
    rng = np.random.default_rng(4)
    for step in range(3):
        jst, jio, jmoved = ref_tier_maintain(JCFG, jst, jpol)
        tst, tio, tmoved = tier_maintain(TCFG, tst, tpol)
        got = hnsw_state_to_numpy(tst)
        for name in ("hot", "qvecs", "qscale", "tier_heat"):
            np.testing.assert_array_equal(got[name], np.asarray(
                getattr(jst, name)), err_msg=f"{name} after pass {step}")
        for key in ("demoted", "promoted"):
            assert int(tmoved[key]) == int(jmoved[key])
            moved_any[key] += int(tmoved[key])
        assert [int(a) for a in tio] == [int(a) for a in jio]
        # shift the heat so the next pass promotes some cold nodes back
        heat = rng.integers(0, 6, (JCFG.cap, JCFG.M)).astype(np.int32)
        jst = jst._replace(heat=jnp.asarray(heat))
        tst = tst._replace(heat=torch.from_numpy(heat))
    assert moved_any["demoted"] > 0 and moved_any["promoted"] > 0
