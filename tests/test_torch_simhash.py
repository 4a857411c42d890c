"""The port's SimHash (codes, collisions, Hoeffding filter) against the
reference.  Codes and collision counts are bitwise equal; the threshold
goes through arccos, which the two libraries round differently in the
last place, so it is compared allclose."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import simhash as ref
from repro_torch.core import simhash

torch.set_num_threads(1)


def _inputs(n, dim, m_bits, seed):
    rng = np.random.default_rng(seed)
    proj = rng.normal(size=(m_bits, dim)).astype(np.float32)
    x = rng.integers(-6, 7, (n, dim)).astype(np.float32)
    return proj, x


@pytest.mark.parametrize("dim,m_bits", [(16, 64), (65, 32), (128, 128)])
def test_codes_and_collisions_bitwise(dim, m_bits):
    proj, x = _inputs(200, dim, m_bits, seed=dim)
    params = ref.SimHashParams(jnp.asarray(proj))
    want = np.asarray(ref.encode(params, jnp.asarray(x)))
    got = simhash.encode(torch.from_numpy(proj), torch.from_numpy(x))
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert int(got.max()) < 2 ** 32 and int(got.min()) >= 0
    # packing order: bit i of word w is projection 32w+i
    bits = (x @ proj.T) >= 0
    w = got.numpy()
    for j in range(m_bits):
        np.testing.assert_array_equal((w[:, j // 32] >> (j % 32)) & 1,
                                      bits[:, j])
    cols_ref = np.asarray(ref.collisions(jnp.asarray(want)[:, None, :],
                                         jnp.asarray(want)[None, :, :],
                                         m_bits))
    cols = simhash.collisions(got[:, None, :], got[None, :, :], m_bits)
    assert cols.dtype == torch.int32
    np.testing.assert_array_equal(cols.numpy(), cols_ref)
    assert (cols.diagonal() == m_bits).all()


def test_popcount_full_word_range():
    words = torch.tensor([0, 1, 2 ** 31, 2 ** 32 - 1, 0x55555555,
                          0xF0F0F0F0, 0x80000001], dtype=torch.int64)
    want = [bin(int(v)).count("1") for v in words]
    assert simhash.popcount(words).tolist() == want


def test_threshold_cos_and_filter_mask_match():
    rng = np.random.default_rng(3)
    cos = rng.uniform(-1, 1, 500).astype(np.float32)
    # an ulp of arccos, scaled by m_bits = 64, is ~4e-6 of the threshold
    np.testing.assert_allclose(
        simhash.hoeffding_threshold(64, 0.1, torch.from_numpy(cos)).numpy(),
        np.asarray(ref.hoeffding_threshold(64, 0.1, jnp.asarray(cos))),
        rtol=0, atol=1e-5)
    delta = rng.uniform(0, 80, 500).astype(np.float32)
    qn, un = np.float32(4.25), np.float32(5.5)
    np.testing.assert_array_equal(
        simhash.cos_from_l2(torch.from_numpy(delta), torch.tensor(qn),
                            torch.tensor(un)).numpy(),
        np.asarray(ref.cos_from_l2(jnp.asarray(delta), jnp.asarray(qn),
                                   jnp.asarray(un))))
    proj, x = _inputs(300, 24, 64, seed=7)
    params = ref.SimHashParams(jnp.asarray(proj))
    codes = ref.encode(params, jnp.asarray(x))
    want = np.asarray(ref.filter_mask(params, codes[0], codes, 0.1,
                                      jnp.float32(30.0), jnp.float32(9.0),
                                      jnp.float32(10.0)))
    tcodes = simhash.encode(torch.from_numpy(proj), torch.from_numpy(x))
    got = simhash.filter_mask(torch.from_numpy(proj), tcodes[0], tcodes, 0.1,
                              torch.tensor(30.0), torch.tensor(9.0),
                              torch.tensor(10.0)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()
