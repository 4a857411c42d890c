"""The port's SimHash kernel package (`repro_torch.kernels.simhash`) on the
CPU, against the reference's Pallas kernels (run in interpret mode, as
the reference's own CPU tests run them) and its jnp oracles.

On integer-valued inputs every projection is an exact integer in f32 and
in f64, so codes and counts are bitwise equal.  On float data the port
takes the signs in f64 and the reference in f32; the bits that differ
are counted, and each must sit where an f32 rounding can flip a sign.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.simhash import ops as ref_ops
from repro.kernels.simhash import ref as ref_ref
from repro_torch.core import simhash
from repro_torch.kernels.simhash.ops import (
    collision_count,
    collision_count_rows,
    simhash_encode,
)
from repro_torch.kernels.simhash.ref import (
    collision_count_ref,
    collision_count_rows_ref,
    simhash_encode_ref,
)

torch.set_num_threads(1)


def _ints(rng, shape):
    return rng.integers(-6, 7, shape).astype(np.float32)


@pytest.mark.parametrize("m_bits", [32, 64, 128])
@pytest.mark.parametrize("d", [16, 65, 128])
def test_encode_and_counts_match_reference_kernels(d, m_bits):
    rng = np.random.default_rng(d * 1000 + m_bits)
    proj = rng.normal(size=(m_bits, d)).astype(np.float32)
    cand = _ints(rng, (300, d))
    want_c = np.asarray(ref_ops.simhash_encode(
        jnp.asarray(cand), jnp.asarray(proj), use_pallas=True,
        interpret=True))
    got_c = simhash_encode(torch.from_numpy(cand), torch.from_numpy(proj))
    assert got_c.dtype == torch.int64
    np.testing.assert_array_equal(got_c.numpy().astype(np.uint32), want_c)
    np.testing.assert_array_equal(
        want_c, np.asarray(ref_ref.simhash_encode_ref(jnp.asarray(cand),
                                                      jnp.asarray(proj))))
    for n in (1, 7, 256, 300):
        x = _ints(rng, (n, d))
        want = np.asarray(ref_ops.simhash_encode(
            jnp.asarray(x), jnp.asarray(proj), use_pallas=True,
            interpret=True))
        got = simhash_encode(torch.from_numpy(x), torch.from_numpy(proj))
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
        cols_want = np.asarray(ref_ops.collision_count(
            jnp.asarray(want), jnp.asarray(want_c), m_bits, use_pallas=True,
            interpret=True))
        np.testing.assert_array_equal(cols_want, np.asarray(
            ref_ref.collision_count_ref(jnp.asarray(want),
                                        jnp.asarray(want_c), m_bits)))
        cols = collision_count(got, got_c, m_bits)
        assert cols.dtype == torch.int32 and cols.shape == (n, 300)
        np.testing.assert_array_equal(cols.numpy(), cols_want)
        # the gathered form is the all-pairs form at the clamped ids
        ids = rng.integers(-3, 303, (n, 16)).astype(np.int32)
        rows = collision_count_rows(got, got_c, torch.from_numpy(ids), m_bits)
        assert rows.dtype == torch.int32
        np.testing.assert_array_equal(
            rows.numpy(),
            np.take_along_axis(cols_want, np.clip(ids, 0, 299), axis=1))


def test_cpu_wrappers_take_the_plain_versions_and_count_no_launch():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(_ints(rng, (5, 16)))
    proj = torch.from_numpy(rng.normal(size=(64, 16)).astype(np.float32))
    before = (simhash_encode.launches, collision_count.launches,
              collision_count_rows.launches)
    codes = simhash_encode(x, proj)
    assert torch.equal(codes, simhash_encode_ref(x, proj))
    assert torch.equal(collision_count(codes, codes, 64),
                       collision_count_ref(codes, codes, 64))
    ids = torch.tensor([[0, 4, -1], [5, 2, 2], [1, 1, 1], [3, 0, 9],
                        [4, 4, 4]], dtype=torch.int32)
    assert torch.equal(collision_count_rows(codes, codes, ids, 64),
                       collision_count_rows_ref(codes, codes, ids, 64))
    assert (simhash_encode.launches, collision_count.launches,
            collision_count_rows.launches) == before
    assert (torch.diagonal(collision_count(codes, codes, 64)) == 64).all()
    # empty inputs keep their shapes
    assert simhash_encode(x[:0], proj).shape == (0, 2)
    assert collision_count(codes, codes[:0], 64).shape == (5, 0)
    # leading dims through core.simhash.encode
    assert torch.equal(simhash.encode(proj, x.reshape(5, 1, 16))[:, 0],
                       codes)


def test_exact_zero_projections_set_their_bits_as_in_the_reference():
    """Integer rows and projections built so that the projections of every
    third row are exactly 0 (its second half negates its first, and every
    projection's second half repeats its first), a row of -0.0 and a
    projection of zeros: an exact zero counts as >= 0 (those bits are set)
    in the port as in the reference's Pallas kernel, bitwise."""
    rng = np.random.default_rng(20)
    n, d, m_bits = 40, 64, 64
    x = _ints(rng, (n, d))
    proj = _ints(rng, (m_bits, d))
    proj[:, d // 2:] = proj[:, :d // 2]
    x[::3, d // 2:] = -x[::3, :d // 2]
    x[1] = -0.0
    proj[5] = 0.0
    want = np.asarray(ref_ops.simhash_encode(
        jnp.asarray(x), jnp.asarray(proj), use_pallas=True, interpret=True))
    got = simhash_encode(torch.from_numpy(x), torch.from_numpy(proj))
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert (want[::3] == 2 ** 32 - 1).all() and (want[1] == 2 ** 32 - 1).all()
    assert ((want[:, 0] >> 5) & 1).all()    # the zero projection, every row


def test_float_codes_differ_from_the_f32_reference_only_near_zero():
    """The port's signs are those of the f64 dot product; the reference's
    are those of its f32 product.  They may differ only where the exact
    projection is within f32 rounding of zero (ROADMAP Queue 3, P5)."""
    rng = np.random.default_rng(7)
    n, d, m_bits = 4000, 128, 64
    x = rng.normal(size=(n, d)).astype(np.float32)
    proj = rng.normal(size=(m_bits, d)).astype(np.float32)
    want = np.asarray(ref_ops.simhash_encode(
        jnp.asarray(x), jnp.asarray(proj), use_pallas=True, interpret=True))
    got = simhash_encode(torch.from_numpy(x),
                         torch.from_numpy(proj)).numpy().astype(np.uint32)
    diff = want ^ got
    bits = np.unpackbits(diff.view(np.uint8), bitorder="little").reshape(
        n, m_bits)
    z = x.astype(np.float64) @ proj.astype(np.float64).T
    scale = np.abs(x).astype(np.float64) @ np.abs(proj).astype(np.float64).T
    # every differing bit's exact projection lies within a few f32
    # roundings of the sum's magnitude
    assert (np.abs(z[bits > 0]) <= 4 * d * 2.0 ** -24 * scale[bits > 0]).all()
    assert int(bits.sum()) <= 8, int(bits.sum())
