"""The port's kernels against the reference's.

On the CPU each wrapper takes its plain PyTorch version; the same seeded
inputs go through the reference's oracle and through its Pallas kernel
in interpret mode.  `gather_l2` is bitwise on integer-valued inputs
(every partial sum is an exact integer in f32) and allclose at rtol 1e-6
on real-valued ones, where only the summation order differs.
`l2_distance` is allclose at rtol 1e-5: the matrix product sums in
another order.  The CUDA kernels are held against their plain versions
on the card in `test_torch_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gather_l2.ops import gather_l2 as jax_gather_l2
from repro.kernels.gather_l2.ref import gather_l2_ref as jax_gather_l2_ref
from repro.kernels.l2_distance.ops import l2_distance as jax_l2_distance
from repro.kernels.l2_distance.ref import l2_distance_ref as jax_l2_ref
from repro_torch.kernels.gather_l2.ops import gather_l2
from repro_torch.kernels.l2_distance.ops import l2_distance

torch.set_num_threads(1)


def _gather_inputs(d, integer, seed=0, b=6, k=9, n=50):
    rng = np.random.default_rng(seed)
    if integer:
        q = rng.integers(-8, 9, (b, d)).astype(np.float32)
        table = rng.integers(-8, 9, (n, d)).astype(np.float32)
    else:
        q = rng.normal(size=(b, d)).astype(np.float32)
        table = rng.normal(size=(n, d)).astype(np.float32)
    ids = rng.integers(-1, n, (b, k)).astype(np.int32)
    ids[0, 0] = -1
    return q, table, ids


@pytest.mark.parametrize("d", [16, 65, 128])
@pytest.mark.parametrize("integer", [True, False])
def test_gather_l2_matches_reference(d, integer):
    q, table, ids = _gather_inputs(d, integer, seed=d)
    out = gather_l2(torch.from_numpy(q), torch.from_numpy(table),
                    torch.from_numpy(ids)).numpy()
    ref = np.asarray(jax_gather_l2_ref(jnp.asarray(q), jnp.asarray(table),
                                       jnp.asarray(ids)))
    pallas = np.asarray(jax_gather_l2(jnp.asarray(q), jnp.asarray(table),
                                      jnp.asarray(ids), use_pallas=True,
                                      interpret=True))
    assert out.dtype == np.float32 and out.shape == ids.shape
    assert np.isinf(out[ids < 0]).all()
    if integer:
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out, pallas)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-6)
        np.testing.assert_allclose(out, pallas, rtol=1e-6)


@pytest.mark.parametrize("d", [16, 65, 128])
@pytest.mark.parametrize("b,k", [(1, 1), (1, 7), (1, 9), (3, 13), (2, 100)])
@pytest.mark.parametrize("integer", [True, False])
def test_gather_l2_chunk_shapes_match_reference(b, k, d, integer):
    """The shapes the CUDA kernel treats specially (a lone query, K not a
    multiple of its 8-id chunk) through the plain version, against the
    reference's oracle and its Pallas kernel."""
    q, table, ids = _gather_inputs(d, integer, seed=7 * b + k + d, b=b, k=k)
    out = gather_l2(torch.from_numpy(q), torch.from_numpy(table),
                    torch.from_numpy(ids)).numpy()
    ref = np.asarray(jax_gather_l2_ref(jnp.asarray(q), jnp.asarray(table),
                                       jnp.asarray(ids)))
    pallas = np.asarray(jax_gather_l2(jnp.asarray(q), jnp.asarray(table),
                                      jnp.asarray(ids), use_pallas=True,
                                      interpret=True))
    assert out.shape == (b, k) and np.isinf(out[ids < 0]).all()
    if integer:
        np.testing.assert_array_equal(out, ref)
        np.testing.assert_array_equal(out, pallas)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-6)
        np.testing.assert_allclose(out, pallas, rtol=1e-6)


@pytest.mark.parametrize("d", [65, 128])
@pytest.mark.parametrize("c_n", [1, 129])
@pytest.mark.parametrize("q_n", [1, 64, 65])
def test_l2_distance_tile_edges_match_reference(q_n, c_n, d):
    """Q at the edges of the CUDA kernel's two tiles (64 rows and more)
    through the plain version, against the reference's oracle and its
    Pallas kernel: allclose on float data, equal on integer data."""
    rng = np.random.default_rng(q_n + 3 * c_n + d)
    for integer in (False, True):
        q, c = ((rng.integers(-8, 9, (n, d)) if integer
                 else rng.normal(size=(n, d))).astype(np.float32)
                for n in (q_n, c_n))
        out = l2_distance(torch.from_numpy(q), torch.from_numpy(c)).numpy()
        ref = np.asarray(jax_l2_ref(jnp.asarray(q), jnp.asarray(c)))
        pallas = np.asarray(jax_l2_distance(jnp.asarray(q), jnp.asarray(c),
                                            use_pallas=True, interpret=True))
        assert out.shape == (q_n, c_n) and (out >= 0).all()
        if integer:
            np.testing.assert_array_equal(out, ref)
            np.testing.assert_array_equal(out, pallas)
        else:
            np.testing.assert_allclose(out, ref, rtol=1e-5)
            np.testing.assert_allclose(out, pallas, rtol=1e-5)


@pytest.mark.parametrize("q_n,c_n,d", [(5, 77, 100), (37, 1001, 128),
                                       (1, 3, 65)])
def test_l2_distance_matches_reference(q_n, c_n, d):
    rng = np.random.default_rng(q_n * c_n + d)
    q = rng.normal(size=(q_n, d)).astype(np.float32)
    c = rng.normal(size=(c_n, d)).astype(np.float32)
    out = l2_distance(torch.from_numpy(q), torch.from_numpy(c)).numpy()
    ref = np.asarray(jax_l2_ref(jnp.asarray(q), jnp.asarray(c)))
    pallas = np.asarray(jax_l2_distance(jnp.asarray(q), jnp.asarray(c),
                                        use_pallas=True, interpret=True))
    assert out.shape == (q_n, c_n)
    assert (out >= 0).all()
    np.testing.assert_allclose(out, ref, rtol=1e-5)
    np.testing.assert_allclose(out, pallas, rtol=1e-5)


def test_l2_distance_zero_on_identical_rows():
    x = torch.from_numpy(np.random.default_rng(0).integers(
        -5, 6, (40, 33)).astype(np.float32))
    diag = torch.diagonal(l2_distance(x, x))
    assert torch.equal(diag, torch.zeros_like(diag))
