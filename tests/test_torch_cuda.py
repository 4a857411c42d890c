"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test here needs a CUDA device and skips without one; the
file imports neither JAX nor the reference, so it runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

`gather_l2` is bitwise on integer-valued inputs and allclose at rtol
1e-6 otherwise (the warp reduction sums in another order);
`l2_distance` is allclose at rtol 1e-5 with an absolute slack of 1e-3
of the largest squared norm, for the cancellation in |q|^2 + |c|^2 -
2 q.c.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.gather_l2.ops import gather_l2
from repro_torch.kernels.gather_l2.ref import gather_l2_ref
from repro_torch.kernels.l2_distance.ops import l2_distance
from repro_torch.kernels.l2_distance.ref import l2_distance_ref

torch.set_num_threads(1)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _gather_inputs(d, integer, seed, b, k, n):
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


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 65, 128])
@pytest.mark.parametrize("k", [16, 48])
def test_gather_l2_cuda_kernel_matches_plain(d, k):
    dev = _cuda()
    for integer in (True, False):
        q, table, ids = (torch.from_numpy(a).to(dev) for a in _gather_inputs(
            d, integer, seed=k, b=300, k=k, n=5000))
        before = gather_l2.launches
        out = gather_l2(q, table, ids)
        torch.cuda.synchronize()
        assert gather_l2.launches == before + 1
        ref = gather_l2_ref(q, table, ids)
        if integer:
            assert torch.equal(out, ref)
        else:
            torch.testing.assert_close(out, ref, rtol=1e-6, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("q_n,c_n,d", [(1000, 4097, 128), (37, 1001, 128),
                                       (64, 300, 65)])
def test_l2_distance_cuda_kernel_matches_plain(q_n, c_n, d):
    dev = _cuda()
    g = torch.Generator().manual_seed(q_n + c_n)
    q = (10 * torch.randn((q_n, d), generator=g)).to(dev)
    c = (10 * torch.randn((c_n, d), generator=g)).to(dev)
    before = l2_distance.launches
    out = l2_distance(q, c)
    torch.cuda.synchronize()
    assert l2_distance.launches == before + 1
    ref = l2_distance_ref(q, c)
    scale = max(float((q * q).sum(1).max()), float((c * c).sum(1).max()))
    torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-3 * scale)
    assert bool((out >= 0).all())


@pytest.mark.cuda
def test_cuda_wrappers_reject_what_the_kernels_do_not_take():
    dev = _cuda()
    q = torch.zeros((2, 8), device=dev)
    table = torch.zeros((4, 8), device=dev)
    ids = torch.zeros((2, 3), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        gather_l2(q, table.cpu(), ids)
    with pytest.raises(TypeError):
        gather_l2(q, table, ids.long())
    with pytest.raises(ValueError):
        gather_l2(q, table[:, :4], ids)
    with pytest.raises(ValueError):
        l2_distance(q, table.T.contiguous().T)
    with pytest.raises(TypeError):
        l2_distance(q.double(), table.double())
