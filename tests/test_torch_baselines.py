"""The DiskANN-like and SPFresh-like baselines, port against reference,
on the CPU.

Both packages run the same host numpy loops on the same random draws;
only the dense distance blocks differ in who computes them.  DiskANN on
integer-valued rows is bitwise: adjacency, entry, search ids and dists,
insert ids and back-edges, I/O counters, memory.  SPFresh's k-means
measures distances to float centroids, which torch's and XLA's products
may round apart: postings and search ids must agree, except where a
row's two nearest centroids (a query's last probed and first unprobed
one) lie within 1e-5 relative of each other; the count of such rows is
printed.  The reference's recall floors (`test_baselines.py`) hold for
the port too.
"""

import numpy as np
import pytest
import torch

from repro.core.baselines import DiskANNIndex as RefDiskANN
from repro.core.baselines import SPFreshIndex as RefSPFresh
from repro_torch.core.baselines import DiskANNIndex, SPFreshIndex
from repro_torch.core.index import brute_force_knn, recall_at_k
from repro_torch.data.synth import make_clustered_vectors

torch.set_num_threads(1)


def _ints(rng, shape):
    return rng.integers(-3, 4, shape).astype(np.float32)


def _same_io(t, j):
    assert [int(x) for x in t.io_stats] == [int(x) for x in j.io_stats]


@pytest.fixture(scope="module")
def diskann_pair():
    rng = np.random.default_rng(2)
    base, xs, qs = (_ints(rng, (n, 32)) for n in (600, 24, 20))
    t = DiskANNIndex.build(base, M=8, ef=32, seed=4, device="cpu")
    j = RefDiskANN.build(base, M=8, ef=32, seed=4)
    return t, j, xs, qs


def test_diskann_build_search_insert_delete_match_reference(diskann_pair):
    t, j, xs, qs = diskann_pair
    assert t.entry == j.entry and t.n_base == j.n_base
    assert len(t.adj) == len(j.adj)
    for a, b in zip(t.adj, j.adj):
        np.testing.assert_array_equal(a, b)
    for _ in range(2):
        got, want = t.search(qs, k=10), j.search(qs, k=10)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        _same_io(t, j)
        assert t.memory_bytes() == j.memory_bytes()
        for x in xs[:12]:
            assert t.insert(x) == j.insert(x)
        for a, b in zip(t.adj, j.adj):       # out- and back-edges
            np.testing.assert_array_equal(a, b)
        for v in np.flatnonzero(t.live)[::37]:
            t.delete(int(v))
            j.delete(int(v))
        xs = xs[12:]
        assert t.size == j.size
    _same_io(t, j)
    t.reset_stats()
    assert [int(x) for x in t.io_stats] == [0, 0, 0, 0]


def _owner(idx):
    own = np.full(len(idx.vectors), -1)
    for c, p in enumerate(idx.postings):
        own[np.asarray(p, np.int64)] = c
    return own


def _near_tie(d, rank):
    """True where the entries at `rank` and `rank + 1` of d's sorted row
    lie within 1e-5 relative of each other."""
    s = np.sort(d)
    return s[rank + 1] - s[rank] <= 1e-5 * s[rank + 1]


def _postings_apart(t, j):
    """Rows whose posting differs between the packages; each must sit on
    a near tie between its two nearest reference centroids."""
    apart = np.flatnonzero(_owner(t) != _owner(j))
    for r in apart:
        assert _near_tie(((j.centroids - j.vectors[r]) ** 2).sum(1), 0), r
    return len(apart)


def _searches_apart(t, j, qs, k):
    got, want = t.search(qs, k=k), j.search(qs, k=k)
    apart = np.flatnonzero((got[0] != want[0]).any(1))
    for i in apart:
        d = ((j.centroids - qs[i]) ** 2).sum(1)
        assert _near_tie(d, j.n_probe - 1), i
    same = np.setdiff1d(np.arange(len(qs)), apart)
    np.testing.assert_array_equal(got[1][same], want[1][same])
    return len(apart)


def test_spfresh_build_search_insert_delete_match_reference():
    data = make_clustered_vectors(1024, dim=32, seed=0, clusters=16)
    qs = make_clustered_vectors(32, dim=32, seed=7, clusters=16)
    t = SPFreshIndex.build(data[:768], posting_cap=64, n_probe=4, seed=1,
                           device="cpu")
    j = RefSPFresh.build(data[:768], posting_cap=64, n_probe=4, seed=1)
    apart = [_postings_apart(t, j)]
    np.testing.assert_allclose(t.centroids, j.centroids, rtol=1e-5,
                               atol=1e-5)
    apart.append(_searches_apart(t, j, qs, 10))
    for x in data[768:]:
        assert t.insert(x) == j.insert(x)
    for v in range(0, 1024, 11):
        t.delete(v)
        j.delete(v)
    apart += [_postings_apart(t, j), _searches_apart(t, j, qs, 10)]
    print(f"SPFresh rows apart (postings, search, postings, search): "
          f"{apart}")
    assert [len(p) for p in t.postings] == [len(p) for p in j.postings]
    assert all(len(p) <= t.posting_cap for p in t.postings)
    _same_io(t, j)
    assert t.memory_bytes() == j.memory_bytes() and t.size == j.size


@pytest.fixture(scope="module")
def recall_world():
    data = make_clustered_vectors(1024, dim=32, seed=0, clusters=16)
    queries = make_clustered_vectors(32, dim=32, seed=7, clusters=16)
    return data, queries, brute_force_knn(data, queries, 10, device="cpu")


def test_port_diskann_static_recall_floor(recall_world):
    data, queries, truth = recall_world
    idx = DiskANNIndex.build(data, M=16, ef=64, device="cpu")
    r = recall_at_k(idx.search(queries, k=10)[0], truth)
    assert r >= 0.85, f"DiskANN static recall {r:.3f}"


def test_port_spfresh_recall_is_moderate(recall_world):
    data, queries, truth = recall_world
    idx = SPFreshIndex.build(data, posting_cap=128, n_probe=4, device="cpu")
    r = recall_at_k(idx.search(queries, k=10)[0], truth)
    assert 0.4 <= r <= 1.0, f"SPFresh recall {r:.3f}"


def test_baselines_run_on_the_card_unless_asked_for_the_cpu():
    data = np.zeros((8, 4), np.float32)
    for cls in (DiskANNIndex, SPFreshIndex):
        assert cls(4, device="cpu").device == torch.device("cpu")
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="device='cpu'"):
                cls.build(data)
