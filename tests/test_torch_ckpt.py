"""The port's checkpoints: `repro_torch.checkpoint` and the index's
`save` / `restore`, on the CPU.

A checkpoint the port writes reads back bitwise through its own
`load_arrays`, and through the reference's, whose manifest it matches
entry for entry; a restored index holds the saved state bitwise and
inserts bitwise as the saved one does.  A cap mismatch, a missing leaf
and a misshapen leaf are each refused.  Staging, retention and the
pre-publish crash hook keep the reference's on-disk layout.
"""

import json
import os

import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt
from repro_torch.checkpoint import ckpt
from repro_torch.core import hnsw, lsm
from repro_torch.core.index import LSMVecIndex
from repro_torch.data.synth import make_clustered_vectors

torch.set_num_threads(1)

CFG = hnsw.HNSWConfig(cap=512, dim=16, M=8, M_up=4, num_upper=2,
                      ef_search=16, ef_construction=16, k=5,
                      lsm_mem_cap=64, lsm_levels=2, lsm_fanout=8)


@pytest.fixture(scope="module")
def built():
    """A small port index with inserts, tombstones and heat."""
    data = make_clustered_vectors(260, CFG.dim, seed=3, clusters=4)
    idx = LSMVecIndex.build(CFG, data[:200], seed=5, device="cpu")
    idx.insert_batch(data[200:])
    idx.delete_batch(np.arange(0, 200, 17))
    idx.search(data[:8])
    return idx


def _leaves(idx):
    return lsm.dehydrate(idx.state, "state")


def test_save_then_load_arrays_is_bitwise(built, tmp_path):
    ext = np.arange(built._count, dtype=np.int64)[::-1].copy()
    path = built.save(str(tmp_path), lsn=7, extra={"ext2int": ext},
                      meta={"note": "x"})
    assert path == os.path.join(str(tmp_path), "step_00000007")
    assert sorted(os.listdir(path)) == ["arrays.npz", "manifest.json"]
    arrays, meta, step = ckpt.load_arrays(str(tmp_path))
    assert step == 7
    assert meta == {"lsn": 7, "count": built._count,
                    "version": built._version, "seed": 5, "cap": CFG.cap,
                    "dim": CFG.dim, "note": "x"}
    want = {k: t.numpy() for k, t in _leaves(built).items()}
    want["rng"] = built._rng.get_state().numpy()
    want["extra/ext2int"] = ext
    assert arrays.keys() == want.keys()
    for k, v in want.items():
        assert arrays[k].dtype == v.dtype, k
        np.testing.assert_array_equal(arrays[k], v, err_msg=k)
    # the reference reads the port's checkpoint leaf for leaf
    ref_arrays, ref_meta, _ = ref_ckpt.load_arrays(str(tmp_path))
    assert ref_meta == meta
    for k, v in want.items():
        np.testing.assert_array_equal(ref_arrays[k], v, err_msg=k)


def test_manifest_matches_the_reference_layout(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"b": rng.normal(size=(3, 4)).astype(np.float32),
            "a/x": rng.integers(0, 9, (5,)).astype(np.int32),
            "c": {"z": np.arange(4, dtype=np.int64),
                  "y": np.ones((2, 2), bool)}}
    ckpt.save_checkpoint(str(tmp_path / "port"), 3, tree, {"m": 1})
    ref_ckpt.save_checkpoint(str(tmp_path / "ref"), 3, tree, {"m": 1})
    manifests = [json.loads((tmp_path / d / "step_00000003" /
                             "manifest.json").read_text())
                 for d in ("port", "ref")]
    assert manifests[0] == manifests[1]
    got, _, _ = ckpt.load_arrays(str(tmp_path / "ref"))
    np.testing.assert_array_equal(got["c/y"], tree["c"]["y"])
    target = {"b": torch.zeros((3, 4)), "c": {"z": torch.zeros(4)}}
    back, meta, step = ckpt.restore_checkpoint(str(tmp_path / "port"),
                                               target)
    assert (meta, step) == ({"m": 1}, 3)
    assert torch.equal(back["b"], torch.from_numpy(tree["b"]))
    assert back["c"]["z"].dtype == torch.float32
    assert torch.equal(back["c"]["z"], torch.arange(4.0))
    with pytest.raises(KeyError):
        ckpt.restore_checkpoint(str(tmp_path / "port"), {"q": torch.zeros(1)})
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore_checkpoint(str(tmp_path / "port"),
                                {"b": torch.zeros((4, 3))})


def test_restore_is_bitwise_and_inserts_as_the_saved_index(built, tmp_path):
    saved = built.clone()
    saved.save(str(tmp_path), lsn=1, extra={"mask": np.ones(3, bool)})
    idx, meta, extras = LSMVecIndex.restore(CFG, str(tmp_path),
                                            device="cpu")
    assert meta["lsn"] == 1 and list(extras) == ["mask"]
    for k, t in _leaves(saved).items():
        got = _leaves(idx)[k]
        assert got.dtype == t.dtype and torch.equal(got, t), k
    assert (idx._count, idx._version) == (saved._count, saved._version)
    assert idx.stats() == saved.stats()
    xs = make_clustered_vectors(40, CFG.dim, seed=9, clusters=4)
    a, b = idx.insert_batch(xs), saved.insert_batch(xs)
    np.testing.assert_array_equal(a.ids, b.ids)
    for k, t in _leaves(saved).items():
        assert torch.equal(_leaves(idx)[k], t), k
    qs = xs[:5] + 0.5
    np.testing.assert_array_equal(idx.search(qs).ids, saved.search(qs).ids)


@pytest.mark.parametrize("fault", ["cap", "dim", "missing", "misshapen"])
def test_restore_refuses_a_checkpoint_of_another_layout(built, tmp_path,
                                                        fault):
    if fault in ("cap", "dim"):
        built.save(str(tmp_path))
        other = CFG._replace(**{fault: getattr(CFG, fault) * 2})
        with pytest.raises(ValueError, match="cap/dim"):
            LSMVecIndex.restore(other, str(tmp_path), device="cpu")
        return
    tree = {k: t.numpy() for k, t in _leaves(built).items()}
    tree["rng"] = built._rng.get_state().numpy()
    if fault == "missing":
        del tree["state/store/level_vals/1"]
    else:
        tree["state/heat"] = tree["state/heat"][:, :-1]
    ckpt.save_checkpoint(str(tmp_path), 0, tree, {
        "lsn": 0, "count": built._count, "version": 0, "seed": 5,
        "cap": CFG.cap, "dim": CFG.dim})
    err = KeyError if fault == "missing" else ValueError
    with pytest.raises(err, match="level_vals/1" if fault == "missing"
                       else "state/heat"):
        LSMVecIndex.restore(CFG, str(tmp_path), device="cpu")


def test_staging_retention_and_crash_before_publish(tmp_path):
    d = str(tmp_path)
    tree = {"x": np.arange(3)}
    for step in range(4):
        ckpt.save_checkpoint(d, step, tree, keep=2)
    assert sorted(os.listdir(d)) == ["step_00000002", "step_00000003"]
    assert ckpt.latest_step(d) == 3

    def crash():
        raise RuntimeError("killed before publish")

    with pytest.raises(RuntimeError, match="killed"):
        ckpt.save_checkpoint(d, 9, {"x": np.arange(5)}, _pre_publish=crash)
    assert "step_00000009.tmp" in os.listdir(d)
    arrays, _, step = ckpt.load_arrays(d)
    assert step == 3 and arrays["x"].tolist() == [0, 1, 2]
    assert ckpt.sweep_stale_tmp(d) == 1
    assert ckpt.latest_step(d) == 3
    with pytest.raises(FileNotFoundError):
        ckpt.load_arrays(str(tmp_path / "empty"))
