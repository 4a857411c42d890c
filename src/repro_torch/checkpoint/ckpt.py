"""Atomic checkpointing of array trees, with a manifest, for restarts.

The port's copy of `repro.checkpoint.ckpt`, on the same on-disk layout:

 - *atomicity*: a checkpoint is staged under `step_<N>.tmp` and renamed
   into place only after every array and the manifest are fsync'd, so a
   crash mid-save never corrupts the latest checkpoint;
 - *logical layout*: arrays are saved by path with their whole shape,
   one `arrays.npz` beside a `manifest.json` that records the step, each
   path's file, dtype and shape, and the caller's metadata;
 - retention: the newest `keep` checkpoints stay, older ones go.

A tree is a dict of numpy arrays or tensors (tensors are copied to the
host), nested dicts allowed; paths join keys with "/" in sorted order,
as the reference's flattening of a dict does.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch


def _flatten_with_paths(tree, path: str = ""):
    """[(path, leaf)] of a dict tree, keys sorted at every level."""
    if isinstance(tree, dict):
        out = []
        for key in sorted(tree):
            out += _flatten_with_paths(tree[key],
                                       f"{path}/{key}" if path else str(key))
        return out
    return [(path, tree)]


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def sweep_stale_tmp(ckpt_dir: str) -> int:
    """Remove leftover ``step_*.tmp`` staging directories of crashed
    saves; returns how many.  Called on every save."""
    n = 0
    if not os.path.isdir(ckpt_dir):
        return n
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and name.endswith(".tmp"):
            shutil.rmtree(os.path.join(ckpt_dir, name), ignore_errors=True)
            n += 1
    return n


def save_checkpoint(ckpt_dir: str, step: int, tree: Any,
                    metadata: Optional[Dict] = None, *,
                    keep: int = 3,
                    _pre_publish: Optional[Callable[[], None]] = None) -> str:
    """Stage under ``step_<N>.tmp``, fsync every file, rename into place;
    returns the published directory.

    ``_pre_publish`` is a failure-injection hook called after the stage
    is complete but before the rename, so a test can show that a crash
    there leaves the previous checkpoint untouched.
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    sweep_stale_tmp(ckpt_dir)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp)

    names = {}
    arrays = {}
    for i, (key, leaf) in enumerate(_flatten_with_paths(tree)):
        arr_name = f"arr_{i:05d}"
        arr = _to_numpy(leaf)
        if arr.dtype.kind not in "biufc":
            raise TypeError(f"{key}: dtype {arr.dtype} has no plain "
                            "numpy layout to store")
        names[key] = {"file": arr_name, "dtype": str(arr.dtype),
                      "shape": list(arr.shape)}
        arrays[arr_name] = arr
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    manifest = {"step": step, "entries": names,
                "metadata": metadata or {}}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if _pre_publish is not None:
        _pre_publish()
    os.rename(tmp, final)   # atomic publish
    _fsync_dir(ckpt_dir)    # the rename itself must survive a crash

    steps = sorted(_list_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
    return final


def _list_steps(ckpt_dir: str):
    out = []
    if not os.path.isdir(ckpt_dir):
        return out
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = _list_steps(ckpt_dir)
    return max(steps) if steps else None


def _open(ckpt_dir: str, step: Optional[int]):
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    return manifest, np.load(os.path.join(path, "arrays.npz")), step


def load_arrays(ckpt_dir: str, step: Optional[int] = None
                ) -> Tuple[Dict[str, np.ndarray], Dict, int]:
    """Read every leaf of the latest (or `step`-th) checkpoint as a flat
    ``{path: np.ndarray}`` dict, straight from the manifest.  Returns
    (arrays, metadata, step).  An index's `restore` uses this, its
    structure coming from its config."""
    manifest, data, step = _open(ckpt_dir, step)
    out: Dict[str, np.ndarray] = {}
    for key, ent in manifest["entries"].items():
        arr = data[ent["file"]]
        if list(arr.shape) != ent["shape"]:
            raise ValueError(f"{key}: array shape {list(arr.shape)} != "
                             f"manifest {ent['shape']}")
        out[key] = arr
    return out, manifest["metadata"], step


def restore_checkpoint(ckpt_dir: str, target: Any,
                       step: Optional[int] = None
                       ) -> Tuple[Any, Dict, int]:
    """Restore into the structure of `target`, a dict tree of tensors
    (each leaf comes back as a tensor of its target's dtype, on its
    target's device).  Returns (tree, metadata, step)."""
    manifest, data, step = _open(ckpt_dir, step)
    flat = {}
    for key, leaf in _flatten_with_paths(target):
        if key not in manifest["entries"]:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = data[manifest["entries"][key]["file"]]
        if list(arr.shape) != list(leaf.shape):
            raise ValueError(f"{key}: checkpoint shape {arr.shape} != "
                             f"target {tuple(leaf.shape)}")
        flat[key] = torch.from_numpy(np.array(arr)).to(leaf.device,
                                                        leaf.dtype)

    def build(node, path):
        if isinstance(node, dict):
            return {k: build(v, f"{path}/{k}" if path else str(k))
                    for k, v in node.items()}
        return flat[path]

    return build(target, ""), manifest["metadata"], step
