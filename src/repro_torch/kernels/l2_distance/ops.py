"""Public wrapper of the dense squared-L2 kernel.

CPU tensors take the plain version in `ref.py`; CUDA tensors launch the
kernel in `csrc/l2_distance.cu`, or raise.  Ragged shapes are handled in
the kernel, so nothing is padded here.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.l2_distance.ref import l2_distance_ref


_fn = None


def _kernel():
    """The kernel's C entry point, bound on first use."""
    global _fn
    if _fn is None:
        fn = _build.library("l2_distance").l2_distance_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


#: query rows up to which a call takes the 64-row tile
#: (`Flat::kM` in `csrc/l2_distance.cu`)
FLAT_ROWS = 64


def shape_class(n_q: int) -> str:
    """The tile an `n_q`-row call launches: "flat" (64 x 64, at most
    `FLAT_ROWS` rows) or "wide" (128 x 256)."""
    return "flat" if n_q <= FLAT_ROWS else "wide"


def l2_distance(queries: torch.Tensor,
                candidates: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances f32[Q, N] between f32[Q, d] and f32[N, d].

    `l2_distance.launches` counts calls, and `l2_distance.by_class` the
    same calls by `shape_class`; each call launches two kernels, the
    row norms and then the tiles.
    """
    devs = {queries.device, candidates.device}
    if devs == {torch.device("cpu")}:
        return l2_distance_ref(queries, candidates)
    if len(devs) != 1 or queries.device.type != "cuda":
        raise ValueError(f"l2_distance: tensors on mixed devices {devs}")
    if queries.dtype != torch.float32 or candidates.dtype != torch.float32:
        raise TypeError("l2_distance takes f32 tensors, got "
                        f"{queries.dtype}, {candidates.dtype}")
    if queries.dim() != 2 or candidates.dim() != 2 \
            or queries.shape[1] != candidates.shape[1]:
        raise ValueError(
            f"l2_distance: shapes {tuple(queries.shape)} and "
            f"{tuple(candidates.shape)} do not match [Q, d], [N, d]")
    if not (queries.is_contiguous() and candidates.is_contiguous()):
        raise ValueError("l2_distance takes contiguous tensors")
    n_q, d = queries.shape
    n_c = candidates.shape[0]
    if max(n_q, n_c) >= 2 ** 31:
        raise ValueError(f"l2_distance: {n_q} x {n_c} rows exceed the "
                         "kernel's 32-bit row counts")
    out = torch.empty((n_q, n_c), dtype=torch.float32, device=queries.device)
    if n_q * n_c == 0:
        return out
    norms = torch.empty((n_q + n_c,), dtype=torch.float32,
                        device=queries.device)
    vec = d % 4 == 0 and queries.data_ptr() % 16 == 0 \
        and candidates.data_ptr() % 16 == 0
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(queries.data_ptr(), candidates.data_ptr(),
                        norms.data_ptr(), out.data_ptr(), n_q, n_c, d,
                        int(vec), stream)
    _build.check(err, "l2_distance")
    l2_distance.launches += 1
    l2_distance.by_class[shape_class(n_q)] += 1
    _build.taken("l2_distance", shape_class(n_q))
    return out


l2_distance.launches = 0
#: launches by `shape_class`, reset with `launches`
l2_distance.by_class = Counter()
