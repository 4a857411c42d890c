"""Public wrapper of the dense squared-L2 kernel.

CPU tensors take the plain version in `ref.py`; CUDA tensors launch the
kernel in `csrc/l2_distance.cu`, or raise.  Ragged shapes are handled in
the kernel, so nothing is padded here.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.l2_distance.ref import l2_distance_ref


def _kernel():
    fn = _build.library("l2_distance").l2_distance_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def l2_distance(queries: torch.Tensor,
                candidates: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances f32[Q, N] between f32[Q, d] and f32[N, d].

    `l2_distance.launches` counts kernel launches.
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
    if n_q >= 65535 * 64:
        raise ValueError(f"l2_distance: {n_q} query rows exceed the grid")
    out = torch.empty((n_q, n_c), dtype=torch.float32, device=queries.device)
    if n_q * n_c == 0:
        return out
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(queries.data_ptr(), candidates.data_ptr(),
                        out.data_ptr(), n_q, n_c, d, stream)
    _build.check(err, "l2_distance")
    l2_distance.launches += 1
    return out


l2_distance.launches = 0
