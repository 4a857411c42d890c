"""Public wrapper of the gather + squared-L2 kernel.

CPU tensors take the plain version in `ref.py`; CUDA tensors launch the
kernel in `csrc/gather_l2.cu`, or raise.  There is no fallback from one
to the other.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_l2.ref import gather_l2_ref


def _kernel():
    fn = _build.library("gather_l2").gather_l2_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gather_l2(queries: torch.Tensor, table: torch.Tensor,
              ids: torch.Tensor) -> torch.Tensor:
    """Fetch `table[ids]` and return squared L2 to `queries`.

    queries f32[B, d], table f32[N, d], ids int32[B, K] -> f32[B, K];
    ids < 0 yield +inf.  `gather_l2.launches` counts kernel launches.
    """
    devs = {queries.device, table.device, ids.device}
    if devs == {torch.device("cpu")}:
        return gather_l2_ref(queries, table, ids)
    if len(devs) != 1 or queries.device.type != "cuda":
        raise ValueError(f"gather_l2: tensors on mixed devices {devs}")
    if queries.dtype != torch.float32 or table.dtype != torch.float32 \
            or ids.dtype != torch.int32:
        raise TypeError("gather_l2 takes f32 queries and table and int32 "
                        f"ids, got {queries.dtype}, {table.dtype}, "
                        f"{ids.dtype}")
    if queries.dim() != 2 or table.dim() != 2 or ids.dim() != 2 \
            or ids.shape[0] != queries.shape[0] \
            or table.shape[1] != queries.shape[1]:
        raise ValueError(
            f"gather_l2: shapes queries {tuple(queries.shape)}, table "
            f"{tuple(table.shape)}, ids {tuple(ids.shape)} do not match "
            "[B, d], [N, d], [B, K]")
    if not (queries.is_contiguous() and table.is_contiguous()
            and ids.is_contiguous()):
        raise ValueError("gather_l2 takes contiguous tensors")
    b, d = queries.shape
    k = ids.shape[1]
    out = torch.empty((b, k), dtype=torch.float32, device=queries.device)
    if b * k == 0:
        return out
    vec4 = d % 4 == 0 and queries.data_ptr() % 16 == 0 \
        and table.data_ptr() % 16 == 0
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(queries.data_ptr(), table.data_ptr(), ids.data_ptr(),
                        out.data_ptr(), b, k, d, table.shape[0], int(vec4),
                        stream)
    _build.check(err, "gather_l2")
    gather_l2.launches += 1
    return out


gather_l2.launches = 0
