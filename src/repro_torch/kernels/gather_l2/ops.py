"""Public wrappers of the gather + squared-L2 kernels.

CPU tensors take the plain versions in `ref.py`; CUDA tensors launch the
kernels in `csrc/gather_l2.cu`, or raise.  There is no fallback from one
to the other.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_l2.ref import gather_l2_q8_ref, gather_l2_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


_fns: dict = {}


def _kernel(name: str, argtypes):
    """The C entry point `name`, bound on first use."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.library("gather_l2"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


#: pairs up to which a call takes the warp-per-pair kernel
#: (`kPairCalls` in `csrc/gather_l2.cu`)
PAIR_CALLS = 64


def shape_class(b: int, k: int) -> str:
    """The kernel a [b, k] call launches: "pair" (one warp per pair, at
    most `PAIR_CALLS` pairs) or "chunk" (one warp per 8 ids)."""
    return "pair" if b * k <= PAIR_CALLS else "chunk"


def _on_card(name: str, queries, table, ids, *extra) -> bool:
    """True for CUDA tensors the kernel takes, False for CPU tensors;
    raises on mixed devices, dtypes, shapes or layouts it does not take."""
    tensors = (queries, table, ids) + extra
    devs = {t.device for t in tensors}
    if devs == {torch.device("cpu")}:
        return False
    if len(devs) != 1 or queries.device.type != "cuda":
        raise ValueError(f"{name}: tensors on mixed devices {devs}")
    if queries.dtype != torch.float32 or ids.dtype != torch.int32:
        raise TypeError(f"{name} takes f32 queries and int32 ids, got "
                        f"{queries.dtype}, {ids.dtype}")
    if queries.dim() != 2 or table.dim() != 2 or ids.dim() != 2 \
            or ids.shape[0] != queries.shape[0] \
            or table.shape[1] != queries.shape[1]:
        raise ValueError(
            f"{name}: shapes queries {tuple(queries.shape)}, table "
            f"{tuple(table.shape)}, ids {tuple(ids.shape)} do not match "
            "[B, d], [N, d], [B, K]")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    return True


def gather_l2(queries: torch.Tensor, table: torch.Tensor,
              ids: torch.Tensor) -> torch.Tensor:
    """Fetch `table[ids]` and return squared L2 to `queries`.

    queries f32[B, d], table f32[N, d], ids int32[B, K] -> f32[B, K];
    ids < 0 yield +inf.  `gather_l2.launches` counts kernel launches,
    and `gather_l2.by_class` the same launches by `shape_class`.
    """
    if not _on_card("gather_l2", queries, table, ids):
        return gather_l2_ref(queries, table, ids)
    if table.dtype != torch.float32:
        raise TypeError(f"gather_l2 takes an f32 table, got {table.dtype}")
    b, d = queries.shape
    k = ids.shape[1]
    out = torch.empty((b, k), dtype=torch.float32, device=queries.device)
    if b * k == 0:
        return out
    vec4 = d % 4 == 0 and queries.data_ptr() % 16 == 0 \
        and table.data_ptr() % 16 == 0
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel("gather_l2_f32", [_P, _P, _P, _P, _I, _I, _I, _L, _I,
                                        _P])(
            queries.data_ptr(), table.data_ptr(), ids.data_ptr(),
            out.data_ptr(), b, k, d, table.shape[0], int(vec4), stream)
    _build.check(err, "gather_l2")
    gather_l2.launches += 1
    gather_l2.by_class[shape_class(b, k)] += 1
    _build.taken("gather_l2", shape_class(b, k))
    return out


gather_l2.launches = 0
#: launches by `shape_class`, reset with `launches`
gather_l2.by_class = Counter()


def gather_l2_q8(queries: torch.Tensor, qtable: torch.Tensor,
                 scales: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Cold-lane gather: squared L2 from `queries` to the dequantised rows
    ``qtable[ids] * scales[ids]``.

    queries f32[B, d], qtable int8[N, d], scales f32[N], ids int32[B, K]
    -> f32[B, K]; ids < 0 yield +inf.  `gather_l2_q8.launches` counts
    kernel launches.
    """
    if not _on_card("gather_l2_q8", queries, qtable, ids, scales):
        return gather_l2_q8_ref(queries, qtable, scales, ids)
    if qtable.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError("gather_l2_q8 takes an int8 table and f32 scales, "
                        f"got {qtable.dtype}, {scales.dtype}")
    if tuple(scales.shape) != (qtable.shape[0],):
        raise ValueError(f"gather_l2_q8: scales {tuple(scales.shape)} do "
                         f"not match table rows {qtable.shape[0]}")
    b, d = queries.shape
    k = ids.shape[1]
    out = torch.empty((b, k), dtype=torch.float32, device=queries.device)
    if b * k == 0:
        return out
    vec4 = d % 4 == 0 and queries.data_ptr() % 16 == 0 \
        and qtable.data_ptr() % 4 == 0
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel("gather_l2_q8_f32", [_P, _P, _P, _P, _P, _I, _I, _I,
                                           _L, _I, _P])(
            queries.data_ptr(), qtable.data_ptr(), scales.data_ptr(),
            ids.data_ptr(), out.data_ptr(), b, k, d, qtable.shape[0],
            int(vec4), stream)
    _build.check(err, "gather_l2_q8")
    gather_l2_q8.launches += 1
    _build.taken("gather_l2_q8")
    return out


gather_l2_q8.launches = 0
