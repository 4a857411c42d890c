"""Public wrapper of the fused SimHash prefilter + gather kernel.

CPU tensors take the plain version in `ref.py`; CUDA tensors launch
`prefilter_gather_f32` of `csrc/gather_l2.cu`, or raise.  There is no
fallback from one to the other.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.prefilter_gather.ref import prefilter_gather_ref

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

_fns: dict = {}


def _kernel():
    """The C entry point, bound on first use."""
    fn = _fns.get("prefilter_gather_f32")
    if fn is None:
        fn = _build.library("gather_l2").prefilter_gather_f32
        fn.argtypes = [_P] * 12 + [_I] * 5 + [_L, _L, _I, _P]
        fn.restype = ctypes.c_int
        _fns["prefilter_gather_f32"] = fn
    return fn


def _check(queries, table, code_q, codes, row, eligible, thr, tier):
    """Raise on the dtypes, shapes and layouts the kernel does not take."""
    b, d = queries.shape if queries.dim() == 2 else (-1, -1)
    n = row.shape[1] if row.dim() == 2 else -1
    want = ((queries, torch.float32, (b, d)),
            (table, torch.float32, (table.shape[0], d)),
            (code_q, torch.int64, (b, codes.shape[-1])),
            (codes, torch.int64, (codes.shape[0], code_q.shape[-1])),
            (row, torch.int32, (b, n)),
            (eligible, torch.bool, (b, n)),
            (thr, torch.float32, (b,)))
    if tier is not None:
        cap = table.shape[0]
        want += ((tier[0], torch.bool, (cap,)),
                 (tier[1], torch.int8, (cap, d)),
                 (tier[2], torch.float32, (cap,)))
    for t, dtype, shape in want:
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(
                f"prefilter_gather: got {t.dtype}{tuple(t.shape)} where "
                f"{dtype}{shape} belongs (queries [B, d], table [cap, d], "
                "code_q [B, W], codes [cap, W], row and eligible [B, n], "
                "thr [B]; tier: resident [cap], qtable [cap, d], scales "
                "[cap])")
    if 0 in (codes.shape[0], codes.shape[1], table.shape[0]):
        raise ValueError(f"prefilter_gather: {codes.shape[1]} code words "
                         f"over {codes.shape[0]} rows, table "
                         f"{tuple(table.shape)}")


def prefilter_gather(queries: torch.Tensor, table: torch.Tensor,
                     code_q: torch.Tensor, codes: torch.Tensor,
                     row: torch.Tensor, eligible: torch.Tensor,
                     thr: torch.Tensor, *, tier=None):
    """The loop beam's fetch of one trip in one launch: the SimHash
    prefilter (Eq. 5-6) of the eligible ids of `row` against `thr`, and
    the squared L2 distance of every survivor's row.

    queries f32[Bq, d], table f32[cap, d], code_q int64[Bq, W], codes
    int64[cap, W], row int32[Bq, n], eligible bool[Bq, n], thr f32[Bq];
    `tier` None or (resident bool[cap], qtable int8[cap, d], scales
    f32[cap]) -> (fetch_mask bool[Bq, n], dists f32[Bq, n]), +inf where
    fetch_mask is False (`ref.prefilter_gather_ref`).  An eligible id
    must lie in [0, cap).  `prefilter_gather.launches` counts kernel
    launches, and `prefilter_gather.by_class` the same launches by lane:
    "f32" or "tier".
    """
    tensors = (queries, table, code_q, codes, row, eligible, thr) \
        + (tuple(tier) if tier is not None else ())
    devs = {t.device for t in tensors}
    if devs == {torch.device("cpu")}:
        return prefilter_gather_ref(queries, table, code_q, codes, row,
                                    eligible, thr, tier=tier)
    if len(devs) != 1 or queries.device.type != "cuda":
        raise ValueError(f"prefilter_gather: tensors on mixed devices {devs}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("prefilter_gather takes contiguous tensors")
    _check(queries, table, code_q, codes, row, eligible, thr, tier)
    b, d = queries.shape
    n = row.shape[1]
    words = codes.shape[1]
    mask = torch.empty((b, n), dtype=torch.bool, device=queries.device)
    dists = torch.empty((b, n), dtype=torch.float32, device=queries.device)
    if b * n == 0:
        return mask, dists
    vec4 = d % 4 == 0 and queries.data_ptr() % 16 == 0 \
        and table.data_ptr() % 16 == 0 \
        and (tier is None or tier[1].data_ptr() % 4 == 0)
    lanes = (0, 0, 0) if tier is None else tuple(t.data_ptr() for t in tier)
    with torch.cuda.device(queries.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(
            queries.data_ptr(), table.data_ptr(), code_q.data_ptr(),
            codes.data_ptr(), row.data_ptr(), eligible.data_ptr(),
            thr.data_ptr(), *lanes, mask.data_ptr(), dists.data_ptr(), b, n,
            d, words, 32 * words, table.shape[0], codes.shape[0], int(vec4),
            stream)
    _build.check(err, "prefilter_gather")
    prefilter_gather.launches += 1
    prefilter_gather.by_class["f32" if tier is None else "tier"] += 1
    _build.taken("prefilter_gather", "f32" if tier is None else "tier")
    return mask, dists


prefilter_gather.launches = 0
#: launches by lane ("f32", "tier"), reset with `launches`
prefilter_gather.by_class = Counter()
