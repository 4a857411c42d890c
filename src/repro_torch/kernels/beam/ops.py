"""Public wrapper of the fused beam-search megakernel.

CPU tensors take the plain version in `ref.py`; CUDA tensors launch the
kernel in `csrc/beam.cu`, or raise.  There is no fallback from one to
the other.  The operand contract is `repro.kernels.beam.ops`'s without
the 128-lane pad (a TPU layout constraint).
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.beam.ref import beam_iter_cap, beam_search_ref

__all__ = ["fused_beam_search", "beam_iter_cap"]

#: what the kernel takes: one warp per query holds its heap (twice), its
#: B*M block and its visited set in shared memory, at most 4 candidates a
#: lane
MAX_EF = 256
MAX_BLOCK = 128          # B * M
MAX_HASH_BITS = 15       # visited slots (128 KiB)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


_fn = None


def _kernel():
    """The kernel's C entry point, bound on first use."""
    global _fn
    if _fn is None:
        fn = _build.library("beam").beam_search_f32
        fn.argtypes = [_P] * 20 + [_I] * 12 + [_F, _F] + [_I] * 7 + [_P]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _hash_bits(iter_cap: int, block: int) -> int:
    """log2 of the visited set's slots: the set holds at most the entry
    and every fetched id, and stays at most half full."""
    need = 2 * (1 + iter_cap * block)
    return max(2, (need - 1).bit_length())


def _check(name, t, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"fused_beam_search: {name} must be {dtype}, got "
                        f"{t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"fused_beam_search: {name} has shape "
                         f"{tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"fused_beam_search: {name} must be contiguous")


def fused_beam_search(qs, entries, entry_dists, adjacency, vectors, codes,
                      code_qs, live, q_norms, mean_norm, returnable=None,
                      resident=None, qvecs=None, qscale=None, active=None,
                      *, ef, k, m_bits, eps, rho, max_iters, use_filter,
                      n_expand=1, record_heat=True):
    """Run the whole bottom-layer beam search for a query block.

    qs f32[Bq, dim]; entries int32[Bq]; entry_dists f32[Bq]; adjacency
    int32[cap, M] (resolved snapshot rows); vectors f32[cap, dim]; codes
    int64[cap, W]; code_qs int64[Bq, W]; live bool[cap] (routable mask);
    q_norms f32[Bq]; mean_norm f32[].  Optional lanes: `returnable`
    (lazy-delete repack), `resident`/`qvecs`/`qscale` (tier split),
    `active` (pad-lane masking).  Returns ``(ids, dists, stats,
    heat_nodes, heat_mask)`` with stats columns (n_adj, n_vec,
    n_filtered, n_hops).  `fused_beam_search.launches` counts kernel
    launches.
    """
    kw = dict(ef=ef, k=k, m_bits=m_bits, eps=eps, rho=rho,
              max_iters=max_iters, use_filter=use_filter,
              n_expand=n_expand, record_heat=record_heat)
    opt = dict(returnable=returnable, resident=resident, qvecs=qvecs,
               qscale=qscale, active=active)
    tensors = [qs, entries, entry_dists, adjacency, vectors, codes, code_qs,
               live, q_norms, mean_norm] + [t for t in opt.values()
                                             if t is not None]
    devs = {t.device for t in tensors}
    if devs == {torch.device("cpu")}:
        return beam_search_ref(qs, entries, entry_dists, adjacency, vectors,
                               codes, code_qs, live, q_norms, mean_norm,
                               **opt, **kw)
    if len(devs) != 1 or qs.device.type != "cuda":
        raise ValueError(f"fused_beam_search: tensors on mixed devices "
                         f"{devs}")

    tier = resident is not None
    if tier != (qvecs is not None) or tier != (qscale is not None):
        raise ValueError("fused_beam_search: the tier split needs "
                         "resident, qvecs and qscale together")
    if qs.dim() != 2 or adjacency.dim() != 2 or codes.dim() != 2:
        raise ValueError("fused_beam_search: qs, adjacency and codes must "
                         "be 2-D")
    bq, d = qs.shape
    cap, M = adjacency.shape
    W = codes.shape[1]
    f32, i32, b8 = torch.float32, torch.int32, torch.bool
    _check("qs", qs, f32, (bq, d))
    _check("entries", entries, i32, (bq,))
    _check("entry_dists", entry_dists, f32, (bq,))
    _check("adjacency", adjacency, i32, (cap, M))
    _check("vectors", vectors, f32, (cap, d))
    _check("codes", codes, torch.int64, (cap, W))
    _check("code_qs", code_qs, torch.int64, (bq, W))
    _check("live", live, b8, (cap,))
    _check("q_norms", q_norms, f32, (bq,))
    _check("mean_norm", mean_norm, f32, ())
    if returnable is not None:
        _check("returnable", returnable, b8, (cap,))
    if tier:
        _check("resident", resident, b8, (cap,))
        _check("qvecs", qvecs, torch.int8, (cap, d))
        _check("qscale", qscale, f32, (cap,))
    if active is not None:
        _check("active", active, b8, (bq,))
    if m_bits != 32 * W:
        raise ValueError(f"fused_beam_search: m_bits {m_bits} does not "
                         f"match {W} code words")
    B = max(1, min(n_expand, ef))
    iter_cap = beam_iter_cap(max_iters, n_expand, ef)
    hash_bits = _hash_bits(iter_cap, B * M)
    if not 1 <= k <= ef <= MAX_EF or B * M > MAX_BLOCK \
            or hash_bits > MAX_HASH_BITS:
        raise ValueError(
            f"fused_beam_search: the kernel takes 1 <= k <= ef <= "
            f"{MAX_EF}, B*M <= {MAX_BLOCK} and "
            f"1 + iter_cap*B*M <= {2 ** (MAX_HASH_BITS - 1)} visited ids; "
            f"got k={k}, ef={ef}, B*M={B * M}, iter_cap={iter_cap}")

    dev = qs.device
    ids = torch.empty((bq, ef), dtype=i32, device=dev)
    dists = torch.empty((bq, ef), dtype=f32, device=dev)
    stats = torch.empty((bq, 4), dtype=i32, device=dev)
    heat_nodes = torch.empty((bq, iter_cap * B), dtype=i32, device=dev)
    heat_mask = torch.empty((bq, iter_cap * B, M), dtype=b8, device=dev)
    if bq == 0:
        return ids, dists, stats, heat_nodes, heat_mask
    if active is None:
        active = torch.ones((bq,), dtype=b8, device=dev)
    vec4 = d % 4 == 0 and qs.data_ptr() % 16 == 0 \
        and vectors.data_ptr() % 16 == 0
    q8vec4 = tier and d % 4 == 0 and qs.data_ptr() % 16 == 0 \
        and qvecs.data_ptr() % 4 == 0
    slack = math.sqrt(m_bits * math.log(1.0 / eps) / 2.0) if use_filter \
        else 0.0
    sample = not (isinstance(rho, (int, float)) and rho >= 1.0)

    def ptr(t):
        return 0 if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel()(
            qs.data_ptr(), entries.data_ptr(), entry_dists.data_ptr(),
            adjacency.data_ptr(), vectors.data_ptr(), codes.data_ptr(),
            code_qs.data_ptr(), live.data_ptr(), q_norms.data_ptr(),
            mean_norm.data_ptr(), ptr(returnable), ptr(resident),
            ptr(qvecs), ptr(qscale), active.data_ptr(), ids.data_ptr(),
            dists.data_ptr(), stats.data_ptr(), heat_nodes.data_ptr(),
            heat_mask.data_ptr(), bq, d, cap, M, W, ef, k, B, iter_cap,
            max_iters, m_bits, hash_bits, float(rho), slack, int(vec4),
            int(q8vec4), int(tier), int(returnable is not None),
            int(record_heat), int(use_filter), int(sample), stream)
    _build.check(err, "fused_beam_search")
    fused_beam_search.launches += 1
    _build.taken("beam")
    return ids, dists, stats, heat_nodes, heat_mask


fused_beam_search.launches = 0
