"""Public wrappers of the SimHash kernels.

CPU tensors take the plain versions in `ref.py`; CUDA tensors launch the
kernels in `csrc/simhash.cu`, or raise.  There is no fallback from one
to the other.  Codes are int64 words holding the reference's uint32
values; ragged shapes are handled in the kernels, so nothing is padded.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.simhash.ref import (
    collision_count_ref,
    collision_count_rows_ref,
    simhash_encode_ref,
)

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: 16 query codes of `words` int64 words sit in a block's shared memory
_MAX_WORDS = 384


_fns: dict = {}


def _kernel(name: str, argtypes):
    """The C entry point `name`, bound on first use."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.library("simhash"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def _on_card(name: str, *tensors) -> bool:
    """True for CUDA tensors, False for CPU tensors; raises on mixed
    devices or non-contiguous tensors."""
    devs = {t.device for t in tensors}
    if devs == {torch.device("cpu")}:
        return False
    if len(devs) != 1 or tensors[0].device.type != "cuda":
        raise ValueError(f"{name}: tensors on mixed devices {devs}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} takes contiguous tensors")
    return True


def _check_codes(name: str, m_bits: int, *codes) -> int:
    words = codes[0].shape[-1]
    for c in codes:
        if c.dtype != torch.int64 or c.dim() != 2 or c.shape[1] != words:
            raise ValueError(f"{name}: codes must be int64[rows, {words}], "
                             f"got {c.dtype}{tuple(c.shape)}")
    if m_bits != 32 * words or not 1 <= words <= _MAX_WORDS:
        raise ValueError(f"{name}: m_bits {m_bits} does not match {words} "
                         f"code words (at most {_MAX_WORDS})")
    return words


def _launch(name: str, symbol: str, argtypes, device, *args) -> None:
    """Call `symbol` of the library with `args` and the current stream
    of `device`, raising on a failed launch."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(symbol, argtypes + [_P])(*args, stream)
    _build.check(err, name)


def simhash_encode(x: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """Sign bits of `x @ proj.T` packed 32 to a word: x f32[N, d], proj
    f32[m, d] -> int64[N, m/32] (bit i of word w is projection 32w+i).
    `simhash_encode.launches` counts kernel launches."""
    if not _on_card("simhash_encode", x, proj):
        return simhash_encode_ref(x, proj)
    if x.dtype != torch.float32 or proj.dtype != torch.float32:
        raise TypeError("simhash_encode takes f32 tensors, got "
                        f"{x.dtype}, {proj.dtype}")
    if x.dim() != 2 or proj.dim() != 2 or x.shape[1] != proj.shape[1] \
            or proj.shape[0] % 32 != 0 or proj.shape[0] // 32 > 65535:
        raise ValueError(
            f"simhash_encode: shapes x {tuple(x.shape)} and proj "
            f"{tuple(proj.shape)} do not match [N, d], [32 W, d]")
    n, d = x.shape
    words = proj.shape[0] // 32
    out = torch.empty((n, words), dtype=torch.int64, device=x.device)
    if n * words == 0:
        return out
    _launch("simhash_encode", "simhash_encode_f32",
            [_P, _P, _P, _L, _I, _I], x.device,
            x.data_ptr(), proj.data_ptr(), out.data_ptr(), n, d, words)
    simhash_encode.launches += 1
    _build.taken("simhash_encode")
    return out


simhash_encode.launches = 0


def collision_count(codes_q: torch.Tensor, codes_c: torch.Tensor,
                    m_bits: int) -> torch.Tensor:
    """Matching bits (Eq. 5) of every pair: codes_q int64[Q, W] x codes_c
    int64[N, W] -> int32[Q, N].  `collision_count.launches` counts kernel
    launches."""
    if not _on_card("collision_count", codes_q, codes_c):
        return collision_count_ref(codes_q, codes_c, m_bits)
    words = _check_codes("collision_count", m_bits, codes_q, codes_c)
    n_q, n_c = codes_q.shape[0], codes_c.shape[0]
    if n_q > 16 * 65535:
        raise ValueError(f"collision_count: {n_q} query codes exceed the "
                         "grid")
    out = torch.empty((n_q, n_c), dtype=torch.int32, device=codes_q.device)
    if n_q * n_c == 0:
        return out
    _launch("collision_count", "collision_count_i64",
            [_P, _P, _P, _I, _L, _I, _I], codes_q.device,
            codes_q.data_ptr(), codes_c.data_ptr(), out.data_ptr(), n_q,
            n_c, words, m_bits)
    collision_count.launches += 1
    _build.taken("collision_count")
    return out


collision_count.launches = 0


def collision_count_rows(code_q: torch.Tensor, codes: torch.Tensor,
                         ids: torch.Tensor, m_bits: int) -> torch.Tensor:
    """Matching bits of each query code against the table rows it names:
    code_q int64[Q, W], codes int64[cap, W], ids int32[Q, n] ->
    int32[Q, n].  Ids outside [0, cap) are clamped into it (the caller
    masks their counts).  `collision_count_rows.launches` counts kernel
    launches."""
    if not _on_card("collision_count_rows", code_q, codes, ids):
        return collision_count_rows_ref(code_q, codes, ids, m_bits)
    words = _check_codes("collision_count_rows", m_bits, code_q, codes)
    if ids.dtype != torch.int32 or ids.dim() != 2 \
            or ids.shape[0] != code_q.shape[0]:
        raise ValueError(f"collision_count_rows: ids must be int32[Q, n] "
                         f"for {code_q.shape[0]} queries, got "
                         f"{ids.dtype}{tuple(ids.shape)}")
    n_q, n = ids.shape
    out = torch.empty((n_q, n), dtype=torch.int32, device=ids.device)
    if n_q * n == 0:
        return out
    if codes.shape[0] == 0:
        raise ValueError("collision_count_rows: the code table is empty")
    _launch("collision_count_rows", "collision_count_rows_i64",
            [_P, _P, _P, _P, _I, _I, _I, _L, _I], ids.device,
            code_q.data_ptr(), codes.data_ptr(), ids.data_ptr(),
            out.data_ptr(), n_q, n, words, codes.shape[0], m_bits)
    collision_count_rows.launches += 1
    _build.taken("collision_count_rows")
    return out


collision_count_rows.launches = 0
