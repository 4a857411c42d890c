"""Plain PyTorch versions of the SimHash kernels (`csrc/simhash.cu`).

A code word is held as the int64 value of the reference's uint32 word
(bit i of word w is projection 32w+i): PyTorch has no popcount and no
unsigned right shift, and in int64 a 32-bit word's bits never reach the
sign, so the SWAR bit count below is exact.

The projection signs are taken in f64: every f32 x f32 product is exact
there, so a sign can only depend on the order of the sum when the exact
dot product lies within an f64 rounding of zero, and the card and the
CPU agree (an f32 dot product near zero would flip bits between them).
"""

from __future__ import annotations

import torch

_M1 = 0x55555555
_M2 = 0x33333333
_M4 = 0x0F0F0F0F


def simhash_encode_ref(x: torch.Tensor, proj: torch.Tensor) -> torch.Tensor:
    """Pack sgn(x @ a_i) into words.  x [..., d], proj f32[m, d] ->
    int64[..., m/32], each word in [0, 2^32)."""
    m = proj.shape[0]
    if m % 32 != 0:
        raise ValueError("m_bits must be a multiple of 32 for word packing")
    bits = (x.double() @ proj.double().T) >= 0.0            # [..., m]
    bits = bits.reshape(*bits.shape[:-1], m // 32, 32).to(torch.int64)
    shifts = torch.arange(32, dtype=torch.int64, device=x.device)
    return (bits << shifts).sum(-1)


def popcount(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word held in an int64 tensor (SWAR)."""
    w = words - ((words >> 1) & _M1)
    w = (w & _M2) + ((w >> 2) & _M2)
    w = (w + (w >> 4)) & _M4
    return ((w * 0x01010101) >> 24) & 0xFF


def collisions(code_q: torch.Tensor, code_u: torch.Tensor,
               m_bits: int) -> torch.Tensor:
    """#Col(q, u) = m_bits - popcount(q ^ u) (Eq. 5), broadcast over the
    leading dims.  code_*: int64[..., W] -> int32[...]"""
    ham = popcount(code_q ^ code_u).sum(-1)
    return (m_bits - ham).to(torch.int32)


def collision_count_ref(codes_q: torch.Tensor, codes_c: torch.Tensor,
                        m_bits: int) -> torch.Tensor:
    """All pairs: codes_q int64[Q, W] x codes_c int64[N, W] -> int32[Q, N]."""
    return collisions(codes_q[:, None, :], codes_c[None, :, :], m_bits)


def collision_count_rows_ref(code_q: torch.Tensor, codes: torch.Tensor,
                             ids: torch.Tensor, m_bits: int) -> torch.Tensor:
    """Gathered: code_q int64[Q, W] against the rows `codes[ids]` of a
    table int64[cap, W], ids int32[Q, n] -> int32[Q, n].  Ids outside
    [0, cap) are clamped into it (the caller masks their counts)."""
    rows = codes[ids.clamp(0, codes.shape[0] - 1).long()]     # [Q, n, W]
    return collisions(code_q[:, None, :], rows, m_bits)
