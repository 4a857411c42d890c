"""Sign-random-projection (SimHash) codes and the Hoeffding filter (§3.3).

Encoding (Eq. 4):   Hash(x) = [sgn(x·a_1), ..., sgn(x·a_m)],  a_i ~ N(0, I)
Collisions (Eq. 5): #Col(q,u) = m - popcount(bits_q XOR bits_u)
Filter (Eq. 6):     evaluate u iff #Col(q,u) >= T_eps,
                    T_eps = m (1 - theta_delta / pi) - sqrt(m ln(1/eps) / 2)

Codes pack 32 projections per word in the reference's order (bit i of
word w is projection 32w+i), each word held as the int64 value of the
reference's uint32 word.  Encoding runs through the `simhash_encode`
kernel (`kernels/simhash`), whose signs are taken in f64 so that the
card and the CPU agree; the traversal's prefilter counts collisions
through `collision_count_rows`.  `collisions` is the plain broadcast
form, for the filter below and the beam kernel's plain version.

The arccos of the threshold is computed in f64 and rounded once to
f32, so thresholds come out the same on the CPU and on the card (a
last-place difference in an f32 arccos would flip a decision).
"""

from __future__ import annotations

import math

import torch

from repro_torch.kernels.simhash.ops import simhash_encode
from repro_torch.kernels.simhash.ref import (  # noqa: F401 (re-exported)
    collisions,
    popcount,
)


def encode(proj: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Pack sgn(x @ a_i) into words.  proj f32[m, dim], x [..., dim] ->
    int64[..., m/32], each word in [0, 2^32)."""
    codes = simhash_encode(x.reshape(-1, x.shape[-1]).to(torch.float32)
                           .contiguous(), proj.contiguous())
    return codes.reshape(*x.shape[:-1], codes.shape[-1])


def collision_probability(cos_sim: torch.Tensor) -> torch.Tensor:
    """P[one SimHash bit collides] = 1 - angle / pi."""
    theta = torch.acos(torch.clamp(cos_sim, -1.0, 1.0).double()).float()
    # a tensor divisor: PyTorch's CUDA division by a host scalar multiplies
    # by its reciprocal, which rounds differently from the CPU's division;
    # made on the device, so no host→device copy
    pi = torch.full((), math.pi, dtype=torch.float32, device=theta.device)
    return 1.0 - theta / pi


def hoeffding_threshold(m_bits: int, eps: float,
                        cos_sim: torch.Tensor) -> torch.Tensor:
    """T_eps: minimum collisions a <=delta candidate clears w.p. >= 1-eps."""
    p = collision_probability(cos_sim)
    slack = math.sqrt(m_bits * math.log(1.0 / eps) / 2.0)
    return p * m_bits - slack


def cos_from_l2(delta_sq: torch.Tensor, q_norm: torch.Tensor,
                u_norm: torch.Tensor) -> torch.Tensor:
    """cos(q,u) implied by squared L2 distance delta^2 and the two norms:
    cos = (|q|^2 + |u|^2 - delta^2) / (2 |q| |u|), clipped to [-1, 1]."""
    denom = torch.clamp_min(2.0 * q_norm * u_norm, 1e-12)
    return torch.clamp((q_norm ** 2 + u_norm ** 2 - delta_sq) / denom,
                       -1.0, 1.0)


def filter_mask(proj: torch.Tensor, code_q: torch.Tensor,
                codes_u: torch.Tensor, eps: float, delta_sq: torch.Tensor,
                q_norm: torch.Tensor, mean_norm: torch.Tensor) -> torch.Tensor:
    """Eq. (6): True where the candidate must be evaluated (fetched).

    code_q: int64[W]; codes_u: int64[n, W] -> bool[n]
    """
    m_bits = proj.shape[0]
    cols = collisions(code_q[None, :], codes_u, m_bits)
    cos = cos_from_l2(delta_sq, q_norm, mean_norm)
    thr = hoeffding_threshold(m_bits, eps, cos)
    return cols.to(torch.float32) >= thr
