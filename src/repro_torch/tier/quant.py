"""Scalar quantizer for the cold lane (a copy of `repro.tier.quant`).

Per-row absmax int8: ``scale = max|x| / 127``, ``q = round(x / scale)``
(half to even, as `jnp.round`).  One f32 scale per row, so a cold row
costs ``dim + 4`` bytes against ``4 * dim`` dense.  Symmetric and
zero-preserving: an all-zero row round-trips exactly (the scale clamps
to a tiny epsilon instead of dividing by zero).

The scale is ``absmax * f32(1/127)``, a product with the rounded
reciprocal: that is what the reference computes when its quantizer runs
compiled (XLA rewrites a division by a constant into that product), as
it does in `tier_maintain`; run op by op it divides instead, and 4-5 %
of the scales differ in the last place.  The code division takes a
tensor divisor: PyTorch's CUDA division by a host scalar multiplies by
its reciprocal, which would round differently from the CPU's division.
"""

from __future__ import annotations

import numpy as np
import torch

# Rows quantize to [-127, 127] (not -128) so the lane is symmetric and
# negation of a vector negates its codes exactly.
_QMAX = 127.0
_EPS = 1e-12
_INV_QMAX = float(np.float32(1.0) / np.float32(_QMAX))


def quantize_rows(rows: torch.Tensor):
    """f32 [n, d] -> (int8 codes [n, d], f32 scales [n])."""
    absmax = rows.abs().amax(-1)
    scale = torch.clamp_min(absmax * _INV_QMAX, _EPS).to(torch.float32)
    q = torch.clamp(torch.round(rows / scale[..., None]), -_QMAX, _QMAX)
    return q.to(torch.int8), scale


def dequantize_rows(codes: torch.Tensor, scales: torch.Tensor):
    """(int8 [n, d], f32 [n]) -> f32 [n, d] reconstruction."""
    return codes.to(torch.float32) * scales[..., None]
