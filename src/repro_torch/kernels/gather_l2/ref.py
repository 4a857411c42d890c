"""Plain PyTorch versions of the gather + squared-L2 kernels (f32 rows
and the int8 cold lane).

Each sums a row's squares in the order the CUDA kernels do
(`csrc/row_dist.cuh`), so the plain versions and the kernels return the
same bits on float data too, and the plain route on the CPU decides
exactly as the card does: 32 lanes each take a lane-strided share of
the row (groups of four consecutive elements where d % 4 == 0, single
elements otherwise, whatever width the kernel loads with), accumulate it with fused
multiply-adds (what nvcc makes of ``acc += x * x``; here the product is
exact in f64 and the sum rounds once to f32 — twice, in f64 then f32,
in the rare case the exact sum needs more than 53 bits), and a halving
tree adds the 32 partial sums (the kernels' butterfly of shuffles).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _warp_sq_sum(diff: torch.Tensor) -> torch.Tensor:
    """sum(diff ** 2, -1) in the kernels' order (module docstring)."""
    lead, d = diff.shape[:-1], diff.shape[-1]
    width = 4 if d % 4 == 0 else 1
    trips = max(1, -(-d // (32 * width)))
    x = F.pad(diff, (0, trips * 32 * width - d)).reshape(
        *lead, trips, 32, width).double()
    acc = torch.zeros(lead + (32,), dtype=torch.float32, device=diff.device)
    for t in range(trips):
        for c in range(width):
            v = x[..., t, :, c]
            acc = (v * v + acc.double()).to(torch.float32)
    while acc.shape[-1] > 1:
        half = acc.shape[-1] // 2
        acc = acc[..., :half] + acc[..., half:]
    return acc[..., 0]


def gather_l2_ref(queries: torch.Tensor, table: torch.Tensor,
                  ids: torch.Tensor) -> torch.Tensor:
    """Fetch table rows by id and return squared L2 distance to each query.

    queries [B, d], table [N, d], ids int32[B, K] -> dists f32[B, K].
    Negative ids are "skip" sentinels (filtered-out neighbors); their
    distance is +inf.
    """
    q = queries.to(torch.float32)
    safe = ids.clamp_min(0).long()
    # queries in chunks of about 2^22 gathered elements, so a large call
    # (a pairwise block of the update paths) stays small in memory
    step = max(1, (1 << 22) // max(1, ids.shape[1] * q.shape[1]))
    d2 = torch.empty(ids.shape, dtype=torch.float32, device=q.device)
    for s in range(0, q.shape[0], step):
        rows = table[safe[s:s + step]].to(torch.float32)   # [b, K, d]
        d2[s:s + step] = _warp_sq_sum(q[s:s + step, None, :] - rows)
    return torch.where(ids >= 0, d2, torch.inf)


def gather_l2_q8_ref(queries: torch.Tensor, qtable: torch.Tensor,
                     scales: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Cold-lane variant: fused dequantize + squared L2.

    queries [B, d], qtable int8[N, d], scales f32[N], ids int32[B, K]
    -> dists f32[B, K].  Row i reconstructs as ``qtable[i] * scales[i]``
    (per-row absmax scalar quantization, see `repro_torch.tier.quant`),
    the product rounded before the difference.  Negative ids yield +inf,
    the same contract as `gather_l2_ref`.
    """
    q = queries.to(torch.float32)
    safe = ids.clamp_min(0).long()
    rows = qtable[safe].to(torch.float32) * scales[safe][..., None]
    d2 = _warp_sq_sum(q[:, None, :] - rows)
    return torch.where(ids >= 0, d2, torch.inf)
