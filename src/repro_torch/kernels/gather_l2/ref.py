"""Plain PyTorch version of the gather + squared-L2 kernel."""

from __future__ import annotations

import torch


def gather_l2_ref(queries: torch.Tensor, table: torch.Tensor,
                  ids: torch.Tensor) -> torch.Tensor:
    """Fetch table rows by id and return squared L2 distance to each query.

    queries [B, d], table [N, d], ids int32[B, K] -> dists f32[B, K].
    Negative ids are "skip" sentinels (filtered-out neighbors); their
    distance is +inf.
    """
    q = queries.to(torch.float32)
    safe = ids.clamp_min(0).long()
    rows = table[safe].to(torch.float32)                # [B, K, d]
    diff = rows - q[:, None, :]
    d2 = (diff * diff).sum(-1)
    return torch.where(ids >= 0, d2, torch.inf)
