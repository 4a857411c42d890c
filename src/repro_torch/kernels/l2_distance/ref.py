"""Plain PyTorch version of the dense squared-L2 kernel."""

from __future__ import annotations

import torch


def l2_distance_ref(queries: torch.Tensor,
                    candidates: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances.  queries [Q, d], candidates [N, d] -> [Q, N].

    The same decomposition as the kernel, |q|^2 + |c|^2 - 2 q.c, clamped
    at 0, in f32.
    """
    q = queries.to(torch.float32)
    c = candidates.to(torch.float32)
    q2 = (q * q).sum(-1, keepdim=True)                 # [Q, 1]
    c2 = (c * c).sum(-1, keepdim=True).T               # [1, N]
    cross = q @ c.T                                    # [Q, N]
    return torch.clamp_min(q2 + c2 - 2.0 * cross, 0.0)
