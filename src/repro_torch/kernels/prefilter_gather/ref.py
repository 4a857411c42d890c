"""Plain PyTorch version of `prefilter_gather` (`csrc/gather_l2.cu`).

One trip's fetch of the loop beam search: the SimHash prefilter (paper
Eq. 5-6) over a block of candidate ids, then the squared L2 distance of
every survivor's row.  It is the composition of the plain versions of
`collision_count_rows` and `gather_l2` (under the tier, `gather_l2_q8`
for the rows not resident, merged by an elementwise min as
`hnsw._tier_dist_fn` merges them), so its bits are theirs by
construction.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.gather_l2.ref import gather_l2_q8_ref, gather_l2_ref
from repro_torch.kernels.simhash.ref import collision_count_rows_ref


def prefilter_gather_ref(queries: torch.Tensor, table: torch.Tensor,
                         code_q: torch.Tensor, codes: torch.Tensor,
                         row: torch.Tensor, eligible: torch.Tensor,
                         thr: torch.Tensor, *, tier=None):
    """queries f32[Bq, d], table f32[cap, d], code_q int64[Bq, W], codes
    int64[cap, W], row int32[Bq, n], eligible bool[Bq, n], thr f32[Bq]
    (-inf keeps every eligible id) -> (fetch_mask bool[Bq, n], dists
    f32[Bq, n]).

    fetch_mask = eligible & (collisions >= thr): the counts are taken
    against the clamped row of each id, as `collision_count_rows_ref`
    takes them.  dists is +inf where fetch_mask is False, else the f32
    row's distance; with `tier` = (resident bool[cap], qtable int8[cap,
    d], scales f32[cap]), a non-resident id's comes from its int8 row.
    """
    m_bits = 32 * codes.shape[1]
    cols = collision_count_rows_ref(code_q, codes, row, m_bits)
    fetch_mask = eligible & (cols.to(torch.float32) >= thr[:, None])
    ids = torch.where(fetch_mask, row, -1)
    if tier is None:
        return fetch_mask, gather_l2_ref(queries, table, ids)
    resident, qtable, scales = tier
    res = resident[ids.clamp_min(0).long()]
    hot = torch.where((ids >= 0) & res, ids, -1)
    cold = torch.where((ids >= 0) & ~res, ids, -1)
    return fetch_mask, torch.minimum(
        gather_l2_ref(queries, table, hot),
        gather_l2_q8_ref(queries, qtable, scales, cold))
