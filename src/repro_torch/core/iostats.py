"""I/O accounting + the paper's cost model (Eq. 7-9).

The traversal counts *accesses*, not seconds: adjacency rows read from
the LSM tree (`n_adj`, each pays `t_n`), full vectors fetched from the
slow tier (`n_vec`, each pays `t_v`), neighbors the SimHash filter
skipped (`n_filtered`, the saving Delta of Eq. 9) and beam expansions
(`n_hops`).  Fields are int32 tensors: scalars, or one entry per query
lane for a batched search.

Two cost models: `DISK`, the paper's hardware (NVMe 4 KB random
reads), and `h100_hbm_model`, the card's memory (row bytes over the
H100's HBM rate), which stands where the reference's TPU-memory model
does.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class IOStats(NamedTuple):
    n_adj: torch.Tensor        # adjacency-row (neighbor list) reads
    n_vec: torch.Tensor        # full-vector fetches from the slow tier
    n_filtered: torch.Tensor   # neighbor evaluations skipped by sampling
    n_hops: torch.Tensor       # beam expansions (visited nodes T)

    @staticmethod
    def zero(device=None) -> "IOStats":
        z = torch.zeros((), dtype=torch.int32, device=device)
        return IOStats(z, z, z, z)

    def __add__(self, other: "IOStats") -> "IOStats":
        return IOStats(*(a + b for a, b in zip(self, other)))

    def total(self) -> "IOStats":
        """Sum over query lanes (int32, like the reference's jnp.sum)."""
        return IOStats(*(a.sum().to(torch.int32) for a in self))


class CostModel(NamedTuple):
    t_n: float   # seconds per neighbor-list fetch
    t_v: float   # seconds per vector fetch


# NVMe random 4KB read ~= 100 us; neighbor lists are similar-size reads.
DISK = CostModel(t_n=100e-6, t_v=100e-6)


def h100_hbm_model(dim: int, row_width: int,
                   bw_bytes: float = 3.35e12) -> CostModel:
    """Cost model for the NVIDIA H100 SXM (80 GB HBM3): bytes moved over
    the card's memory rate, 3.35 TB/s by NVIDIA's data sheet."""
    return CostModel(t_n=row_width * 4 / bw_bytes, t_v=dim * 4 / bw_bytes)


def search_cost(stats: IOStats, model: CostModel) -> torch.Tensor:
    """Eq. 7/8: T * t_n + (fetched vectors) * t_v."""
    return stats.n_adj * model.t_n + stats.n_vec * model.t_v


def sampling_saving(stats: IOStats, model: CostModel) -> torch.Tensor:
    """Eq. 9: Delta = (skipped vector fetches) * t_v."""
    return stats.n_filtered * model.t_v
