"""Comparison systems from the paper's evaluation (§5.1), on PyTorch —
the counterparts of `repro.core.baselines`.

- diskann.py — DiskANN-like static pruned-graph index: offline build, beam
  search with exhaustive neighbor evaluation, append-style inserts and
  tombstone deletes (the degradation modes §2.2 describes).
- spfresh.py — SPFresh-like clustering index: coarse IVF partitions,
  in-place posting updates with split maintenance (LIRE-style), probe-P
  search.

Both keep the reference's host numpy loops and random draws; their dense
distance blocks go through the `l2_distance` kernel on the baseline's
device, the card unless the caller passes ``device="cpu"``.
"""

from repro_torch.core.baselines.diskann import DiskANNIndex
from repro_torch.core.baselines.spfresh import SPFreshIndex

__all__ = ["DiskANNIndex", "SPFreshIndex"]
