"""Synthetic data: SIFT-like clustered vectors (a copy of
`repro.data.synth.make_clustered_vectors`, numpy only).

A Gaussian mixture in d dims with values roughly in SIFT's dynamic
range.  Queries drawn with the same `center_seed` are in-distribution.
"""

from __future__ import annotations

import numpy as np


def make_clustered_vectors(n: int, dim: int = 128, seed: int = 0,
                           clusters: int = 64, center_seed: int = 123,
                           scale: float = 2.5,
                           noise: float = 1.0) -> np.ndarray:
    """SIFT-like clustered vectors, float32 [n, dim]."""
    crng = np.random.default_rng(center_seed)
    centers = crng.normal(0.0, scale, (clusters, dim))
    rng = np.random.default_rng(seed)
    asg = rng.integers(0, clusters, n)
    return (centers[asg] + rng.normal(0.0, noise, (n, dim))).astype(np.float32)
