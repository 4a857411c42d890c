"""LSM-VEC core on PyTorch: the counterparts of `repro.core`.

- lsm        — functional LSM-tree storing bottom-layer adjacency
- simhash    — sign-random-projection codes + Hoeffding filter (Eq. 4-6)
- hnsw       — hybrid memory/disk hierarchical graph (Alg. 1, lazy delete)
- traversal  — sampling-guided beam search (§3.3), batched over queries
- iostats    — the paper's I/O cost model (Eq. 7-9)
- backend    — typed results and search knobs
- index      — LSMVecIndex, the single-device index
"""
