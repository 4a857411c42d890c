"""LSM-VEC on PyTorch and CUDA: the port of `repro` to an NVIDIA H100.

The layout mirrors `src/repro/` module for module, so each counterpart
is found under the same name.  The package imports `torch` and numpy,
never JAX or `repro`: `src/repro/` stays the reference the tests hold
this package against.  Entry points run on the card unless the caller
passes ``device="cpu"``; kernels build from `kernels/csrc/` at first
use.
"""
