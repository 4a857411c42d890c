"""Hand-written CUDA kernels for the port, one package per kernel.

Each package mirrors `repro.kernels.<name>`:
  ref.py — the plain PyTorch version (the CPU route and the oracle)
  ops.py — the public wrapper: CPU tensors go to `ref.py`, CUDA tensors
           launch the kernel in `csrc/<name>.cu` (built by `_build.py`)
"""
