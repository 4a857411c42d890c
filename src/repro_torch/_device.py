"""Device resolution, batch uploads, and the counted host read of the
port's loops."""

from __future__ import annotations

import numpy as np
import torch


def resolve(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for the CPU.  Raises when CUDA is asked for (or defaulted to) and no
    card is present — the port never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch route on the CPU")
    return dev


def upload(x, device: torch.device) -> torch.Tensor:
    """A host array or tensor on `device`, copied without blocking the
    host.  A blocking copy would wait on the stream, which the sync
    sentinel's CUDA layer counts as a sync; from pageable memory the
    non-blocking copy still reads the source before it returns."""
    t = torch.from_numpy(x) if isinstance(x, np.ndarray) else x
    return t.to(device, non_blocking=True)


def host_any(mask: torch.Tensor) -> bool:
    """`mask.any()` read on the host.  This is the one device→host sync
    of a data-dependent loop trip (beam search, greedy descent); every
    call adds one to `host_any.syncs` so a run can count them.  Its
    callers declare it (`core.sentinel.declared_sync`): "loop-trip
    exit" and "greedy-descent step"."""
    host_any.syncs += 1
    return bool(mask.any())


host_any.syncs = 0
