"""Atomic checkpointing of flat array trees (the port's copy of
`repro.checkpoint`, numpy and torch only)."""

from repro_torch.checkpoint.ckpt import (
    latest_step,
    load_arrays,
    restore_checkpoint,
    save_checkpoint,
    sweep_stale_tmp,
)

__all__ = ["save_checkpoint", "restore_checkpoint", "latest_step",
           "load_arrays", "sweep_stale_tmp"]
