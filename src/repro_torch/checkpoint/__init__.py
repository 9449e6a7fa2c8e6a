"""Checkpoints of consensus runs, in the reference's on-disk layout."""

from repro_torch.checkpoint.checkpoint import (
    latest_step,
    load_checkpoint,
    read_meta,
    save_checkpoint,
)
from repro_torch.checkpoint.runstate import (
    load_run_checkpoint,
    remap_membership,
    run_checkpointed,
    save_run_checkpoint,
)

__all__ = [
    "latest_step",
    "load_checkpoint",
    "read_meta",
    "save_checkpoint",
    "load_run_checkpoint",
    "remap_membership",
    "run_checkpointed",
    "save_run_checkpoint",
]
