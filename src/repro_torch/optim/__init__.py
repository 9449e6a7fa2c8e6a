"""AdamW with global-norm clipping, and learning-rate schedules."""

from repro_torch.optim.adamw import (
    AdamWConfig,
    AdamWState,
    adamw_init,
    adamw_update,
    global_norm,
    tree_leaves,
    tree_map,
)
from repro_torch.optim.schedules import cosine_warmup

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "cosine_warmup", "global_norm", "tree_leaves", "tree_map"]
