"""Training step: next-token cross-entropy and AdamW."""

from repro_torch.training.steps import (
    loss_and_grads,
    loss_fn,
    make_train_step,
    train_step,
)

__all__ = ["loss_and_grads", "loss_fn", "make_train_step", "train_step"]
