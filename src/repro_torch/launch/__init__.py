"""Launch layer: the assigned input shapes and the training driver."""
