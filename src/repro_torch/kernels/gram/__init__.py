from repro_torch.kernels.gram.ops import gram, gram_batched, gram_fused

__all__ = ["gram", "gram_batched", "gram_fused"]
