from repro_torch.kernels.swa.ops import swa_attention

__all__ = ["swa_attention"]
