from repro_torch.kernels.mlstm.ops import mlstm_chunkwise

__all__ = ["mlstm_chunkwise"]
