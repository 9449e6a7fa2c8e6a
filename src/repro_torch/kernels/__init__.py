"""Hand-written CUDA kernels for Hopper (sm_90a), one package per kernel
family, each laid out as:

  csrc/*.cu  the CUDA C++ source, plain ``extern "C"`` entry points
  kernel.py  ctypes wrappers with launch counters (built by ``_build``)
  ref.py     the plain PyTorch versions
  ops.py     the public ops (precision policy, ``force_ref``)

Kernels:
  gram  G = H^T H and R = H^T T for m agents in one launch; the triangular
        kernel, the fused act(X W + b) producer, the int8 kernel (per-tile
        scales, int32 tile sums on the tensor cores) and the one-agent
        dense-tile baseline
  swa   causal sliding-window attention with an online softmax, GQA read in
        place, the kv walk limited to the window (the ``"swa"`` blocks)
  rglru the RG-LRU diagonal recurrence h_t = exp(log_a_t) h_{t-1} + b_t,
        one thread per channel walking time (the ``"rglru"`` blocks)
  mlstm the chunkwise mLSTM (matrix memory, stabilized exponential gates):
        a gate scan, the chunk states C^T tile by tile, the gated intra-chunk
        scores, then the outputs, four grids in one call (the ``"mlstm"``
        blocks)

``_common.py`` holds the checks every wrapper makes before it launches.
"""

from repro_torch.kernels.mlstm import mlstm_chunkwise

__all__ = ["mlstm_chunkwise"]
