"""Model configuration: the port's own copy of the reference's
``ModelConfig`` (``repro/models/config.py``), field for field, so that a
configuration reads the same in both packages."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0           # 0 -> d_model // n_heads

    # --- block layout ----------------------------------------------------
    # The layer stack cycles through `block_pattern`; n_layers need not be a
    # multiple of the cycle (the remainder follows the full cycles).  Kinds:
    #   "attn"   global causal attention + MLP
    #   "swa"    sliding-window causal attention + MLP
    #   "moe"    attention + MoE FFN
    #   "mlstm"  xLSTM matrix-memory block
    #   "slstm"  xLSTM scalar-memory block
    #   "rglru"  Griffin RG-LRU recurrent block + MLP
    block_pattern: Tuple[str, ...] = ("attn",)

    # --- attention ---------------------------------------------------------
    sliding_window: int = 4096
    kv_quant: bool = False
    qk_norm: bool = False
    rope_theta: float = 10000.0
    logits_softcap: Optional[float] = None
    attn_softcap: Optional[float] = None

    # --- mlp -----------------------------------------------------------
    mlp_type: str = "swiglu"    # swiglu | geglu | gelu

    # --- moe ------------------------------------------------------------
    n_experts: int = 0
    n_experts_active: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.5
    router_aux_weight: float = 0.01
    moe_impl: str = "gspmd"

    # --- recurrent families ----------------------------------------------
    d_rnn: int = 0              # rglru width (defaults to d_model)
    conv1d_width: int = 4
    rglru_c: float = 8.0
    mlstm_proj_factor: float = 2.0
    slstm_proj_factor: float = 4.0 / 3.0
    chunk_size: int = 64

    # --- encoder-decoder (audio) ------------------------------------------
    n_enc_layers: int = 0       # >0 => encoder-decoder
    enc_seq: int = 0

    # --- multimodal stub frontends -----------------------------------------
    n_prefix_embeddings: int = 0

    # --- misc ----------------------------------------------------------
    remat: bool = False
    unroll_cycles: bool = False
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    dtype: str = "bfloat16"     # compute dtype; weights are fp32 masters
    elm_rank: int = 0
    elm_n_tasks: int = 0
    elm_d_out: int = 0

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        if self.d_rnn == 0:
            object.__setattr__(self, "d_rnn", self.d_model)
        if self.n_heads % self.n_kv_heads != 0:
            raise ValueError("n_heads must be a multiple of n_kv_heads")

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    def layer_kinds(self) -> Tuple[str, ...]:
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))
