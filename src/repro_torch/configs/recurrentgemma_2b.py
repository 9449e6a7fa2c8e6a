"""recurrentgemma-2b — Griffin hybrid: RG-LRU recurrent blocks + local
(sliding-window) attention in a 2:1 pattern. [arXiv:2402.19427 (Griffin)]

26L, d_model=2560, 10 heads (MQA kv=1, head_dim=256), d_ff=7680 (GeGLU),
vocab=256000, local-attention window 2048. 26 = 8 x (rglru, rglru, swa)
cycles + 2 trailing rglru blocks.
"""

from repro_torch.models.config import ModelConfig


def make_config(**overrides) -> ModelConfig:
    kw = dict(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256000,
        block_pattern=("rglru", "rglru", "swa"),
        sliding_window=2048,
        mlp_type="geglu",
        d_rnn=2560,
        conv1d_width=4,
        tie_embeddings=True,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def smoke_config() -> ModelConfig:
    return make_config(
        name="recurrentgemma-2b-smoke",
        n_layers=3,
        d_model=128,
        n_heads=2,
        n_kv_heads=1,
        head_dim=64,
        d_ff=256,
        vocab_size=512,
        sliding_window=16,
        d_rnn=128,
        dtype="float32",
    )
