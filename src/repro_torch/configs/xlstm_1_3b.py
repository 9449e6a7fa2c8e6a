"""xlstm-1.3b — attention-free xLSTM stack (sLSTM + mLSTM blocks).
[arXiv:2405.04517 (xLSTM)]

48L, d_model=2048, 4 heads, vocab=50304, d_ff=0 (blocks carry internal
projections: mLSTM up-factor 2, sLSTM post-FFN factor 4/3). Block ratio
7 mLSTM : 1 sLSTM per cycle (the paper's sparse-sLSTM placement).
"""

from repro_torch.models.config import ModelConfig

PATTERN = ("mlstm",) * 7 + ("slstm",)


def make_config(**overrides) -> ModelConfig:
    kw = dict(
        name="xlstm-1.3b",
        family="ssm",
        n_layers=48,
        d_model=2048,
        n_heads=4,
        n_kv_heads=4,
        d_ff=0,
        vocab_size=50304,
        block_pattern=PATTERN,
        # 256-step chunks: 4x fewer (B, H, 1024, 1024) chunk states than
        # 64-step ones, and larger products per chunk.
        chunk_size=256,
        tie_embeddings=True,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def smoke_config() -> ModelConfig:
    return make_config(
        name="xlstm-1.3b-smoke",
        n_layers=2,
        block_pattern=("mlstm", "slstm"),
        d_model=128,
        n_heads=4,
        vocab_size=512,
        chunk_size=8,
        dtype="float32",
    )
