"""gemma-7b — dense decoder with GeGLU MLPs and wide heads (head_dim=256).
[arXiv:2403.08295 (Gemma)]

28L, d_model=3072, 16 heads (kv=16 == MHA; the 2b sibling uses MQA),
d_ff=24576, vocab=256000, embeddings scaled by sqrt(d_model).
"""

from repro_torch.models.config import ModelConfig


def make_config(**overrides) -> ModelConfig:
    kw = dict(
        name="gemma-7b",
        family="dense",
        n_layers=28,
        d_model=3072,
        n_heads=16,
        n_kv_heads=16,
        head_dim=256,
        d_ff=24576,
        vocab_size=256000,
        block_pattern=("attn",),
        mlp_type="geglu",
        rope_theta=10000.0,
        tie_embeddings=True,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def smoke_config() -> ModelConfig:
    return make_config(
        name="gemma-7b-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        dtype="float32",
    )
