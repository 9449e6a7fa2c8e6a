"""qwen3-8b — dense decoder with QK-norm and GQA. [hf:Qwen/Qwen3-8B]

36L, d_model=4096, 32 heads (GQA kv=8), head_dim=128, d_ff=12288,
vocab=151936.
"""

from repro_torch.models.config import ModelConfig


def make_config(**overrides) -> ModelConfig:
    kw = dict(
        name="qwen3-8b",
        family="dense",
        n_layers=36,
        d_model=4096,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=12288,
        vocab_size=151936,
        block_pattern=("attn",),
        qk_norm=True,
        mlp_type="swiglu",
        rope_theta=1000000.0,
        tie_embeddings=False,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def smoke_config() -> ModelConfig:
    return make_config(
        name="qwen3-8b-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        dtype="float32",
    )
