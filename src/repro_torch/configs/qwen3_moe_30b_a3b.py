"""qwen3-moe-30b-a3b — MoE decoder: 128 experts, top-8, QK-norm GQA.
[hf:Qwen/Qwen3-30B-A3B]

48L, d_model=2048, 32 heads (GQA kv=4), head_dim=128, expert d_ff=768,
vocab=151936, every layer MoE.
"""

from repro_torch.models.config import ModelConfig


def make_config(**overrides) -> ModelConfig:
    kw = dict(
        name="qwen3-moe-30b-a3b",
        family="moe",
        n_layers=48,
        d_model=2048,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=0,
        moe_d_ff=768,
        n_experts=128,
        n_experts_active=8,
        vocab_size=151936,
        block_pattern=("moe",),
        qk_norm=True,
        mlp_type="swiglu",
        rope_theta=1000000.0,
        capacity_factor=1.25,
        tie_embeddings=False,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def smoke_config() -> ModelConfig:
    return make_config(
        name="qwen3-moe-30b-a3b-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        head_dim=32,
        moe_d_ff=64,
        n_experts=4,
        n_experts_active=2,
        vocab_size=512,
        # drop-free capacity so decode == forward exactly in the smoke test
        capacity_factor=4.0,
        dtype="float32",
    )
