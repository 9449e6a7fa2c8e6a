"""granite-moe-3b-a800m — compact MoE decoder, top-8 routing.
[hf:ibm-granite/granite-3.0-1b-a400m-base (Granite-3.0 MoE family); 3B/800M
sibling]

32L, d_model=1536, 24 heads (GQA kv=8), expert d_ff=512, vocab=49155,
40 experts top-8 (assignment spec column; the family card's smaller sibling
uses 32 — we follow the per-arch spec line).
"""

from repro_torch.models.config import ModelConfig


def make_config(**overrides) -> ModelConfig:
    kw = dict(
        name="granite-moe-3b-a800m",
        family="moe",
        n_layers=32,
        d_model=1536,
        n_heads=24,
        n_kv_heads=8,
        d_ff=0,
        moe_d_ff=512,
        n_experts=40,
        n_experts_active=8,
        vocab_size=49155,
        block_pattern=("moe",),
        mlp_type="swiglu",
        rope_theta=10000.0,
        capacity_factor=1.25,
        tie_embeddings=True,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def smoke_config() -> ModelConfig:
    return make_config(
        name="granite-moe-3b-a800m-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        moe_d_ff=64,
        n_experts=4,
        n_experts_active=2,
        vocab_size=512,
        # drop-free capacity so decode == forward exactly in the smoke test
        capacity_factor=4.0,
        dtype="float32",
    )
