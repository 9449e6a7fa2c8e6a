"""h2o-danube-3-4b — dense decoder, llama+mistral mix with sliding-window
attention. [arXiv:2401.16818 (H2O-Danube series model report)]

24L, d_model=3840, 32 heads (GQA kv=8), d_ff=10240, vocab=32000, SWA.
"""

from repro_torch.models.config import ModelConfig


def make_config(**overrides) -> ModelConfig:
    kw = dict(
        name="h2o-danube-3-4b",
        family="dense",
        n_layers=24,
        d_model=3840,
        n_heads=32,
        n_kv_heads=8,
        d_ff=10240,
        vocab_size=32000,
        block_pattern=("swa",),
        sliding_window=4096,
        mlp_type="swiglu",
        rope_theta=500000.0,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def smoke_config() -> ModelConfig:
    return make_config(
        name="h2o-danube-3-4b-smoke",
        n_layers=2,
        d_model=128,
        n_heads=4,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        sliding_window=16,
        dtype="float32",
    )
