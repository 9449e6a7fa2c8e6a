"""llava-next-34b — VLM: anyres-tiled vision patches prepended to a dense
decoder LM (Yi-34B-style backbone).
[hf:llava-hf/llava-v1.6-mistral-7b-hf (LLaVA-NeXT family card); 34B variant]

60L, d_model=7168, 56 heads (GQA kv=8), d_ff=20480, vocab=64000.
Vision frontend is a STUB per the brief: ``input_specs`` provides
precomputed, already-projected patch embeddings (anyres: 4 tiles + base
image x 576 patches = 2880 prefix positions).
"""

from repro_torch.models.config import ModelConfig

N_PATCHES = 2880  # 5 x 576 anyres tiling


def make_config(**overrides) -> ModelConfig:
    kw = dict(
        name="llava-next-34b",
        family="vlm",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20480,
        vocab_size=64000,
        block_pattern=("attn",),
        mlp_type="swiglu",
        rope_theta=5000000.0,
        n_prefix_embeddings=N_PATCHES,
        tie_embeddings=False,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def smoke_config() -> ModelConfig:
    return make_config(
        name="llava-next-34b-smoke",
        n_layers=2,
        d_model=128,
        n_heads=8,
        n_kv_heads=2,
        d_ff=256,
        vocab_size=512,
        n_prefix_embeddings=12,
        dtype="float32",
    )
