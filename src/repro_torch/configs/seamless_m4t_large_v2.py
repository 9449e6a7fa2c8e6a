"""seamless-m4t-large-v2 — audio encoder-decoder (speech-to-text backbone).
[arXiv:2308.11596 (SeamlessM4T)]

24L total = 12 encoder + 12 decoder, d_model=1024, 16 heads (kv=16 == MHA),
d_ff=8192, vocab=256206, LayerNorm + GELU MLPs (fairseq-style).
Audio frontend (mel-spectrogram + conformer feature extractor) is a STUB per
the brief: ``input_specs`` provides precomputed frame embeddings
(B, enc_seq, d_model) consumed by the encoder.
"""

from repro_torch.models.config import ModelConfig

ENC_FRAMES = 1024  # ~20s of speech at 50 frames/s after downsampling


def make_config(**overrides) -> ModelConfig:
    kw = dict(
        name="seamless-m4t-large-v2",
        family="audio",
        n_layers=12,           # decoder layers
        n_enc_layers=12,       # encoder layers (24 total per assignment)
        enc_seq=ENC_FRAMES,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=8192,
        vocab_size=256206,
        block_pattern=("attn",),
        mlp_type="gelu",
        tie_embeddings=True,
    )
    kw.update(overrides)
    return ModelConfig(**kw)


def smoke_config() -> ModelConfig:
    return make_config(
        name="seamless-m4t-large-v2-smoke",
        n_layers=2,
        n_enc_layers=2,
        enc_seq=16,
        d_model=128,
        n_heads=4,
        n_kv_heads=4,
        d_ff=256,
        vocab_size=512,
        dtype="float32",
    )
