"""Port parity: encoder-decoder models (seamless-m4t-large-v2's smoke
config: LayerNorm, a bidirectional encoder, cross-attention with ``ck``/
``cv`` caches) and prefix embeddings (llava-next-34b's smoke config), on
the CPU.

The reference's weights carry into the port through
``convert.model_from_numpy``, and the same numpy tokens, frame embeddings
and patch embeddings go through both packages.  ``layernorm`` and the
attention blocks agree within 1e-5; ``encode``, ``prefill`` and
``decode_step`` within 1e-4 of max |reference| in fp32 (fp32 caches) and
3e-2 in bf16 (bf16 caches).  A prefill's ``ck``/``cv`` take the memory's
own length F, also where F differs from ``enc_seq``.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test process: xdist's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.core import heads as jh  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.core import heads as th  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

MODELS = ["seamless-m4t-large-v2", "llava-next-34b"]
B, S = 2, 12
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-4),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _frontend(cfg, seed, frames=None):
    """The smoke config's stub frontend inputs as numpy: enc_embeds (B, F,
    d) for the audio family (F = enc_seq unless given), prefix_embeds (B,
    P, d) for the VLM."""
    rng = np.random.default_rng(seed)
    if cfg.family == "audio":
        f = cfg.enc_seq if frames is None else frames
        return {"enc_embeds": rng.standard_normal(
            (B, f, cfg.d_model)).astype(np.float32)}
    return {"prefix_embeds": rng.standard_normal(
        (B, cfg.n_prefix_embeddings, cfg.d_model)).astype(np.float32)}


# the reference's entry points, compiled once a config (eager JAX compiles
# each op at each new shape)
_j_prefill = jax.jit(jt.prefill, static_argnums=(1, 3),
                     static_argnames="cache_dtype")
_j_decode = jax.jit(jt.decode_step, static_argnums=1)


def _j(kw):
    return {k: jnp.asarray(v) for k, v in kw.items()}


def _t(kw):
    return {k: torch.tensor(v) for k, v in kw.items()}


@pytest.fixture(scope="module")
def models():
    """Per smoke config: (reference cfg, port cfg, reference params, port
    params, tokens (B, S), frontend inputs)."""
    out = {}
    for i, name in enumerate(MODELS):
        jc, tc = j_smoke(name), configs.get_smoke_config(name)
        jp = jt.init_model(jax.random.PRNGKey(i), jc)
        tp = convert.model_from_numpy(_np_tree(jp), tc, "cpu")
        tokens = np.random.default_rng(i).integers(0, jc.vocab_size, (B, S))
        out[name] = (jc, tc, jp, tp, tokens, _frontend(jc, 10 + i))
    return out


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_layernorm_matches_the_reference(dtype):
    """Population variance (``jnp.var``), in fp32, cast back."""
    jdt, tdt, _ = DTYPES[dtype]
    rng = np.random.default_rng(1)
    x = (3.0 + rng.standard_normal((2, 5, 64))).astype(np.float32)
    p = {"scale": rng.standard_normal(64).astype(np.float32),
         "bias": rng.standard_normal(64).astype(np.float32)}
    want = jl.layernorm(_j(p), jnp.asarray(x, jdt), 1e-6)
    got = tl.layernorm(_t(p), torch.tensor(x).to(tdt), 1e-6)
    assert got.dtype == tdt
    assert _rel(got, want) <= (1e-6 if dtype == "float32" else 1e-2)
    init = tl.layernorm_init(64, "cpu")
    assert torch.equal(init["scale"], torch.ones(64))
    assert torch.equal(init["bias"], torch.zeros(64))


@pytest.mark.parametrize("masked", [False, True])
def test_cross_attention_block_matches_the_reference(masked):
    """Cross-attention over 21 frames of memory (no RoPE; with a mask of
    valid frames per row), and the cross k and v a prefill caches."""
    jc, tc = (c(MODELS[0]) for c in (j_smoke, configs.get_smoke_config))
    jp = ja.attention_init(jax.random.PRNGKey(2), jc, cross=True)
    tp = convert._tree_tensors(_np_tree(jp), "cpu")
    assert "q_norm" not in tp
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, S, jc.d_model)).astype(np.float32)
    mem = rng.standard_normal((B, 21, jc.d_model)).astype(np.float32)
    valid = np.ones((B, 21), bool)
    if masked:
        valid[1, 13:] = False
    want = jax.jit(ja.cross_attention_block, static_argnums=1)(
        jp, jc, jnp.asarray(x), jnp.asarray(mem), jnp.asarray(valid))
    got = ta.cross_attention_block(tp, tc, torch.tensor(x), torch.tensor(mem),
                                   torch.tensor(valid) if masked else None)
    assert _rel(got, want) <= 1e-5
    _, jk, jv = ja._qkv(jp, jc, jnp.asarray(mem), jnp.zeros((B, 21), jnp.int32),
                        rope=False)
    k, v = ta.cross_kv(tp, tc, torch.tensor(mem))
    assert _rel(k, jk) <= 1e-6 and _rel(v, jv) <= 1e-6


def test_encoder_matches_the_reference(models):
    """The bidirectional encoder stack and ``enc_norm`` (RoPE on, no causal
    mask): the memory, and one encoder block alone."""
    jc, tc, jp, tp, _, fe = models[MODELS[0]]
    x = fe["enc_embeds"]
    want = jax.jit(jt._run_encoder, static_argnums=1)(jp, jc, jnp.asarray(x))
    assert _rel(tt.run_encoder(tp, tc, torch.tensor(x)), want) <= 1e-5
    pos = np.tile(np.arange(x.shape[1])[None], (B, 1))
    jblock = jax.tree.map(lambda a: a[0], jp["encoder"])
    jo = jt.cross_free_self_attention(jblock["attn"], jc, jnp.asarray(x),
                                      jnp.asarray(pos))
    to = ta.cross_free_self_attention(tp["encoder"][0]["attn"], tc,
                                      torch.tensor(x))
    assert _rel(to, jo) <= 1e-5


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", MODELS)
def test_encode_matches_the_reference(models, name, dtype):
    jc, tc, jp, tp, tokens, fe = models[name]
    jdt, tdt, tol = DTYPES[dtype]
    jc, tc = (dataclasses.replace(c, dtype=dtype) for c in (jc, tc))
    want = jax.jit(jt.encode, static_argnums=1)(jp, jc, jnp.asarray(tokens),
                                                **_j(fe))
    got = tt.encode(tp, tc, torch.tensor(tokens), **_t(fe))
    P = tc.n_prefix_embeddings if "prefix_embeds" in fe else 0
    assert got.shape == (B, P + S, tc.d_model) and got.dtype == tdt
    assert _rel(got, want) <= tol


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", MODELS)
def test_prefill_and_decode_match_the_reference(models, name, dtype):
    """Prefill (positions 0..P+S-1) and 3 decode steps from P + S, caches in
    the compute dtype, against the reference's; in fp32 also each step
    against the port's own forward over the whole sequence."""
    jc, tc, jp, tp, tokens, fe = models[name]
    jdt, tdt, tol = DTYPES[dtype]
    jc, tc = (dataclasses.replace(c, dtype=dtype) for c in (jc, tc))
    P = tc.n_prefix_embeddings if "prefix_embeds" in fe else 0
    max_len = P + S + 4
    jlg, jcache = _j_prefill(jp, jc, jnp.asarray(tokens), max_len,
                             cache_dtype=jdt, **_j(fe))
    lg, cache = tt.prefill(tp, tc, torch.tensor(tokens), max_len,
                           cache_dtype=tdt, **_t(fe))
    assert cache["pos"].tolist() == [P + S] * B
    assert _rel(lg, jlg) <= tol
    seq = torch.tensor(tokens)
    for _ in range(3):
        nt = lg[:, -1].argmax(-1, keepdim=True)
        jlg, jcache = _j_decode(jp, jc, jnp.asarray(nt.numpy(), jnp.int32),
                                jcache)
        lg, cache = tt.decode_step(tp, tc, nt, cache)
        assert _rel(lg, jlg) <= tol
        seq = torch.cat([seq, nt], dim=1)
        if dtype == "float32":
            full, _ = tt.forward(tp, tc, seq, **_t(fe))
            assert _rel(lg[:, 0], full[:, -1]) <= tol


def test_cross_cache_takes_the_memory_length(models):
    """``enc_embeds`` of F = 10 frames where ``enc_seq`` is 16: the prefill
    writes ``ck``/``cv`` of 10 slots (``init_cache`` sizes them by
    enc_seq), equal to the cross k and v of the encoder memory cast to the
    cache dtype, and decoding from them agrees with the reference's, which
    also takes the memory's F."""
    jc, tc, jp, tp, tokens, _ = models[MODELS[0]]
    fe = _frontend(jc, 3, frames=10)
    jlg, jcache = _j_prefill(jp, jc, jnp.asarray(tokens), S + 2,
                             cache_dtype=jnp.bfloat16, **_j(fe))
    lg, cache = tt.prefill(tp, tc, torch.tensor(tokens), S + 2, **_t(fe))
    memory = tt.run_encoder(tp, tc, torch.tensor(fe["enc_embeds"]))
    for layer, entry in zip(tp["layers"], cache["layers"]):
        assert entry["ck"].shape == (B, 10, tc.n_kv_heads, tc.head_dim)
        assert entry["ck"].dtype == torch.bfloat16
        k, v = ta.cross_kv(layer["cross"], tc, memory)
        assert torch.equal(entry["ck"], k.to(torch.bfloat16))
        assert torch.equal(entry["cv"], v.to(torch.bfloat16))
    assert _rel(lg, jlg) <= 1e-4
    nt = lg[:, -1].argmax(-1, keepdim=True)
    jlg, _ = _j_decode(jp, jc, jnp.asarray(nt.numpy(), jnp.int32), jcache)
    lg, _ = tt.decode_step(tp, tc, nt, cache)
    assert _rel(lg, jlg) <= 1e-4


@pytest.mark.parametrize("name", [MODELS[0], "granite-moe-3b-a800m"])
def test_cache_from_numpy_carries_cross_and_moe_entries(models, name):
    """A cache that the reference prefilled (fp32: the encoder-decoder's
    ``ck``/``cv`` entries; the MoE kind's ``attn``-like entries) carried
    into the port, leaf for leaf, and one decode step from it against the
    reference's."""
    if name in models:
        jc, tc, jp, tp, tokens, fe = models[name]
    else:
        jc, tc = j_smoke(name), configs.get_smoke_config(name)
        jp = jt.init_model(jax.random.PRNGKey(5), jc)
        tp = convert.model_from_numpy(_np_tree(jp), tc, "cpu")
        tokens, fe = np.random.default_rng(5).integers(
            0, jc.vocab_size, (B, S)), {}
    jlg, jcache = _j_prefill(jp, jc, jnp.asarray(tokens), S + 3,
                             cache_dtype=jnp.float32, **_j(fe))
    cache = convert.cache_from_numpy(_np_tree(jcache), tc, "cpu")
    want_keys = {"k", "v", "ck", "cv"} if tc.is_encdec else {"k", "v"}
    for entry in cache["layers"]:
        assert set(entry) == want_keys
        assert all(t.dtype == torch.float32 for t in entry.values())
    np.testing.assert_array_equal(
        cache["layers"][-1]["k"].numpy(),
        np.asarray(jcache["cycles"][0]["k"])[tc.n_layers - 1])
    nt = np.asarray(jnp.argmax(jlg, -1)).astype(np.int32)
    jd, _ = _j_decode(jp, jc, jnp.asarray(nt), jcache)
    td, _ = tt.decode_step(tp, tc, torch.tensor(nt).long(), cache)
    assert _rel(td, jd) <= 1e-4


def test_model_from_numpy_carries_a_two_layer_encoder(models):
    """The reference stacks its encoder on a leading n_enc_layers axis: the
    port holds the list of blocks (each without cross-attention) and
    ``enc_norm``, leaf for leaf; decoder blocks hold ``ln_cross``/``cross``,
    with LayerNorm's scale and bias; the parameter counts agree."""
    jc, tc, jp, tp, _, _ = models[MODELS[0]]
    assert tc.n_enc_layers == 2 and len(tp["encoder"]) == 2
    for i, block in enumerate(tp["encoder"]):
        assert "cross" not in block
        want = jax.tree.leaves(jax.tree.map(lambda a: a[i], jp["encoder"]))
        got = list(tt._leaves({k: block[k] for k in sorted(block)}))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(tp["enc_norm"]["bias"].numpy(),
                                  np.asarray(jp["enc_norm"]["bias"]))
    assert {"ln_cross", "cross"} <= set(tp["layers"][0])
    assert set(tp["layers"][0]["ln1"]) == {"scale", "bias"}
    assert tt.param_count(tp) == jt.param_count(jp)
    fresh = tt.init_model(torch.Generator().manual_seed(0), tc)
    assert tt.param_count(fresh) == jt.param_count(jp)
    assert len(fresh["encoder"]) == 2 and "enc_norm" in fresh


@pytest.mark.parametrize("name", MODELS)
def test_pooled_features_take_the_frontend_inputs(models, name):
    """``pooled_features(..., prefix_embeds=)`` / ``(..., enc_embeds=)`` for
    3 agents, every agent with the same frontend inputs as the reference
    passes them.  With prefix embeddings the mask spans P + S positions
    (the reference's mask=None path masks S only, and fails)."""
    jc, tc, jp, tp, tokens, fe = models[name]
    rng = np.random.default_rng(7)
    tok = rng.integers(0, jc.vocab_size, (3, B, S))
    P = tc.n_prefix_embeddings if "prefix_embeds" in fe else 0
    mask = rng.random((3, B, P + S)) < 0.8
    pooled = jax.jit(jh.pooled_features, static_argnums=1)
    want = pooled(jp, jc, jnp.asarray(tok), jnp.asarray(mask), **_j(fe))
    got = th.pooled_features(tp, tc, torch.tensor(tok), torch.tensor(mask),
                             **_t(fe))
    assert got.shape == (3, B, tc.d_model)
    assert _rel(got, want) <= 1e-4
    full = th.pooled_features(tp, tc, torch.tensor(tok), **_t(fe))
    want = pooled(jp, jc, jnp.asarray(tok), jnp.ones((3, B, P + S), bool),
                  **_j(fe))
    assert _rel(full, want) <= 1e-4
