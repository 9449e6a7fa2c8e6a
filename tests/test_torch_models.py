"""Port parity: the model zoo's ported part (``repro_torch/models``,
``configs``, ``convert.model_from_numpy``).

The reference's weights (``init_model``) carry into the port through
``convert.model_from_numpy``, the same numpy tokens go through both
packages, and the port runs on CPU tensors (so the ``swa`` and ``rglru``
blocks take their kernels' plain versions).  Blocks agree within 1e-5
(fp32); ``encode`` of the recurrentgemma and h2o-danube smoke configs
within 1e-4 of max |reference| in fp32 and 3e-2 in bf16 (the reference
rounds p to bf16 before P V, the port's sliding-window path keeps it fp32).
recurrentgemma runs with n_layers = 5 (one cycle of (rglru, rglru, swa)
plus two trailing blocks) and S = 40 > window 16; xlstm-1.3b with its smoke
config's (mlstm, slstm) cycle, S = 40 in five chunks of 8.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test process: xdist's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models import layers as jl  # noqa: E402
from repro.models import mlp as jm  # noqa: E402
from repro.models import rglru as jr  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels.mlstm import kernel as mlstm_kernel  # noqa: E402
from repro_torch.kernels.rglru import kernel as rglru_kernel  # noqa: E402
from repro_torch.kernels.swa import kernel as swa_kernel  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models import layers as tl  # noqa: E402
from repro_torch.models import mlp as tm  # noqa: E402
from repro_torch.models import rglru as tr  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402

SMOKE = {"recurrentgemma-2b": {"n_layers": 5}, "h2o-danube-3-4b": {},
         "xlstm-1.3b": {}}
S = 40


def _cfgs(name, **kw):
    jc = dataclasses.replace(j_smoke(name), **SMOKE[name], **kw)
    tc = dataclasses.replace(configs.get_smoke_config(name), **SMOKE[name],
                             **kw)
    return jc, tc


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.fixture(scope="module")
def models():
    """Per smoke config: (reference cfg, port cfg, reference params, port
    params, tokens (2, S), reference encode in fp32)."""
    out = {}
    for i, name in enumerate(SMOKE):
        jc, tc = _cfgs(name)
        jp = jt.init_model(jax.random.PRNGKey(i), jc)
        tp = convert.model_from_numpy(_np_tree(jp), tc, "cpu")
        tokens = np.random.default_rng(i).integers(0, jc.vocab_size, (2, S))
        want = np.asarray(jt.encode(jp, jc, jnp.asarray(tokens)))
        out[name] = (jc, tc, jp, tp, tokens, want)
    return out


def test_configs_match_the_reference_and_refuse_later_slices():
    """All ten of the reference's architectures resolve, under its names
    and in its order, field for field; an unknown name raises KeyError."""
    from repro.configs import ARCH_NAMES as J_NAMES
    from repro.configs import get_config as j_get

    assert configs.ARCH_NAMES == J_NAMES and len(J_NAMES) == 10
    for name in J_NAMES:
        assert dataclasses.asdict(configs.get_config(name)) == \
            dataclasses.asdict(j_get(name))
        assert dataclasses.asdict(configs.get_smoke_config(name)) == \
            dataclasses.asdict(j_smoke(name))
    full = configs.get_config("recurrentgemma-2b")
    assert full.layer_kinds().count("rglru") == 18
    assert full.layer_kinds().count("swa") == 8
    assert not hasattr(configs, "_LATER")
    with pytest.raises(KeyError):
        configs.get_config("no-such-model")


@pytest.mark.parametrize("name", list(SMOKE))
def test_encode_matches_reference_fp32(models, name):
    _, tc, _, tp, tokens, want = models[name]
    swa_kernel.reset_launches()
    rglru_kernel.reset_launches()
    mlstm_kernel.reset_launches()
    got = tt.encode(tp, tc, torch.tensor(tokens))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _rel(got, want) <= 1e-4
    # CPU tensors never launch a kernel
    assert swa_kernel.LAUNCHES["swa"] == rglru_kernel.LAUNCHES["rglru"] == 0
    assert mlstm_kernel.LAUNCHES["mlstm"] == 0


def test_encode_matches_reference_bf16(models):
    jc, tc, jp, tp, tokens, _ = models["recurrentgemma-2b"]
    jc, tc = (dataclasses.replace(c, dtype="bfloat16") for c in (jc, tc))
    want = np.asarray(jt.encode(jp, jc, jnp.asarray(tokens)).astype(
        jnp.float32))
    got = tt.encode(tp, tc, torch.tensor(tokens))
    assert got.dtype == torch.bfloat16
    assert _rel(got, want) <= 3e-2


def test_forward_logits_and_param_count_match(models):
    jc, tc, jp, tp, tokens, _ = models["h2o-danube-3-4b"]
    jl_, _ = jt.forward(jp, jc, jnp.asarray(tokens))
    tl_, aux = tt.forward(tp, tc, torch.tensor(tokens))
    assert tl_.dtype == torch.float32 and aux == 0.0
    assert _rel(tl_, jl_) <= 1e-4
    for name in SMOKE:
        _, _, jp, tp, _, _ = models[name]
        assert tt.param_count(tp) == jt.param_count(jp)


def test_model_from_numpy_unstacks_cycles_then_rem(models):
    jc, tc, jp, tp, _, _ = models["recurrentgemma-2b"]
    assert len(jp["cycles"]) == 3 and len(jp["rem"]) == 2
    assert len(tp["layers"]) == 5
    want = [jp["cycles"][j] for j in range(3)] + list(jp["rem"])
    for li, (layer, ref) in enumerate(zip(tp["layers"], want)):
        idx = 0 if li < 3 else None
        leaves = jax.tree.leaves(ref)
        ported = list(tt._leaves(layer))
        assert len(leaves) == len(ported)
        for a, b in zip(ported, leaves):
            b = np.asarray(b)
            np.testing.assert_array_equal(a.numpy(), b[idx] if idx is not None
                                          else b)
    assert "rglru" in tp["layers"][4] and "attn" in tp["layers"][2]
    # dense weights keep the reference's (d_in, d_out) orientation
    assert tp["layers"][2]["attn"]["wq"]["w"].shape == (
        tc.d_model, tc.n_heads * tc.head_dim)


def test_init_model_draws_the_reference_layout():
    _, tc = _cfgs("recurrentgemma-2b")
    p = tt.init_model(torch.Generator().manual_seed(0), tc)
    q = tt.init_model(torch.Generator().manual_seed(0), tc)
    jp = jt.init_model(jax.random.PRNGKey(0), _cfgs("recurrentgemma-2b")[0])
    assert tt.param_count(p) == jt.param_count(jp)
    assert all(torch.equal(a, b) for a, b in zip(tt._leaves(p),
                                                  tt._leaves(q)))
    lam = p["layers"][0]["rglru"]["lam"]["lam"]
    assert float(lam.min()) >= 0.0 and float(lam.max()) < 1.0
    assert all(t.dtype == torch.float32 for t in tt._leaves(p))


def test_embedding_scale_rounds_to_the_compute_dtype():
    """recurrentgemma-2b's sqrt(2560) = 50.596... is 50.5 in bf16, as the
    reference's jnp.asarray(d ** 0.5, dtype) rounds it."""
    cfg = configs.get_config("recurrentgemma-2b")
    for tdt, jdt in ((torch.bfloat16, jnp.bfloat16),
                     (torch.float32, jnp.float32)):
        got = tt.embed_scale(cfg, tdt)
        want = jnp.asarray(cfg.d_model ** 0.5, jdt)
        assert got.dtype == tdt and float(got) == float(want)
    assert float(tt.embed_scale(cfg, torch.bfloat16)) == 50.5
    assert tt.embed_scale(configs.get_config("h2o-danube-3-4b"),
                          torch.float32) is None
    # and the scaled embedding of a real row matches the reference's
    rng = np.random.default_rng(0)
    table = rng.standard_normal((10, 2560)).astype(np.float32)
    tokens = np.array([[1, 7, 3]])
    want = (jl.embed({"table": jnp.asarray(table)}, jnp.asarray(tokens),
                     jnp.bfloat16)
            * jnp.asarray(2560 ** 0.5, jnp.bfloat16)).astype(jnp.float32)
    params = {"embed": {"table": torch.tensor(table)}}
    got = tt._embed_tokens(params, dataclasses.replace(cfg, dtype="bfloat16"),
                           torch.tensor(tokens))
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_rope_and_mlps_match(dtype):
    rng = np.random.default_rng(1)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    tol = dict(rtol=3e-2, atol=3e-2) if dtype == "bfloat16" else \
        dict(rtol=1e-5, atol=1e-5)
    x = rng.standard_normal((2, 6, 4, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    jx, tx = jnp.asarray(x, jdt), torch.tensor(x).to(tdt)
    np.testing.assert_allclose(
        tl.rmsnorm({"scale": torch.tensor(scale)}, tx).float().numpy(),
        np.asarray(jl.rmsnorm({"scale": jnp.asarray(scale)}, jx), np.float32),
        **tol)
    pos = np.tile(np.arange(6)[None], (2, 1)) * 37
    np.testing.assert_allclose(
        tl.apply_rope(tx, torch.tensor(pos), 500000.0).float().numpy(),
        np.asarray(jl.apply_rope(jx, jnp.asarray(pos), 500000.0), np.float32),
        **tol)
    for mlp_type in ("geglu", "swiglu"):
        jc = dataclasses.replace(j_smoke("h2o-danube-3-4b"), mlp_type=mlp_type)
        tc = dataclasses.replace(configs.get_smoke_config("h2o-danube-3-4b"),
                                 mlp_type=mlp_type)
        jp = jm.mlp_init(jax.random.PRNGKey(2), jc)
        tp = convert._tree_tensors(_np_tree(jp), "cpu")
        h = rng.standard_normal((2, 5, tc.d_model)).astype(np.float32)
        np.testing.assert_allclose(
            tm.mlp(tp, tc, torch.tensor(h).to(tdt)).float().numpy(),
            np.asarray(jm.mlp(jp, jc, jnp.asarray(h, jdt)), np.float32),
            **tol)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101).astype(np.float32)
    np.testing.assert_allclose(tm.gelu(torch.tensor(x)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_rglru_block_matches_reference():
    jc, tc = _cfgs("recurrentgemma-2b")
    jp = jr.rglru_init(jax.random.PRNGKey(3), jc)
    tp = convert._tree_tensors(_np_tree(jp), "cpu")
    x = np.random.default_rng(3).standard_normal(
        (2, 33, jc.d_model)).astype(np.float32)
    jo, jst = jr.rglru_block(jp, jc, jnp.asarray(x), None)
    to, tst = tr.rglru_block(tp, tc, torch.tensor(x))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tst.h.numpy(), np.asarray(jst.h), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(tst.conv.numpy(), np.asarray(jst.conv))
    # from the carried state, as the reference's block from its own
    jo, jst = jr.rglru_block(jp, jc, jnp.asarray(x), jst)
    to, tst = tr.rglru_block(tp, tc, torch.tensor(x), state=tst)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tst.h.numpy(), np.asarray(jst.h), rtol=1e-5,
                               atol=1e-5)


def test_attention_paths_match_reference():
    """The windowed kernel path and the plain flash_attention (global,
    padded positions, softcap) against the reference's flash_attention."""
    jc, tc = _cfgs("h2o-danube-3-4b")
    jp = ja.attention_init(jax.random.PRNGKey(4), jc)
    tp = convert._tree_tensors(_np_tree(jp), "cpu")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, S, jc.d_model)).astype(np.float32)
    pos = np.tile(np.arange(S)[None], (2, 1))
    for window in (16, None):
        want = ja.self_attention_block(jp, jc, jnp.asarray(x),
                                       jnp.asarray(pos), window=window)
        got = ta.self_attention_block(tp, tc, torch.tensor(x), window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
    q, k, v = (rng.standard_normal((2, S, h, 32)).astype(np.float32)
               for h in (4, 2, 2))
    pos_q = pos.copy()
    pos_q[1, 30:] = -1                                    # padded queries
    for kw in (dict(window=None, attn_softcap=None),
               dict(window=9, attn_softcap=20.0)):
        want = ja.flash_attention(*(jnp.asarray(a) for a in (q, k, v, pos_q,
                                                             pos)),
                                  q_block=16, kv_block=8, **kw)
        got = ta.flash_attention(*(torch.tensor(a) for a in (q, k, v, pos_q,
                                                             pos)),
                                 q_block=16, kv_block=8, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


def test_later_slices_raise():
    """What cannot run raises: ``moe_ffn_shardmap`` without an active mesh
    (the reference reaches it only under one); a windowed block
    with ``attn_softcap`` is refused (the swa kernel has no softcap, and no
    config sets both); an unknown kind, and a mode without its entry, are
    errors.  The MoE kind, prefix embeddings and encoder-decoders run."""
    from repro_torch.models import moe

    _, tc = _cfgs("h2o-danube-3-4b")
    gen = torch.Generator().manual_seed(0)
    params = tt.init_model(gen, tc)
    x = torch.zeros(1, 4, tc.d_model)
    with pytest.raises(ValueError, match="active mesh"):
        moe.moe_ffn_shardmap({}, tc, x)
    with pytest.raises(ValueError, match="unknown block kind"):
        tt.block_init(gen, tc, "conv")
    with pytest.raises(ValueError, match="cache entry"):
        tt.block_apply(params["layers"][0], tc, "swa", x, mode="decode")
    with pytest.raises(ValueError, match="softcap"):
        tt.block_apply(params["layers"][0],
                       dataclasses.replace(tc, attn_softcap=50.0), "swa", x)
    blk = tt.block_init(gen, configs.get_smoke_config("granite-moe-3b-a800m"),
                        "moe")
    assert "moe" in blk and "mlp" not in blk
    h = tt.encode(params, tc, torch.zeros(1, 4, dtype=torch.long),
                  prefix_embeds=x)
    assert h.shape == (1, 8, tc.d_model)
    _, cache = tt.prefill(params, tc, torch.zeros(1, 4, dtype=torch.long), 8,
                          prefix_embeds=x)
    assert cache["pos"].tolist() == [8]
    ed = configs.get_smoke_config("seamless-m4t-large-v2")
    with pytest.raises(ValueError, match="enc_embeds"):
        tt.encode(tt.init_model(gen, ed), ed,
                  torch.zeros(1, 4, dtype=torch.long))
