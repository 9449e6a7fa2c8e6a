"""Port parity: the decode caches (``repro_torch/models/cache.py``), int8 KV
lines (``models/kvquant.py``), single-token ``decode_attention`` and
``convert.cache_from_numpy``.

The same numpy inputs go through both packages on the CPU.  ``quantize`` is
held bit for bit (int8 values and bf16 scales: both round half to even);
``init_cache`` leaf for leaf in shape and dtype after the reference's
stacked cycles are unstacked; ``decode_attention`` within 1e-5 (fp32).  The
states the caches carry: each of ``rglru_block``, ``mlstm_block`` and
``slstm_block`` split in two with the state carried equals the whole run and
the reference's block from the same state, within 1e-5 (fp32).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import attention as ja  # noqa: E402
from repro.models import cache as jcache  # noqa: E402
from repro.models import kvquant as jq  # noqa: E402
from repro.models import rglru as jr  # noqa: E402
from repro.models import xlstm as jx  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import attention as ta  # noqa: E402
from repro_torch.models import cache as tcache  # noqa: E402
from repro_torch.models import kvquant as tq  # noqa: E402
from repro_torch.models import rglru as tr  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.models import xlstm as tx  # noqa: E402

MODELS = ["qwen3-8b", "gemma-7b", "h2o-danube-3-4b", "recurrentgemma-2b",
          "xlstm-1.3b"]
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _bytes(cache):
    return sum(t.numel() * t.element_size() for t in tt._leaves(cache))


def _bf16_bits(t):
    return t.view(torch.int16).numpy()


def _ref_bf16_bits(a):
    return np.asarray(a).view(np.int16)


@pytest.mark.parametrize("shape,scale", [((4, 8, 2, 32), 3.0),
                                         ((2, 5, 1, 256), 1e-3),
                                         ((3, 7, 4, 120), 50.0)])
def test_quantize_is_the_reference_bit_for_bit(shape, scale):
    x = (np.random.default_rng(0).standard_normal(shape) * scale).astype(
        np.float32)
    x[0, 0, 0, :4] = [127.0, 0.5, 1.5, -2.5]    # scale 1: ties to even
    x[0, 1, 0] = 0.0                           # an all-zero row: scale 1e-6
    want = jq.quantize(jnp.asarray(x))
    got = tq.quantize(torch.tensor(x))
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(_bf16_bits(got.scale),
                                  _ref_bf16_bits(want.scale))
    assert got.q[0, 0, 0, :4].tolist() == [127, 0, 2, -2]
    for dtype in DTYPES:
        np.testing.assert_array_equal(
            tq.dequantize(got, DTYPES[dtype][1]).float().numpy(),
            np.asarray(jq.dequantize(want, DTYPES[dtype][0]),
                       np.float32))


def test_quantize_roundtrip_error_bounded():
    """As the reference's test: per-row max-abs scaling errs by at most
    scale / 2 = amax / 254, plus the bf16 rounding of the stored scale."""
    x = torch.tensor(np.random.default_rng(1).standard_normal(
        (4, 8, 2, 32)).astype(np.float32) * 3.0)
    back = tq.dequantize(tq.quantize(x), torch.float32)
    amax = x.abs().amax(dim=-1, keepdim=True)
    assert bool(((back - x).abs() <= amax * (1 / 254 + 0.005) + 1e-6).all())


def test_quantized_cache_is_half_the_bytes():
    cfg = dataclasses.replace(configs.get_smoke_config("gemma-7b"),
                              kv_quant=True)
    c_q = tcache.init_cache(cfg, 2, 64, device="cpu")
    c_fp = tcache.init_cache(dataclasses.replace(cfg, kv_quant=False), 2, 64,
                             device="cpu")
    assert _bytes(c_q) < 0.55 * _bytes(c_fp)


@pytest.mark.parametrize("max_len", [8, 48])    # below and above window 16
@pytest.mark.parametrize("kv_quant", [False, True])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", MODELS)
def test_init_cache_matches_the_reference_leaf_for_leaf(name, dtype,
                                                        kv_quant, max_len):
    jc = dataclasses.replace(j_smoke(name), kv_quant=kv_quant)
    tc = dataclasses.replace(configs.get_smoke_config(name),
                             kv_quant=kv_quant)
    jdt, tdt = DTYPES[dtype]
    want = convert.cache_from_numpy(
        _np_tree(jcache.init_cache(jc, 3, max_len, jdt)), tc, "cpu")
    got = tcache.init_cache(tc, 3, max_len, tdt, device="cpu")
    assert got["pos"].dtype == torch.int32 and got["pos"].shape == (3,)
    assert len(got["layers"]) == tc.n_layers
    for g, w in zip(got["layers"], want["layers"]):
        assert type(g) is type(w)
        g_leaves = list(tt._leaves(g))
        w_leaves = list(tt._leaves(w))
        assert len(g_leaves) == len(w_leaves)
        for a, b in zip(g_leaves, w_leaves):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(a, b)          # zeros, and m = -1e30


def _same_entries(got, want):
    """Entry for entry, leaf for leaf: type, shape, dtype and values."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert type(g) is type(w)
        if isinstance(g, dict):
            assert set(g) == set(w)
            g, w = ([e[k] for k in sorted(e)] for e in (g, w))
        for a, b in zip(tt._leaves(g), tt._leaves(w)):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert torch.equal(a, b)


def test_init_cache_defaults_to_the_card_and_refuses_later_slices():
    """``device=None`` is the card; an ``moe`` block's entry is an ``attn``
    entry, and an encoder-decoder's attention entries hold ``ck``/``cv``
    of (batch, enc_seq, KV, D), as the reference's ``init_cache`` has them
    (its stacked cycles unstacked); an unknown kind raises."""
    cfg = configs.get_smoke_config("qwen3-8b")
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            tcache.init_cache(cfg, 1, 8)          # device=None is cuda
    assert list(tcache.block_cache_entry(cfg, "moe", 1, 8, device="cpu")) \
        == ["k", "v"]
    with pytest.raises(ValueError, match="unknown block kind"):
        tcache.block_cache_entry(cfg, "conv", 1, 8, device="cpu")
    encdec = dataclasses.replace(cfg, n_enc_layers=2, enc_seq=4)
    jenc = dataclasses.replace(j_smoke("qwen3-8b"), n_enc_layers=2,
                               enc_seq=4)
    got = tcache.init_cache(encdec, 3, 8, torch.float32, device="cpu")
    want = convert.cache_from_numpy(
        _np_tree(jcache.init_cache(jenc, 3, 8, jnp.float32)), encdec, "cpu")
    _same_entries(got["layers"], want["layers"])
    assert got["layers"][0]["ck"].shape == (3, 4, cfg.n_kv_heads,
                                            cfg.head_dim)


@pytest.mark.parametrize("softcap", [None, 30.0])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_decode_attention_matches_reference(dtype, softcap):
    B, H, KV, D, S = 2, 4, 2, 8, 16
    rng = np.random.default_rng(2)
    q = rng.standard_normal((B, 1, H, D)).astype(np.float32)
    kc, vc = (rng.standard_normal((B, S, KV, D)).astype(np.float32)
              for _ in range(2))
    valid = np.arange(S)[None] < np.array([10, 16])[:, None]
    jdt, tdt = DTYPES[dtype]
    want = ja.decode_attention(jnp.asarray(q), jnp.asarray(kc, jdt),
                               jnp.asarray(vc, jdt), jnp.asarray(valid),
                               softcap)
    got = ta.decode_attention(torch.tensor(q), torch.tensor(kc).to(tdt),
                              torch.tensor(vc).to(tdt), torch.tensor(valid),
                              softcap)
    assert got.shape == (B, 1, H, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_write_row_keeps_the_rows_it_drops():
    cfg = configs.get_smoke_config("qwen3-8b")
    line = tq.quant_entry(cfg, 2, 4, "cpu")["k"]
    row = torch.randn(2, cfg.n_kv_heads, cfg.head_dim)
    bidx, slot = torch.arange(2), torch.tensor([1, 3])
    tq.write_row(line, bidx, slot, row, keep=torch.tensor([True, False]))
    qn = tq.quantize(row)
    assert torch.equal(line.q[0, 1], qn.q[0])
    assert torch.equal(line.scale[0, 1], qn.scale[0])
    assert not line.q[1].any() and not line.scale[1].float().any()


@pytest.mark.parametrize("s1", [1, 7, 13])
@pytest.mark.parametrize("block", ["rglru", "mlstm", "slstm"])
def test_block_split_with_a_carried_state(block, s1):
    """A block over x[:, :s1] and then, from the carried state, over
    x[:, s1:] equals the block over all of x (1e-5; the mLSTM's chunks of 8
    fall elsewhere), and the second half equals the reference's block from
    the reference's state of the first half."""
    name = "recurrentgemma-2b" if block == "rglru" else "xlstm-1.3b"
    jc, tc = j_smoke(name), configs.get_smoke_config(name)
    jmod, tmod = (jr, tr) if block == "rglru" else (jx, tx)
    jp = getattr(jmod, f"{block}_init")(jax.random.PRNGKey(7), jc)
    tp = convert._tree_tensors(_np_tree(jp), "cpu")
    x = np.random.default_rng(7).standard_normal(
        (2, 21, jc.d_model)).astype(np.float32)
    xt = torch.tensor(x)
    fn = getattr(tmod, f"{block}_block")
    kw = {"final_state": True} if block == "mlstm" else {}
    whole, st_whole = fn(tp, tc, xt, **kw)
    first, st1 = fn(tp, tc, xt[:, :s1], **kw)
    second, st2 = fn(tp, tc, xt[:, s1:], st1)
    np.testing.assert_allclose(torch.cat([first, second], 1).numpy(),
                               whole.numpy(), rtol=1e-5, atol=1e-5)
    for a, b in zip(st2, st_whole):
        assert _rel(a, b.numpy()) <= 1e-5
    jfn = jax.jit(getattr(jmod, f"{block}_block"), static_argnums=1)
    _, jst1 = jfn(jp, jc, jnp.asarray(x[:, :s1]), None)
    want, jst2 = jfn(jp, jc, jnp.asarray(x[:, s1:]), jst1)
    np.testing.assert_allclose(second.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(st2, jst2):
        assert _rel(a, b) <= 1e-5


@pytest.mark.parametrize("name", ["qwen3-8b", "qwen3-14b", "gemma-7b"])
def test_dense_configs_load_by_name_as_the_reference_has_them(name):
    from repro.configs import get_config as j_get

    assert dataclasses.asdict(configs.get_config(name)) == \
        dataclasses.asdict(j_get(name))
    assert dataclasses.asdict(configs.get_smoke_config(name)) == \
        dataclasses.asdict(j_smoke(name))
    assert set(configs.get_config(name).layer_kinds()) == {"attn"}


@pytest.mark.parametrize("name,kind", [
    ("qwen3-moe-30b-a3b", "moe"), ("granite-moe-3b-a800m", "moe"),
    ("seamless-m4t-large-v2", "attn"), ("llava-next-34b", "attn")])
def test_later_configs_name_their_slice(name, kind):
    """The configs that came with the MoE and encoder-decoder slice load by
    name as the reference has them, and their smoke configs' caches (bf16,
    int8 lines too) equal the reference's entry for entry."""
    from repro.configs import get_config as j_get

    assert dataclasses.asdict(configs.get_config(name)) == \
        dataclasses.asdict(j_get(name))
    assert set(configs.get_config(name).layer_kinds()) == {kind}
    for kv_quant in (False, True):
        tc = dataclasses.replace(configs.get_smoke_config(name),
                                 kv_quant=kv_quant)
        jc = dataclasses.replace(j_smoke(name), kv_quant=kv_quant)
        got = tcache.init_cache(tc, 2, 12, device="cpu")
        want = convert.cache_from_numpy(
            _np_tree(jcache.init_cache(jc, 2, 12)), tc, "cpu")
        _same_entries(got["layers"], want["layers"])
