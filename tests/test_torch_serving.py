"""Port parity: the serving path (``prefill``, ``decode_step`` and
``serving.steps.generate``) on the smoke configs of qwen3-8b, gemma-7b,
h2o-danube-3-4b, recurrentgemma-2b and xlstm-1.3b (the engine and the int8
cache: ``test_torch_serving_engine.py``; carried block states:
``test_torch_cache.py``).

The reference's weights carry into the port (``convert.model_from_numpy``),
the same numpy tokens go through both packages, and the port runs on CPU
tensors (the ``swa``, ``rglru`` and ``mlstm`` kernels' plain versions).
Prompts of S = 20 pass the sliding window of 16, so the rings wrap in
prefill.  Limits, each relative to max |reference|:

- fp32 caches: prefill logits and every cache leaf, and a decode from the
  reference's own cache (``convert.cache_from_numpy``), within 1e-4; greedy
  tokens equal;
- bf16 caches (the default; ``test_torch_serving_bf16.py``): within 3e-2
  (``TOL["bf16"]``), the reference's limit for bf16 against fp32 paths;
- decode against the port's own forward: 1e-4 in fp32 (the reference's
  tests allow 5e-2 and 5e-3: its prefill and decode attention are
  different jnp paths).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test process: xdist's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.serving import steps as jsteps  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels.mlstm import kernel as mlstm_kernel  # noqa: E402
from repro_torch.kernels.rglru import kernel as rglru_kernel  # noqa: E402
from repro_torch.kernels.swa import kernel as swa_kernel  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serving import steps as tsteps  # noqa: E402

MODELS = ["qwen3-8b", "gemma-7b", "h2o-danube-3-4b", "recurrentgemma-2b",
          "xlstm-1.3b"]
B, S, MAX_LEN, NEW = 2, 20, 28, 4
TOL = {"float32": 1e-4, "bfloat16": 3e-2}
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def leaf_errors(got, want):
    """Relative error of each leaf pair of two port caches (or entries),
    after checking that their shapes and dtypes agree."""
    out = []
    for a, b in zip(tt._leaves(got), tt._leaves(want)):
        assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape)
        out.append(rel(a, b.float().numpy()))
    assert len(out) == len(list(tt._leaves(want)))
    return out


def make_models():
    """Per smoke config: (reference cfg, port cfg, reference params, port
    params, prompts (B, S))."""
    out = {}
    for i, name in enumerate(MODELS):
        jc, tc = j_smoke(name), configs.get_smoke_config(name)
        jp = jt.init_model(jax.random.PRNGKey(i), jc)
        tp = convert.model_from_numpy(np_tree(jp), tc, "cpu")
        tokens = np.random.default_rng(i).integers(0, jc.vocab_size, (B, S))
        out[name] = (jc, tc, jp, tp, tokens)
    return out


def make_ref_runs(models, dtypes):
    """The reference's prefill, its cache, and one decode step on the
    greedy tokens, per (model, cache dtype)."""
    runs = {}
    for name, (jc, _, jp, _, tokens) in models.items():
        for dtype in dtypes:
            jdt = DTYPES[dtype][0]
            logits, cache = jt.prefill(jp, jc, jnp.asarray(tokens),
                                       MAX_LEN, cache_dtype=jdt)
            nt = jnp.argmax(logits, -1).astype(jnp.int32)
            d_logits, _ = jt.decode_step(jp, jc, nt, cache)
            runs[name, dtype] = (np.asarray(logits), np_tree(cache),
                                 np.asarray(nt), np.asarray(d_logits))
    return runs


def check_prefill(model, ref_run, dtype) -> None:
    """The port's prefill against the reference's: logits and every cache
    leaf within ``TOL[dtype]`` of max |reference|, launching no kernel on
    CPU tensors."""
    _, tc, _, tp, tokens = model
    want_logits, want_cache, _, _ = ref_run
    for w in (swa_kernel, rglru_kernel, mlstm_kernel):
        w.reset_launches()
    logits, cache = tt.prefill(tp, tc, torch.tensor(tokens), MAX_LEN,
                               cache_dtype=DTYPES[dtype][1])
    assert logits.shape == (B, 1, tc.vocab_size)
    assert logits.dtype == torch.float32
    assert rel(logits, want_logits) <= TOL[dtype]
    assert cache["pos"].tolist() == [S] * B
    want = convert.cache_from_numpy(want_cache, tc, "cpu")
    assert max(leaf_errors(cache, want)) <= TOL[dtype]
    assert swa_kernel.LAUNCHES["swa"] == rglru_kernel.LAUNCHES["rglru"] == 0
    assert mlstm_kernel.LAUNCHES["mlstm"] == 0


def check_decode_from_reference(model, ref_run, dtype) -> None:
    """The port's decode step from the reference's prefilled cache against
    the reference's decode step, within ``TOL[dtype]``."""
    _, tc, _, tp, _ = model
    _, want_cache, nt, want_logits = ref_run
    cache = convert.cache_from_numpy(want_cache, tc, "cpu")
    logits, new = tt.decode_step(tp, tc, torch.tensor(nt).long(), cache)
    assert logits.shape == (B, 1, tc.vocab_size)
    assert rel(logits, want_logits) <= TOL[dtype]
    assert new["pos"].tolist() == [S + 1] * B


@pytest.fixture(scope="module")
def models():
    return make_models()


@pytest.fixture(scope="module")
def ref_runs(models):
    return make_ref_runs(models, ["float32"])


@pytest.mark.parametrize("name", MODELS)
def test_prefill_matches_reference(models, ref_runs, name):
    check_prefill(models[name], ref_runs[name, "float32"], "float32")


@pytest.mark.parametrize("name", MODELS)
def test_decode_from_the_reference_cache(models, ref_runs, name):
    """The port decodes on from a cache that the reference prefilled."""
    check_decode_from_reference(models[name], ref_runs[name, "float32"],
                                "float32")


@pytest.mark.parametrize("name", MODELS)
def test_generate_tokens_equal_the_reference(models, name):
    jc, tc, jp, tp, tokens = models[name]
    want, _ = jsteps.generate(jp, jc, jnp.asarray(tokens), max_new=NEW,
                              max_len=MAX_LEN, cache_dtype=jnp.float32)
    got, cache = tsteps.generate(tp, tc, torch.tensor(tokens), max_new=NEW,
                                 max_len=MAX_LEN, cache_dtype=torch.float32)
    assert got.shape == (B, NEW)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert cache["pos"].tolist() == [S + NEW - 1] * B


@pytest.mark.parametrize("name", MODELS)
def test_decode_matches_forward(models, name):
    """As the reference's ``test_smoke_decode_matches_forward``: one decode
    step after the prompt against the forward over prompt + token."""
    _, tc, _, tp, tokens = models[name]
    tok = torch.tensor(tokens)
    lg_pre, cache = tt.prefill(tp, tc, tok, MAX_LEN,
                               cache_dtype=torch.float32)
    nt = lg_pre.argmax(-1)
    lg_dec, _ = tt.decode_step(tp, tc, nt, cache)
    lg_full, _ = tt.forward(tp, tc, torch.cat([tok, nt], dim=1))
    assert rel(lg_dec[:, 0], lg_full[:, -1].numpy()) <= 1e-4
    assert rel(lg_pre[:, 0], lg_full[:, -2].numpy()) <= 1e-4


@pytest.mark.parametrize("name", ["h2o-danube-3-4b", "recurrentgemma-2b"])
def test_ring_past_the_window_matches_forward(models, name):
    """As the reference's ``test_ring_buffer_long_generation_matches_full_
    window``: 12 prompt tokens, then 12 decode steps of random tokens, past
    the window of 16; every step against the forward over the sequence."""
    _, tc, _, tp, _ = models[name]
    assert tc.sliding_window == 16
    gen = torch.Generator().manual_seed(2)
    seq = torch.randint(0, tc.vocab_size, (1, 12), generator=gen)
    _, cache = tt.prefill(tp, tc, seq, 24, cache_dtype=torch.float32)
    for _ in range(12):
        nxt = torch.randint(0, tc.vocab_size, (1, 1), generator=gen)
        lg_dec, cache = tt.decode_step(tp, tc, nxt, cache)
        seq = torch.cat([seq, nxt], dim=1)
        lg_full, _ = tt.forward(tp, tc, seq)
        assert rel(lg_dec[0, 0], lg_full[0, -1].numpy()) <= 1e-4


def test_swa_ring_is_sized_by_max_len_below_the_window(models):
    """The reference's prefill sizes a sliding-window ring by the window
    even when max_len is smaller (it passes the window as max_len), while
    its ``init_cache`` takes min(window, max_len); the port takes the min
    for both.  No position reaches max_len, so nothing wraps: the
    reference's first max_len slots hold what the port's ring holds, and
    the rest are zeros."""
    jc, tc, jp, tp, tokens = models["h2o-danube-3-4b"]
    max_len = 12                                 # below the window of 16
    tok = tokens[:, :8]
    _, want = jt.prefill(jp, jc, jnp.asarray(tok), max_len,
                         cache_dtype=jnp.float32)
    _, got = tt.prefill(tp, tc, torch.tensor(tok), max_len,
                        cache_dtype=torch.float32)
    want = convert.cache_from_numpy(np_tree(want), tc, "cpu")
    for g, w in zip(got["layers"], want["layers"]):
        for name in ("k", "v"):
            assert g[name].shape[1] == max_len and w[name].shape[1] == 16
            assert rel(g[name], w[name][:, :max_len].numpy()) <= 1e-4
            assert not w[name][:, max_len:].any()


def test_serve_example_runs_on_the_cpu(capsys):
    from repro_torch import serve

    out = serve.main(device="cpu")
    assert out["engine"]["completed"] == 8
    assert all(v["pos"] == 47 for v in out["generate"].values())
    assert "continuous batching: 8 requests" in capsys.readouterr().out
