"""Port parity: the continuous-batching engine (``serving.scheduler``), the
int8 KV cache on the serving path and temperature sampling, on smoke
configs, on the CPU.

The engine's tokens equal the sequential ``generate``'s (the port's and the
reference's), and each request's logits its batch-1 run's within 1e-4 of
max |logit| in fp32.  The int8 cache is held to the reference's own limits
against fp32 (rtol 0.1, atol 0.15 and 0.2, the same greedy tokens) on the
reference test's own inputs, and a decode from an int8 cache that the
reference prefilled to 1e-4.
"""

import dataclasses

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
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serving import steps as tsteps  # noqa: E402
from repro_torch.serving.scheduler import (  # noqa: E402
    ContinuousBatchingEngine,
    Request,
)

MODELS = ["qwen3-8b", "recurrentgemma-2b", "xlstm-1.3b"]
B, S, MAX_LEN, NEW = 2, 20, 28, 4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _rel(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def models():
    """Per smoke config: (reference cfg, port cfg, reference params, port
    params, prompts (B, S))."""
    out = {}
    for i, name in enumerate(MODELS):
        jc, tc = j_smoke(name), configs.get_smoke_config(name)
        jp = jt.init_model(jax.random.PRNGKey(i), jc)
        tp = convert.model_from_numpy(_np_tree(jp), tc, "cpu")
        tokens = np.random.default_rng(i).integers(0, jc.vocab_size, (B, S))
        out[name] = (jc, tc, jp, tp, tokens)
    return out


@pytest.mark.parametrize("name", ["qwen3-8b", "h2o-danube-3-4b", "gemma-7b"])
def test_quantized_decode_close_to_fp(name):
    """The reference's ``test_quantized_decode_close_to_fp`` on its own
    inputs (weights from PRNGKey(0), tokens from PRNGKey(1), carried into
    the port), at its limits; the greedy tokens agree."""
    jc = j_smoke(name)
    tc = configs.get_smoke_config(name)
    tc_q = dataclasses.replace(tc, kv_quant=True)
    tp = convert.model_from_numpy(
        _np_tree(jt.init_model(jax.random.PRNGKey(0), jc)), tc, "cpu")
    tok = torch.tensor(np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (2, 20), 0, jc.vocab_size))).long()
    lg_fp, cache_fp = tt.prefill(tp, tc, tok, 28, cache_dtype=torch.float32)
    lg_q, cache_q = tt.prefill(tp, tc_q, tok, 28)
    assert cache_q["layers"][0]["k"].q.dtype == torch.int8
    np.testing.assert_allclose(lg_q.numpy(), lg_fp.numpy(), rtol=0.1,
                               atol=0.15)
    nt = lg_fp.argmax(-1)
    d_fp, _ = tt.decode_step(tp, tc, nt, cache_fp)
    d_q, _ = tt.decode_step(tp, tc_q, nt, cache_q)
    assert torch.equal(d_q.argmax(-1), d_fp.argmax(-1))
    np.testing.assert_allclose(d_q.numpy(), d_fp.numpy(), rtol=0.1, atol=0.2)


def test_quantized_decode_from_the_reference_cache(models):
    """An int8 cache that the reference prefilled, decoded on by both
    packages: the cached int8 lines are the same, so the logits agree at
    the fp32 limit."""
    jc, tc, jp, tp, tokens = models["qwen3-8b"]
    jc_q, tc_q = (dataclasses.replace(c, kv_quant=True) for c in (jc, tc))
    logits, cache = jt.prefill(jp, jc_q, jnp.asarray(tokens), MAX_LEN)
    nt = jnp.argmax(logits, -1).astype(jnp.int32)
    want, _ = jt.decode_step(jp, jc_q, nt, cache)
    got, _ = tt.decode_step(tp, tc_q, torch.tensor(np.asarray(nt)).long(),
                            convert.cache_from_numpy(_np_tree(cache), tc_q,
                                                     "cpu"))
    assert _rel(got, want) <= 1e-4


# --- the continuous-batching engine, as the reference's tests ------------------

def _prompt(cfg, seed, n):
    return torch.randint(0, cfg.vocab_size, (n,),
                         generator=torch.Generator().manual_seed(seed))


def _greedy_rows(params, cfg, prompt, max_new, max_len):
    """Batch-1 greedy decoding with fp32 caches, as ``generate`` runs it:
    (the tokens, the (1, vocab) logits each was taken from)."""
    lg, cache = tt.prefill(params, cfg, prompt, max_len,
                                    cache_dtype=torch.float32)
    toks, rows = [], []
    for i in range(max_new):
        if i:
            lg, cache = tt.decode_step(
                params, cfg, torch.tensor([[toks[-1]]], device=lg.device),
                cache)
        rows.append(lg[:, -1])
        toks.append(int(lg[0, -1].argmax()))
    return toks, rows


def test_engine_completes_more_requests_than_slots(models):
    _, tc, _, tp, _ = models["qwen3-8b"]
    eng = ContinuousBatchingEngine(tp, tc, batch_slots=2, max_len=48,
                                   device="cpu")
    for rid in range(5):
        eng.submit(Request(rid=rid, prompt=_prompt(tc, rid, 6 + rid),
                           max_new=4))
    stats = eng.run()
    assert stats.completed == 5
    assert stats.prefills == 5
    assert stats.decoded_tokens == 5 * 4


@pytest.mark.parametrize("name", ["qwen3-8b", "recurrentgemma-2b",
                                  "xlstm-1.3b"])
def test_engine_matches_sequential_generation(models, name):
    """Tokens from the batched engine equal per-request greedy decoding;
    each request's logits equal its batch-1 ``generate``'s within 1e-4
    (fp32 caches: with bf16 ones, a k that the batched and the batch-1
    products round to neighbouring bf16 values moves logits by ~6e-4)."""
    _, tc, _, tp, _ = models[name]
    prompts = [_prompt(tc, i, 8 + 5 * i) for i in range(3)]
    eng = ContinuousBatchingEngine(tp, tc, batch_slots=3, max_len=32,
                                   cache_dtype=torch.float32, device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new=5, logits=[])
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    for r, p in zip(reqs, prompts):
        ref, rows = _greedy_rows(tp, tc, p[None], max_new=5, max_len=32)
        assert r.output == ref
        assert ref == tsteps.generate(tp, tc, p[None], max_new=5, max_len=32,
                                      cache_dtype=torch.float32)[0][0].tolist()
        assert len(r.logits) == 5
        for got, want in zip(r.logits, rows):
            assert _rel(got, want[0].numpy()) <= 1e-4


def test_engine_matches_the_reference_generate(models):
    """The port's engine emits the tokens of the reference's sequential
    ``generate`` (bf16 caches, the engine's default)."""
    jc, tc, jp, tp, _ = models["qwen3-8b"]
    prompts = [_prompt(tc, 10 + i, 6 + 3 * i) for i in range(4)]
    eng = ContinuousBatchingEngine(tp, tc, batch_slots=2, max_len=32,
                                   device="cpu")
    reqs = [Request(rid=i, prompt=p, max_new=4 + i % 2)
            for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    for r, p in zip(reqs, prompts):
        want, _ = jsteps.generate(jp, jc, jnp.asarray(p.numpy())[None],
                                  max_new=r.max_new, max_len=32)
        assert r.output == np.asarray(want[0]).tolist()


def test_engine_eos_frees_slot_early(models):
    _, tc, _, tp, _ = models["qwen3-8b"]
    eng = ContinuousBatchingEngine(tp, tc, batch_slots=1, max_len=32,
                                   device="cpu")
    prompt = _prompt(tc, 0, 6)
    ref, _ = tsteps.generate(tp, tc, prompt[None], max_new=1, max_len=32)
    eos = int(ref[0, 0])
    eng.submit(Request(rid=0, prompt=prompt, max_new=10, eos_id=eos))
    eng.submit(Request(rid=1, prompt=prompt, max_new=2))
    stats = eng.run()
    assert stats.completed == 2
    assert stats.decoded_tokens == 1 + 2  # early EOS + second request


def test_engine_idle_slots_run_past_max_len(models):
    """An idle slot keeps decoding after its request ends; its position may
    pass max_len, and its writes are dropped there (as the reference's
    scatter drops them) instead of failing."""
    _, tc, _, tp, _ = models["qwen3-8b"]
    eng = ContinuousBatchingEngine(tp, tc, batch_slots=2, max_len=12,
                                   device="cpu")
    eng.submit(Request(rid=0, prompt=_prompt(tc, 0, 10), max_new=2))
    eng.submit(Request(rid=1, prompt=_prompt(tc, 1, 2), max_new=10))
    stats = eng.run()
    assert stats.completed == 2
    assert int(eng.cache["pos"][0]) > 12


def test_generate_samples_from_a_generator(models):
    """Temperature sampling draws from an explicit torch.Generator: the
    same seed gives the same tokens (the reference's jax.random draws are
    not replayed), and the first token is the prefill's argmax, as in the
    reference."""
    _, tc, _, tp, tokens = models["recurrentgemma-2b"]
    runs = [tsteps.generate(tp, tc, torch.tensor(tokens), max_new=NEW,
                            max_len=MAX_LEN, temperature=1.0,
                            generator=torch.Generator().manual_seed(5))[0]
            for _ in range(2)]
    assert torch.equal(runs[0], runs[1])
    greedy = tsteps.generate(tp, tc, torch.tensor(tokens), max_new=1,
                             max_len=MAX_LEN)[0]
    assert torch.equal(runs[0][:, :1], greedy)
    assert bool(((runs[0] >= 0) & (runs[0] < tc.vocab_size)).all())


def test_serve_step_is_one_decode_step(models):
    """``serve_step`` and ``make_serve_step``'s step are ``decode_step``:
    the same logits, positions and cache, from copies of one cache."""
    import copy

    _, tc, _, tp, tokens = models["recurrentgemma-2b"]
    _, cache = tt.prefill(tp, tc, torch.tensor(tokens), MAX_LEN,
                          cache_dtype=torch.float32)
    tok = torch.tensor(tokens[:, -1:])
    want, want_cache = tt.decode_step(tp, tc, tok, copy.deepcopy(cache))
    for step in (lambda c: tsteps.serve_step(tp, tc, tok, c),
                 lambda c: tsteps.make_serve_step(tc)(tp, tok, c)):
        got, got_cache = step(copy.deepcopy(cache))
        assert torch.equal(got, want)
        assert torch.equal(got_cache["pos"], want_cache["pos"])
        assert all(torch.equal(a, b) for a, b in zip(
            tt._leaves(got_cache), tt._leaves(want_cache)))
