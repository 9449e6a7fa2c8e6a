"""Port parity: the training path (``repro_torch/optim``, ``training``,
``data/pipeline.py``'s batches, ``models/transformer.py``'s remat,
``convert.adamw_state_from_numpy`` and ``train_lm.py``).

The reference's weights, batches and optimizer states carry into the port
as numpy (torch cannot replay ``jax.random``), and the port runs on CPU
tensors, so every model block takes its kernel's plain version, as a
training step does on the card.  Limits: AdamW 1e-6 of max; the loss and
every gradient leaf 1e-5 of the leaf's max |reference| in fp32 (the smoke
configs compute in fp32); the train steps and the microbatch split at the
reference test's own limits (``tests/test_training.py``).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import make_batch as j_make_batch  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro.optim import adamw as jadam  # noqa: E402
from repro.optim import schedules as jsched  # noqa: E402
from repro.training import steps as jsteps  # noqa: E402
from repro_torch import checkpoint, configs, convert, train_lm  # noqa: E402
from repro_torch.data import pipeline  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.optim import adamw as tadam  # noqa: E402
from repro_torch.optim import schedules as tsched  # noqa: E402
from repro_torch.training import steps as tsteps  # noqa: E402

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Smoke-size tensors: one torch thread is as fast, and does not fight
    JAX's threads (or the other test workers) for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ("qwen3-8b", "recurrentgemma-2b", "xlstm-1.3b",
         "granite-moe-3b-a800m", "llava-next-34b", "seamless-m4t-large-v2")
B, S = 2, 24


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _walk(port, ref, path=""):
    """(path, port tensor, reference array) for every leaf of the port's
    tree, the reference's leaf found at the same keys."""
    if isinstance(port, dict):
        for k, v in port.items():
            yield from _walk(v, ref[k], f"{path}/{k}")
    elif isinstance(port, (list, tuple)):
        for i, (v, r) in enumerate(zip(port, ref, strict=True)):
            yield from _walk(v, r, f"{path}/{i}")
    else:
        yield path, port, np.asarray(ref)


def _max_rel(got, want) -> float:
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    scale = np.abs(want).max()
    return float(np.abs(got - want).max() / scale) if scale else \
        float(np.abs(got).max())


def _rand_tree(rng, shapes):
    return {k: rng.standard_normal(s).astype(np.float32)
            for k, s in shapes.items()}


# --- optim ------------------------------------------------------------------

@pytest.mark.parametrize("clip,callable_lr", [(1.0, False), (1e3, True),
                                              (0.05, True)])
def test_adamw_matches_the_reference(clip, callable_lr):
    """Five steps on a random tree, both packages from the same numpy:
    parameters, moments, count, grad_norm and lr within 1e-6 of max."""
    rng = np.random.default_rng(0)
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 4, 2)}
    params = _rand_tree(rng, shapes)
    grads = [_rand_tree(rng, shapes) for _ in range(5)]
    lr_j = jsched.cosine_warmup(1e-2, 2, 5) if callable_lr else 1e-2
    lr_t = tsched.cosine_warmup(1e-2, 2, 5) if callable_lr else 1e-2
    jc = jadam.AdamWConfig(lr=lr_j, clip_norm=clip)
    tc = tadam.AdamWConfig(lr=lr_t, clip_norm=clip)
    jp = jax.tree.map(jnp.asarray, params)
    js = jadam.adamw_init(jp)
    tp = {k: torch.tensor(v) for k, v in params.items()}
    ts = tadam.adamw_init(tp)
    for g in grads:
        jp, js, jm = jadam.adamw_update(jax.tree.map(jnp.asarray, g), js, jp,
                                        jc)
        tp, ts, tm = tadam.adamw_update(
            {k: torch.tensor(v) for k, v in g.items()}, ts, tp, tc)
        for key in ("grad_norm", "lr"):
            assert abs(float(tm[key]) - float(jm[key])) <= \
                1e-6 * abs(float(jm[key]))
    assert int(ts.count) == int(js.count) == 5
    for tree_t, tree_j in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for path, got, want in _walk(tree_t, _np_tree(tree_j)):
            assert _max_rel(got, want) <= 1e-6, path


def test_adamw_reports_the_norm_before_clipping():
    params = {"w": torch.zeros(3)}
    _, _, m = tadam.adamw_update({"w": torch.full((3,), 100.0)},
                                 tadam.adamw_init(params), params,
                                 tadam.AdamWConfig(lr=0.0, clip_norm=1.0))
    assert float(m["grad_norm"]) > 100


def test_cosine_warmup_matches_the_reference():
    j = jsched.cosine_warmup(3e-3, 10, 100)
    t = tsched.cosine_warmup(3e-3, 10, 100)
    steps = np.arange(121)
    want = np.asarray(jax.vmap(j)(jnp.asarray(steps)))
    got = np.array([float(t(torch.tensor(s))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert float(t(0)) == 0.0 and float(t(5)) == pytest.approx(1.5e-3)


# --- the loss -----------------------------------------------------------------

def test_chunked_cross_entropy_matches_the_reference():
    """A ragged last chunk (S 37, chunk 8), -1 labels, a softcap: the summed
    nll, the count and the gradient with respect to the hidden state."""
    cfg_j = dataclasses.replace(j_smoke("gemma-7b"), logits_softcap=30.0)
    cfg_t = dataclasses.replace(configs.get_smoke_config("gemma-7b"),
                                logits_softcap=30.0)
    rng = np.random.default_rng(1)
    V, d = 50, 16
    table = rng.standard_normal((V, d)).astype(np.float32)
    hidden = rng.standard_normal((2, 37, d)).astype(np.float32)
    labels = rng.integers(0, V, (2, 37)).astype(np.int32)
    labels[0, 5:9] = -1
    labels[1, -3:] = -1

    def j_ce(h):
        return jsteps.chunked_cross_entropy({"table": jnp.asarray(table)},
                                            cfg_j, h, jnp.asarray(labels),
                                            chunk=8)

    (j_tot, j_cnt), j_dh = jax.jit(jax.value_and_grad(
        lambda h: j_ce(h), has_aux=True))(jnp.asarray(hidden))
    h = torch.tensor(hidden, requires_grad=True)
    t_tot, t_cnt = tsteps.chunked_cross_entropy(
        {"table": torch.tensor(table)}, cfg_t, h, torch.tensor(labels),
        chunk=8)
    t_tot.backward()
    t_tot = t_tot.detach()
    assert int(t_cnt) == int(j_cnt) == 2 * 37 - 7
    assert abs(float(t_tot) - float(j_tot)) <= 1e-6 * abs(float(j_tot))
    assert _max_rel(h.grad, j_dh) <= 1e-6


def _frontends(cfg, rng, batch):
    out = {}
    if cfg.family == "vlm":
        out["prefix_embeds"] = 0.1 * rng.standard_normal(
            (batch, cfg.n_prefix_embeddings, cfg.d_model)).astype(np.float32)
    if cfg.family == "audio":
        out["enc_embeds"] = 0.1 * rng.standard_normal(
            (batch, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def _pair(arch, seed=0, batch=B, seq=S, step=0):
    """(reference cfg, port cfg, reference params, port params, numpy
    batch): the reference's weights and its pipeline's batch."""
    jc, tc = j_smoke(arch), configs.get_smoke_config(arch)
    jp = jax.jit(jt.init_model, static_argnums=1)(jax.random.PRNGKey(seed), jc)
    tp = convert.model_from_numpy(_np_tree(jp), tc, "cpu")
    data = JDataConfig(vocab_size=jc.vocab_size, seq_len=seq,
                       global_batch=batch, seed=seed)
    nb = _np_tree(j_make_batch(data, step))
    nb.update(_frontends(jc, np.random.default_rng(seed), batch))
    return jc, tc, jp, tp, nb


def _torch_batch(nb):
    return {k: torch.tensor(v) for k, v in nb.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_every_gradient_leaf_match_the_reference(arch):
    """``loss_fn`` and each gradient leaf against ``jax.value_and_grad`` of
    the reference's, on its weights and batch (the port's plain forward:
    the same path as a train step on the card)."""
    jc, tc, jp, tp, nb = _pair(arch)
    (j_loss, j_m), j_g = jax.jit(
        jax.value_and_grad(jsteps.loss_fn, has_aux=True),
        static_argnums=1)(jp, jc, jax.tree.map(jnp.asarray, nb))
    loss, m, grads = tsteps.loss_and_grads(tp, tc, _torch_batch(nb))
    assert abs(float(loss) - float(j_loss)) <= 1e-5 * abs(float(j_loss))
    assert abs(float(m["aux"]) - float(j_m["aux"])) <= \
        1e-5 * max(abs(float(j_m["aux"])), 1e-6)
    assert int(m["tokens"]) == int(j_m["tokens"])
    want = convert.model_from_numpy(_np_tree(j_g), tc, "cpu")
    worst = {path: _max_rel(got, ref) for path, got, ref in
             _walk(grads, _np_tree(want))}
    assert max(worst.values()) <= 1e-5, sorted(
        worst.items(), key=lambda kv: -kv[1])[:5]


# parameters after a few AdamW steps: a tenth of the reference test's own
# limit for parameters after a step (1e-3 at lr 1e-3, tests/test_training.py);
# m / sqrt(v) turns a gradient element at roundoff level into a step of up
# to lr, so elementwise agreement is bounded by lr, not by fp32
PARAM_TOL = 1e-4


def test_train_steps_match_the_reference():
    """Three ``train_step``s from the reference's weights; then the
    reference's mid-run AdamW state carried over
    (``convert.adamw_state_from_numpy``) and one more step from it."""
    jc, tc, jp, tp, _ = _pair("qwen3-8b", seed=2)
    data = JDataConfig(vocab_size=jc.vocab_size, seq_len=S, global_batch=4,
                       seed=2)
    jo = jadam.AdamWConfig(lr=jsched.cosine_warmup(1e-3, 2, 4))
    to = tadam.AdamWConfig(lr=tsched.cosine_warmup(1e-3, 2, 4))
    js, ts = jadam.adamw_init(jp), tadam.adamw_init(tp)
    j_step = jax.jit(jsteps.make_train_step(jc, jo))
    for step in range(3):
        nb = _np_tree(j_make_batch(data, step))
        jp, js, jm = j_step(jp, js, jax.tree.map(jnp.asarray, nb))
        tp, ts, tm = tsteps.train_step(tp, ts, _torch_batch(nb), tc, to)
        for key in ("loss", "ce", "grad_norm", "lr"):
            assert abs(float(tm[key]) - float(jm[key])) <= \
                2e-5 * abs(float(jm[key])), (step, key)
    want = convert.model_from_numpy(_np_tree(jp), tc, "cpu")
    for path, got, ref in _walk(tp, _np_tree(want)):
        assert np.abs(got.numpy() - ref).max() <= PARAM_TOL, path
    # the reference's state after step 3 carried over, one more step each
    tp = convert.model_from_numpy(_np_tree(jp), tc, "cpu")
    ts = convert.adamw_state_from_numpy(_np_tree(js), tp, "cpu")
    assert int(ts.count) == 3 and ts.count.dtype == torch.int32
    nb = _np_tree(j_make_batch(data, 3))
    jp, js, _ = j_step(jp, js, jax.tree.map(jnp.asarray, nb))
    tp, ts, _ = tsteps.train_step(tp, ts, _torch_batch(nb), tc, to)
    want = convert.model_from_numpy(_np_tree(jp), tc, "cpu")
    for path, got, ref in _walk(tp, _np_tree(want)):
        assert np.abs(got.numpy() - ref).max() <= PARAM_TOL, path
    m_want = convert.model_from_numpy(_np_tree(js.m), tc, "cpu")
    for path, got, ref in _walk(ts.m, _np_tree(m_want)):
        assert _max_rel(got, ref) <= 1e-4, path


def test_microbatches_match_the_full_batch():
    """The reference test's limits: the loss within 2e-4, every parameter
    after one step within 1e-3 (``tests/test_training.py``); and the
    accumulated gradient against the full batch's."""
    tc = configs.get_smoke_config("qwen3-8b")
    params = tt.init_model(0, tc, device="cpu")
    batch = pipeline.make_batch(pipeline.DataConfig(
        vocab_size=tc.vocab_size, seq_len=32, global_batch=8), 0)
    ocfg = tadam.AdamWConfig(lr=1e-3)
    l1, _, g1 = tsteps.loss_and_grads(params, tc, batch, 1)
    l4, m4, g4 = tsteps.loss_and_grads(params, tc, batch, 4)
    num = sum(float(torch.sum((a - b) ** 2)) for a, b in
              zip(tadam.tree_leaves(g4), tadam.tree_leaves(g1)))
    den = sum(float(torch.sum(b ** 2)) for b in tadam.tree_leaves(g1))
    assert (num / den) ** 0.5 <= 1e-5
    assert int(m4["tokens"]) == 8 * 32
    p1 = tt.init_model(0, tc, device="cpu")
    p4 = tt.init_model(0, tc, device="cpu")
    p1, _, m1 = tsteps.train_step(p1, tadam.adamw_init(p1), batch, tc, ocfg)
    p4, _, m4 = tsteps.train_step(p4, tadam.adamw_init(p4), batch, tc, ocfg,
                                  microbatches=4)
    assert abs(float(m1["loss"]) - float(m4["loss"])) < 2e-4
    assert abs(float(l1) - float(l4)) < 2e-4
    diff = max(float(torch.max(torch.abs(a - b))) for a, b in
               zip(tadam.tree_leaves(p1), tadam.tree_leaves(p4)))
    assert diff < 1e-3, diff


@pytest.mark.parametrize("arch", ["recurrentgemma-2b", "granite-moe-3b-a800m"])
def test_remat_changes_no_value(arch):
    """Cycles under ``torch.utils.checkpoint`` (recurrentgemma: one
    (rglru, rglru, swa) cycle and two trailing blocks): the loss and every
    gradient bit-equal to the run without remat."""
    tc = dataclasses.replace(configs.get_smoke_config(arch), n_layers=5)
    params = tt.init_model(3, tc, device="cpu")
    batch = pipeline.make_batch(pipeline.DataConfig(
        vocab_size=tc.vocab_size, seq_len=S, global_batch=B, seed=3), 0)
    off = tsteps.loss_and_grads(params, tc, batch)
    on = tsteps.loss_and_grads(params, dataclasses.replace(tc, remat=True),
                               batch)
    assert torch.equal(off[0], on[0])
    assert all(torch.equal(a, b) for a, b in
               zip(tadam.tree_leaves(off[2]), tadam.tree_leaves(on[2])))


def test_make_batch_is_deterministic_and_learnable():
    """As the reference test checks its own pipeline: the same (seed,
    step) gives the same batch, another step another one, and the Markov
    structure puts the unigram entropy well below uniform."""
    data = pipeline.DataConfig(vocab_size=256, seq_len=64, global_batch=4,
                               seed=3)
    b1, b2 = pipeline.make_batch(data, 7), pipeline.make_batch(data, 7)
    assert torch.equal(b1["tokens"], b2["tokens"])
    assert not torch.equal(b1["tokens"], pipeline.make_batch(data, 8)["tokens"])
    assert b1["tokens"].dtype == torch.int32
    assert torch.equal(b1["labels"][:, :-1], b1["tokens"][:, 1:])
    assert bool((b1["labels"][:, -1] == -1).all())
    _, counts = np.unique(b1["tokens"].numpy().ravel(), return_counts=True)
    p = counts / counts.sum()
    assert -(p * np.log(p)).sum() < np.log(256) * 0.95
    assert int(b1["tokens"].max()) < 256
    stream = pipeline.batches(data, start_step=7)
    assert torch.equal(next(stream)["tokens"], b1["tokens"])


def test_checkpoint_round_trip_then_the_next_step_is_bit_equal(tmp_path):
    """Parameters and the AdamW state saved after two steps and restored:
    the third step from the restored copy equals the third step from the
    live one, bit for bit."""
    tc = configs.get_smoke_config("qwen3-8b")
    data = pipeline.DataConfig(vocab_size=tc.vocab_size, seq_len=S,
                               global_batch=B)
    ocfg = tadam.AdamWConfig(lr=tsched.cosine_warmup(1e-3, 1, 3))
    params = tt.init_model(1, tc, device="cpu")
    opt = tadam.adamw_init(params)
    for step in range(2):
        params, opt, _ = tsteps.train_step(
            params, opt, pipeline.make_batch(data, step), tc, ocfg)
    checkpoint.save_checkpoint(tmp_path, 2, {"params": params, "opt": opt},
                               {"arch": tc.name})
    like = {"params": tt.init_model(9, tc, device="cpu"),
            "opt": tadam.adamw_init(tt.init_model(9, tc, device="cpu"))}
    restored, meta = checkpoint.load_checkpoint(tmp_path, like)
    assert meta["step"] == 2
    rp, ro = restored["params"], restored["opt"]
    assert int(ro.count) == 2
    batch = pipeline.make_batch(data, 2)
    params, opt, m1 = tsteps.train_step(params, opt, batch, tc, ocfg)
    rp, ro, m2 = tsteps.train_step(rp, ro, batch, tc, ocfg)
    assert torch.equal(m1["loss"], m2["loss"])
    for a, b in zip(tadam.tree_leaves((params, opt.m, opt.v)),
                    tadam.tree_leaves((rp, ro.m, ro.v))):
        assert torch.equal(a, b)


def test_train_lm_example_runs():
    """The example at a few steps: the loss falls by more than 0.5, and the
    checkpoint round trip gives the same loss."""
    out = train_lm.main(["--steps", "30", "--batch", "4", "--seq", "48",
                         "--device", "cpu"])
    assert out["losses"][-1] < out["losses"][0] - 0.5
    assert np.isfinite(out["restored_loss"])
