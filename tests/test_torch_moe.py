"""Port parity: the MoE FFN (``repro_torch/models/moe.py``) and the ``moe``
kind of the model stack, on granite-moe-3b-a800m's and qwen3-moe-30b-a3b's
smoke configs, on the CPU.

The reference's weights carry into the port through
``convert.model_from_numpy``, and the same numpy inputs go through both
packages.  Routing is held exactly: the capacity, each assignment's expert,
its keep bit and its slot.  A flip of a near-tie in top-k would change a
token's output by O(1), so each routing test asserts the smallest gap
between the K-th and (K+1)-th router probability in its inputs above
``GAP_FLOOR`` (the readings are in ``GAP``).  ``moe_ffn`` agrees with the reference's
``moe_ffn_gspmd`` within 1e-5 of max |reference| in fp32 and 3e-2 in bf16,
and with the port's per-expert ``moe_ffn_by_expert`` within 1e-6 (fp32)
and 1e-2 (bf16: one rounding of the combine apart); the aux loss within
1e-6.  Blocks, ``encode``, ``prefill`` and ``decode_step`` (fp32 caches)
within 1e-4 of max |reference|; decode against the forward within 1e-4
(the smoke configs' ``capacity_factor`` 4 drops nothing).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test process: xdist's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.configs import get_smoke_config as j_smoke  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jt  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as tt  # noqa: E402
from repro_torch.serving import steps as tsteps  # noqa: E402
from repro_torch.serving.scheduler import (  # noqa: E402
    ContinuousBatchingEngine,
    Request,
)

MODELS = ["granite-moe-3b-a800m", "qwen3-moe-30b-a3b"]
B, S = 3, 17
DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 3e-2)}
# a wider router than the smoke configs': 16 experts, top-4
WIDE = {"n_experts": 16, "n_experts_active": 4}
# the smallest K-th/(K+1)-th router probability gap in each routing test's
# inputs, as read; each must stay above GAP_FLOOR, 10x the ~2e-7 by which
# the two packages' fp32 probabilities can part (logits of d = 128 terms
# summed in another order)
GAP = {"granite": 8.0e-4, "qwen3": 8.0e-4, "wide": 2.0e-4, "overflow": 4.7e-6}
GAP_FLOOR = 2e-6


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _cfgs(name, **kw):
    return (dataclasses.replace(j_smoke(name), **kw),
            dataclasses.replace(configs.get_smoke_config(name), **kw))


def _moe_params(jc, tc, seed):
    jp = jmoe.moe_init(jax.random.PRNGKey(seed), jc)
    return jp, convert._tree_tensors(_np_tree(jp), "cpu")


def _x(jc, seed, shape=(B, S)):
    return np.random.default_rng(seed).standard_normal(
        shape + (jc.d_model,)).astype(np.float32)


@jax.jit
def _j_probs(jp, x):
    logits = jnp.einsum("bsd,de->bse", x, jp["router"]["w"].astype(x.dtype),
                        preferred_element_type=jnp.float32)
    return jax.nn.softmax(logits, axis=-1)


# the reference's functions, compiled once a config (eager JAX compiles
# each op at each new shape)
_j_route = jax.jit(jmoe._route, static_argnums=1)
_j_moe_ffn = jax.jit(jmoe.moe_ffn_gspmd, static_argnums=1)


def _reference_top(jp, jc, x):
    """The reference's router as ``_route`` computes it (its top_e is not
    returned): (probs, top_e)."""
    probs = _j_probs(jp, x)
    return probs, jax.lax.top_k(probs, jc.n_experts_active)[1]


def _kth_gap(probs, k):
    """The smallest gap between the k-th and (k+1)-th probability."""
    p = -np.sort(-np.asarray(probs), axis=-1)
    return float((p[..., k - 1] - p[..., k]).min())


@pytest.fixture(scope="module")
def models():
    """Per smoke config: (reference cfg, port cfg, reference params, port
    params, tokens (2, 24))."""
    out = {}
    for i, name in enumerate(MODELS):
        jc, tc = _cfgs(name)
        jp = jt.init_model(jax.random.PRNGKey(i), jc)
        tp = convert.model_from_numpy(_np_tree(jp), tc, "cpu")
        tokens = np.random.default_rng(i).integers(0, jc.vocab_size, (2, 24))
        out[name] = (jc, tc, jp, tp, tokens)
    return out


@pytest.mark.parametrize("s", [1, 7, 4096])
@pytest.mark.parametrize("name", MODELS)
def test_capacity_of_the_published_configs(name, s):
    jc, tc = j_config(name), configs.get_config(name)
    assert tmoe._capacity(tc, s) == jmoe._capacity(jc, s)
    if s == 1:                      # a decode step never drops
        assert tmoe._capacity(tc, s) == tc.n_experts_active


@pytest.mark.parametrize("E,K,cf", [(4, 2, 4.0), (40, 8, 1.25), (128, 8, 1.25),
                                    (128, 8, 0.5), (3, 1, 1.1), (7, 3, 2.3),
                                    (16, 4, 32.0)])
def test_capacity_over_a_grid(E, K, cf):
    """The Python float expression truncated by int, at least K, over
    lengths where s * K / E * cf lands near an integer."""
    jc, tc = _cfgs(MODELS[0], n_experts=E, n_experts_active=K,
                   capacity_factor=cf)
    for s in (1, 2, 3, 5, 7, 10, 17, 100, 333, 1024, 4095, 4096):
        assert tmoe._capacity(tc, s) == jmoe._capacity(jc, s), s


@pytest.mark.parametrize("case", ["granite", "qwen3", "wide"])
def test_route_is_exact_in_fp32(case):
    """top_e, keep and slot equal the reference's; top_p and aux within
    1e-6."""
    name = MODELS[0] if case == "granite" else MODELS[1]
    jc, tc = _cfgs(name, **(WIDE if case == "wide" else {}))
    jp, tp = _moe_params(jc, tc, 3)
    x = _x(jc, 4)
    jslot, jtop_p, jkeep, jaux, jC = _j_route(jp, jc, jnp.asarray(x))
    probs, jtop_e = _reference_top(jp, jc, jnp.asarray(x))
    assert _kth_gap(probs, jc.n_experts_active) >= GAP[case] > GAP_FLOOR
    slot, top_p, keep, aux, C = tmoe._route(tp, tc, torch.tensor(x))
    _, _, top_e = tmoe._router(tp, tc, torch.tensor(x))
    assert C == jC
    np.testing.assert_array_equal(top_e.numpy(), np.asarray(jtop_e))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    np.testing.assert_allclose(top_p.numpy(), np.asarray(jtop_p), atol=1e-6)
    assert abs(float(aux) - float(jaux)) <= 1e-6


def test_route_drops_where_capacity_overflows():
    """capacity_factor 0.5 at 16 experts, top-4, S = 17: C = 4 slots an
    expert, and assignments overflow into slot E * C; slots and keep bits
    equal the reference's, every kept slot is unique, and the outputs
    agree (the overflow row is discarded)."""
    jc, tc = _cfgs(MODELS[0], capacity_factor=0.5, **WIDE)
    jp, tp = _moe_params(jc, tc, 5)
    x = _x(jc, 6)
    jslot, _, jkeep, _, jC = _j_route(jp, jc, jnp.asarray(x))
    probs, _ = _reference_top(jp, jc, jnp.asarray(x))
    assert _kth_gap(probs, jc.n_experts_active) >= GAP["overflow"] > \
        GAP_FLOOR
    slot, _, keep, _, C = tmoe._route(tp, tc, torch.tensor(x))
    assert C == int(jC) == 4 and not bool(keep.all())
    np.testing.assert_array_equal(keep.numpy(), np.asarray(jkeep))
    np.testing.assert_array_equal(slot.numpy(), np.asarray(jslot))
    for b in range(B):
        kept = slot[b][keep[b]]
        assert kept.unique().numel() == kept.numel()
        assert bool((slot[b][~keep[b]] == tc.n_experts * C).all())
    want, _ = _j_moe_ffn(jp, jc, jnp.asarray(x))
    got, _ = tmoe.moe_ffn(tp, tc, torch.tensor(x))
    assert _rel(got, want) <= 1e-5
    assert _rel(tmoe.moe_ffn_by_expert(tp, tc, torch.tensor(x))[0],
                got) <= 1e-6


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", MODELS)
def test_moe_ffn_matches_the_reference(name, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    jc, tc = _cfgs(name, dtype=dtype)
    jp, tp = _moe_params(jc, tc, 7)
    x = _x(jc, 8)
    want, jaux = _j_moe_ffn(jp, jc, jnp.asarray(x, jdt))
    for impl in ("gspmd", "shardmap"):      # no mesh: the same formulation
        got, aux = tmoe.moe_ffn(tp, dataclasses.replace(tc, moe_impl=impl),
                                torch.tensor(x).to(tdt))
        assert got.dtype == tdt and got.shape == x.shape
        assert _rel(got, want) <= tol
        assert abs(float(aux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("cf", [4.0, 0.5])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_moe_ffn_matches_by_expert(dtype, cf):
    """The scatter/gather formulation against the per-expert loop on the
    same routing, drop-free and with drops."""
    tdt = DTYPES[dtype][1]
    _, tc = _cfgs(MODELS[1], capacity_factor=cf, **WIDE)
    jc = _cfgs(MODELS[1], capacity_factor=cf, **WIDE)[0]
    _, tp = _moe_params(jc, tc, 9)
    x = torch.tensor(_x(jc, 10)).to(tdt)
    got, aux = tmoe.moe_ffn(tp, tc, x)
    want, aux_e = tmoe.moe_ffn_by_expert(tp, tc, x)
    assert float(aux) == float(aux_e)
    assert _rel(got, want) <= (1e-6 if dtype == "float32" else 1e-2)


@pytest.mark.parametrize("name", MODELS)
def test_moe_block_matches_the_reference(models, name):
    """One ``moe`` block in train mode: attention, ln2, the MoE FFN; its aux
    is the MoE's."""
    jc, tc, jp, tp, _ = models[name]
    x = _x(jc, 11)
    pos = np.tile(np.arange(S)[None], (B, 1))
    jblock = jax.tree.map(lambda a: a[0], jp["cycles"][0])
    want, _, jaux = jax.jit(jt.block_apply, static_argnums=(1, 2))(
        jblock, jc, "moe", jnp.asarray(x), positions=jnp.asarray(pos))
    got, entry, aux = tt.block_apply(tp["layers"][0], tc, "moe",
                                     torch.tensor(x))
    assert entry is None
    assert _rel(got, want) <= 1e-5
    assert abs(float(aux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("name", MODELS)
def test_encode_forward_and_aux_match_the_reference(models, name):
    jc, tc, jp, tp, tokens = models[name]
    want = jax.jit(jt.encode, static_argnums=1)(jp, jc, jnp.asarray(tokens))
    assert _rel(tt.encode(tp, tc, torch.tensor(tokens)), want) <= 1e-4
    jl, jaux = jax.jit(jt.forward, static_argnums=1)(jp, jc,
                                                     jnp.asarray(tokens))
    tl, aux = tt.forward(tp, tc, torch.tensor(tokens))
    assert _rel(tl, jl) <= 1e-4
    assert aux.dtype == torch.float32 and float(aux) > 0
    assert abs(float(aux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("name", MODELS)
def test_prefill_and_decode_match_the_reference(models, name):
    """fp32 caches: prefill's logits and each of 3 decode steps' against the
    reference's (1e-4), and against the port's own forward (decode ≡
    forward, drop-free)."""
    jc, tc, jp, tp, tokens = models[name]
    jlg, jcache = jax.jit(jt.prefill, static_argnums=(1, 3),
                          static_argnames="cache_dtype")(
        jp, jc, jnp.asarray(tokens), 28, cache_dtype=jnp.float32)
    j_decode = jax.jit(jt.decode_step, static_argnums=1)
    lg, cache = tt.prefill(tp, tc, torch.tensor(tokens), 28,
                           cache_dtype=torch.float32)
    assert _rel(lg, jlg) <= 1e-4
    seq = torch.tensor(tokens)
    for _ in range(3):
        nt = lg[:, -1].argmax(-1, keepdim=True)
        jlg, jcache = j_decode(jp, jc, jnp.asarray(nt.numpy(),
                                                         jnp.int32), jcache)
        lg, cache = tt.decode_step(tp, tc, nt, cache)
        assert _rel(lg, jlg) <= 1e-4
        seq = torch.cat([seq, nt], dim=1)
        full, _ = tt.forward(tp, tc, seq)
        assert _rel(lg[:, 0], full[:, -1]) <= 1e-4
    assert cache["pos"].tolist() == [27, 27]


def test_engine_matches_batch1_generate(models, monkeypatch):
    """The continuous-batching engine (2 slots, 4 ragged requests, fp32
    caches) on granite's smoke config at capacity factor 0.5, where
    prefills drop assignments: routing is per batch row, so each request's
    tokens equal its own batch-1 ``generate``'s and its logits are within
    1e-4."""
    _, tc, _, tp, _ = models[MODELS[0]]
    tc = dataclasses.replace(tc, capacity_factor=0.5)
    rng = np.random.default_rng(12)
    prompts = [torch.tensor(rng.integers(0, tc.vocab_size, n))
               for n in (5, 19, 11, 30)]
    reqs = [Request(rid=i, prompt=p, max_new=2 + i, logits=[])
            for i, p in enumerate(prompts)]
    eng = ContinuousBatchingEngine(tp, tc, 2, 40, cache_dtype=torch.float32,
                                   device="cpu")
    for r in reqs:
        eng.submit(r)
    dropped = []

    def counted(params, cfg, x):
        dropped.append(int((~tmoe._route(params, cfg, x)[2]).sum()))
        return tmoe.moe_ffn(params, cfg, x)

    monkeypatch.setattr(tt, "moe_ffn", counted)
    assert eng.run().completed == 4
    assert sum(dropped) > 0
    for r, p in zip(reqs, prompts):
        toks, _ = tsteps.generate(tp, tc, p[None], r.max_new, 40,
                                  cache_dtype=torch.float32)
        assert r.output == toks[0].tolist()
        lg, cache = tt.prefill(tp, tc, p[None], 40,
                               cache_dtype=torch.float32)
        assert _rel(r.logits[0], lg[0, -1]) <= 1e-4


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_paths(v, prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_paths(v, prefix + (i,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("name,count", [("granite-moe-3b-a800m", 3_298_793_472),
                                        ("qwen3-moe-30b-a3b", 30_532_122_624)])
def test_full_width_parameter_counts(monkeypatch, name, count):
    """``init_model`` at full width and depth, drawn on the meta device (no
    memory), against the reference's ``jax.eval_shape``: every leaf of a
    block in its shape, and the whole count."""
    cfg, jcfg = configs.get_config(name), j_config(name)
    randn = torch.randn
    monkeypatch.setattr(torch, "randn", lambda shape, generator=None,
                        device=None: randn(shape, device="meta"))
    params = tt.init_model(torch.Generator(), cfg)
    shapes = jax.eval_shape(lambda: jt.init_model(jax.random.PRNGKey(0),
                                                  jcfg))
    want = _paths(shapes["cycles"][0])
    got = _paths(params["layers"][0])
    assert set(got) == set(want)
    for path, leaf in got.items():
        assert (cfg.n_layers,) + tuple(leaf.shape) == want[path].shape, path
    assert tt.param_count(params) == count == sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
