"""Port parity: ``repro_torch/models/sharding.py`` (the layout helpers and
the active mesh), the model axis of ``core/mesh.py`` (axes that hold no
agents, axis groups, a differentiable all-reduce) and
``models/moe.py::moe_ffn_shardmap``.

The helpers' spec choices are held against the reference's own code (its
``maybe_shard`` replaced by a recorder of the spec it is handed).  The
expert-parallel MoE runs in gloo worlds on the CPU (``mesh.spawn``, world
functions in ``tests/torch_sharded_worlds.py``), 4 ranks on (data 2, model
2) and 2 on (1, 2); the gathered output and the world's summed gradients
are held against ``moe_ffn_gspmd`` on the whole batch within 1e-5 of max
(fp32), aux exactly.  A DMTL fit with a ``model`` axis that holds no agents
is bit-equal on every model coordinate and to the fit on the (4,) mesh.
"""

import dataclasses
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test process: xdist's workers share the cores

import jax.numpy as jnp  # noqa: E402

import torch_sharded_worlds as worlds  # noqa: E402
from repro.models import sharding as jsh  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.core import engine, mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.models import sharding as tsh  # noqa: E402

AXES = [("data", "model"), ("pod", "data", "model"), ("data",), ("a",)]
SPECS = [jsh.P(("pod", "data"), "model", None), jsh.P(None, "model"),
         jsh.P("data", ("model", "pod")), jsh.P(("pod",), None, "data")]


def _fake_mesh(names):
    """A Mesh value to make active; the helpers read only its axes."""
    return mesh.Mesh(axis_names=names, sizes=(2,) * len(names), group=None,
                     rank=0, device=torch.device("cpu"), backend="gloo")


@pytest.mark.parametrize("spec,names", list(itertools.product(SPECS, AXES)))
def test_filter_spec_matches_the_reference(spec, names):
    got = tsh._filter_spec(tsh.P(*spec), names)
    assert tuple(got) == tuple(jsh._filter_spec(spec, names))
    assert isinstance(got, tsh.P)


def _reference_spec(monkeypatch, helper, x):
    """The spec the reference's ``helper`` hands ``maybe_shard``."""
    seen = []
    monkeypatch.setattr(jsh, "maybe_shard",
                        lambda arr, spec: seen.append(spec) or arr)
    getattr(jsh, helper)(x)
    return seen[0]


@pytest.mark.parametrize("helper,shape,no_seq", [
    ("shard_batch_seq", (2, 1024, 8), "0"),
    ("shard_batch_seq", (2, 1023, 8), "0"),
    ("shard_batch_seq", (2, 4096, 8, 4), "1"),
    ("shard_batch_seq", (2, 4096), "0"),
    ("shard_heads", (2, 16, 4, 8), "0"),
    ("shard_ff", (2, 16, 32), "0"),
])
@pytest.mark.parametrize("names", AXES[:3])
def test_spec_choices_follow_the_reference(monkeypatch, helper, shape,
                                           no_seq, names):
    """Batch over the data axes, S over model from 1024 positions unless
    ``REPRO_NO_SEQ_SHARD=1``, heads and ff over model; filtered to the
    active mesh's axes, None without a mesh.  Every helper returns x
    itself, with or without a mesh."""
    monkeypatch.setenv("REPRO_NO_SEQ_SHARD", no_seq)
    want = _reference_spec(monkeypatch, helper, jnp.zeros(shape))
    x = torch.zeros(shape)
    spec_fn = getattr(tsh, "spec_for_" + helper[len("shard_"):])
    assert spec_fn(x) is None and tsh._active_mesh() is None
    assert getattr(tsh, helper)(x) is x
    with tsh.use_mesh(_fake_mesh(names)) as m:
        assert tsh._active_mesh() is m
        assert tuple(spec_fn(x)) == tuple(jsh._filter_spec(want, names))
        assert getattr(tsh, helper)(x) is x
        assert tsh.maybe_shard(x, tsh.P("data")) is x
    assert tsh._active_mesh() is None


def _moe_inputs(B=4, S=16, seed=0):
    cfg = dataclasses.replace(configs.get_smoke_config("granite-moe-3b-a800m"),
                              d_model=64, moe_d_ff=32, n_experts=4,
                              n_experts_active=2, moe_impl="shardmap")
    gen = torch.Generator().manual_seed(seed)
    params = moe.moe_init(gen, cfg)
    x = torch.randn((B, S, cfg.d_model), generator=gen)
    return cfg, params, x


def test_moe_ffn_takes_shardmap_only_under_a_mesh():
    """Without an active mesh every ``moe_impl`` runs ``moe_ffn_gspmd``;
    under one, ``"gspmd"`` still does (``moe_ffn_shardmap`` itself needs
    a ``model`` axis)."""
    cfg, params, x = _moe_inputs()
    want, aux = moe.moe_ffn_gspmd(params, cfg, x)
    got, got_aux = moe.moe_ffn(params, cfg, x)
    assert torch.equal(got, want) and torch.equal(got_aux, aux)
    with tsh.use_mesh(_fake_mesh(("data", "model"))):
        got = moe.moe_ffn(params, dataclasses.replace(cfg, moe_impl="gspmd"),
                          x)[0]
        assert torch.equal(got, want)
    with tsh.use_mesh(_fake_mesh(("data",))):
        with pytest.raises(ValueError, match="'model' axis"):
            moe.moe_ffn(params, cfg, x)


def _gspmd_grads(cfg, params, x):
    leaves = {k: v["w"].clone().requires_grad_() for k, v in params.items()}
    out, aux = moe.moe_ffn_gspmd({k: {"w": w} for k, w in leaves.items()},
                                 cfg, x)
    loss = out.square().sum() + aux
    return out.detach(), aux.detach(), dict(zip(leaves, torch.autograd.grad(
        loss, list(leaves.values()))))


def _max_rel(got, want):
    return float((got - want).abs().max() / want.abs().max())


@pytest.fixture(scope="module", params=[(2, 2), (1, 2)], ids=str)
def moe_world(request):
    cfg, params, x = _moe_inputs()
    inp = {"mesh": request.param, "cfg": cfg, "x": x.numpy(),
           "params": {k: v["w"].numpy() for k, v in params.items()}}
    res = mesh.spawn(worlds.moe_shardmap_world, int(np.prod(request.param)),
                     args=(inp,), timeout_s=300)
    return request.param, cfg, params, x, res


def test_shardmap_output_matches_gspmd(moe_world):
    (n_data, n_model), cfg, params, x, res = moe_world
    want, aux, _ = _gspmd_grads(cfg, params, x)
    B, S, d = x.shape
    got = torch.full_like(want, float("nan"))
    bl, dl = B // n_data, d // n_model
    for r in res:
        i, j = r["coords"]
        assert r["out"].shape == (bl, S, dl)
        got[i * bl:(i + 1) * bl, :, j * dl:(j + 1) * dl] = r["out"]
        assert torch.equal(r["aux"], aux)
        assert r["gspmd_shape"] == (B, S, d)
    assert _max_rel(got, want) <= 1e-5


def test_shardmap_gradients_match_gspmd(moe_world):
    """Each rank's gradient covers its F slice of the experts and its batch
    rows; summed over the world, every parameter's gradient is the whole
    batch's."""
    _, cfg, params, x, res = moe_world
    _, _, want = _gspmd_grads(cfg, params, x)
    for key, w in want.items():
        got = sum(r["grads"][key] for r in res)
        assert _max_rel(got, w) <= 1e-5, key


def _dmtl_inputs():
    rng = np.random.default_rng(5)
    L, D, N = 8, 2, 24
    H = (rng.standard_normal((4, N, L)) / np.sqrt(L)).astype(np.float32)
    T = rng.standard_normal((4, N, D)).astype(np.float32)
    cfg = engine.ConsensusConfig(r=1, iters=10, tau=2.0, zeta=1.0,
                                 delta=10.0)
    return {"H": H, "T": T, "cfg": cfg}


@pytest.fixture(scope="module")
def dmtl_worlds():
    inp = _dmtl_inputs()
    wide = mesh.spawn(worlds.dmtl_model_axis_world, 8, timeout_s=300,
                      args=({**inp, "mesh": (4, 2),
                             "names": ("data", "model")},))
    flat = mesh.spawn(worlds.dmtl_model_axis_world, 4, timeout_s=300,
                      args=({**inp, "mesh": (4,), "names": ("data",)},))
    return wide, flat


def _bitwise(got, want):
    assert torch.equal(got["U"], want["U"]) and torch.equal(got["A"],
                                                            want["A"])
    assert sorted(got["diags"]) == sorted(want["diags"])
    for key in want["diags"]:
        assert torch.equal(got["diags"][key], want["diags"][key]), key


@pytest.mark.parametrize("case", ["ring", "star"])
def test_model_axis_replicates_the_agents_bitwise(dmtl_worlds, case):
    """Agents on "data" of a (data 4, model 2) mesh: both model coordinates
    run the same 4 agents, and each gets the (4,) mesh's fit bit for bit
    (U, A and every diagnostic)."""
    wide, flat = dmtl_worlds
    assert [r["coords"] for r in wide] == [(i, j) for i in range(4)
                                           for j in range(2)]
    assert wide[0][case]["U"].shape[0] == 4
    for r in wide:
        _bitwise(r[case], flat[0][case])
