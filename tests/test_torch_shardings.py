"""Port parity: ``repro_torch/launch/shardings.py`` against the reference's
``launch/shardings.py``, and the placement helpers.

For all ten architectures at full size (the reference's tree from
``jax.eval_shape``, the port's on the meta device), both production mesh
shapes and both ``fsdp`` choices, every port leaf's spec, filtered spec
and local shape equals the reference's for the same leaf.  The reference
stacks its full layer cycles (``cycles/<j>``, ``encoder``) on a leading
axis, whose spec entry is a leading None; the port's ``layers/<l>`` and
``encoder/<l>`` leaves are not stacked, so the reference's spec without
that None is the port's.  The reference's ``spec_for_leaf`` and
``_filter`` read only ``mesh.shape`` and ``mesh.axis_names``, so a small
stand-in gives them a 512-device mesh without 512 devices; its local
shapes come from ``NamedSharding(AbstractMesh(...)).shard_shape``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test process: xdist's workers share the cores

import jax  # noqa: E402
from jax.sharding import AbstractMesh, NamedSharding  # noqa: E402

from repro.configs import get_config as j_config  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.launch import shardings as jsh  # noqa: E402
from repro.models.transformer import init_model as j_init  # noqa: E402
from repro.optim.adamw import adamw_init as j_adamw_init  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun, shapes  # noqa: E402
from repro_torch.launch import shardings as sh  # noqa: E402
from repro_torch.optim.adamw import adamw_init  # noqa: E402

MESHES = {"single": ((16, 16), ("data", "model")),
          "multi": ((2, 16, 16), ("pod", "data", "model"))}


class _RefMesh:
    """What the reference's rules read of a mesh."""

    def __init__(self, sizes, names):
        self.shape = dict(zip(names, sizes))
        self.axis_names = names


def _ref_leaves(tree) -> dict:
    return {jsh._path_str(p): x
            for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(tree) -> dict:
    out = {}
    sh._map_with_path(lambda p, x: out.__setitem__("/".join(p), x), tree)
    return out


def _ref_place(path: str, cfg) -> list:
    """The port paths of a reference leaf path, and whether it is stacked."""
    pattern = len(cfg.block_pattern)
    n_cycles, _ = divmod(cfg.n_layers, pattern)
    head, _, rest = path.partition("/")
    if head == "cycles":
        j, _, rest = rest.partition("/")
        return [f"layers/{c * pattern + int(j)}/{rest}"
                for c in range(n_cycles)], True
    if head == "rem":
        i, _, rest = rest.partition("/")
        return [f"layers/{n_cycles * pattern + int(i)}/{rest}"], False
    if head == "encoder":
        return [f"encoder/{i}/{rest}" for i in range(cfg.n_enc_layers)], True
    return [path], False


def _unstacked(spec, stacked: bool) -> tuple:
    spec = tuple(spec)
    if stacked:
        assert spec[:1] in ((), (None,)), spec
        return spec[1:]
    return spec


def _compare(ref_tree, port_tree, ref_spec_fn, port_specs, cfg, mesh_kind):
    """Every reference leaf: its spec, filtered spec and local shape held
    against each port leaf it stands for; every port leaf is covered."""
    sizes, names = MESHES[mesh_kind]
    rmesh = _RefMesh(sizes, names)
    amesh = AbstractMesh(sizes, names)
    pmesh = sh.MeshShape(names, sizes)
    port = _port_leaves(port_tree)
    pspec = _port_leaves(port_specs)
    seen = set()
    for path, leaf in _ref_leaves(ref_tree).items():
        spec = ref_spec_fn(path, leaf)
        filt = jsh._filter(spec, rmesh, leaf.shape)
        local = NamedSharding(amesh, filt).shard_shape(leaf.shape)
        targets, stacked = _ref_place(path, cfg)
        for t in targets:
            x = port[t]
            got = pspec[t]
            assert tuple(got) == _unstacked(spec, stacked), t
            assert tuple(x.shape) == tuple(leaf.shape[int(stacked):]), t
            got_f = sh._filter(got, pmesh, x.shape)
            assert tuple(got_f) == _unstacked(filt, stacked), t
            assert sh.local_shape(x.shape, got_f, pmesh) == \
                tuple(local[int(stacked):]), t
            seen.add(t)
    assert seen == set(port)


class _KeyPath(tuple):
    """A path string as the reference's key path (``_path_str`` joins
    ``str`` of each part)."""

    def __new__(cls, s):
        return super().__new__(cls, s.split("/"))


@pytest.fixture(scope="module")
def trees():
    """arch -> (the reference's param shapes, the port's meta params)."""
    out = {}
    for arch in configs.ARCH_NAMES:
        ref = jax.eval_shape(lambda a=arch: j_init(jax.random.PRNGKey(0),
                                                   j_config(a)))
        out[arch] = (ref, dryrun.meta_model(configs.get_config(arch)))
    return out


@pytest.mark.parametrize("fsdp", ["data", None])
@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_param_specs_match_the_reference(trees, arch, mesh_kind, fsdp):
    ref, port = trees[arch]
    rmesh = _RefMesh(*MESHES[mesh_kind])
    pmesh = sh.MeshShape(MESHES[mesh_kind][1], MESHES[mesh_kind][0])
    specs = sh.param_specs(port, fsdp=fsdp, mesh=pmesh)
    _compare(ref, port,
             lambda p, x: jsh.spec_for_leaf(
                 _KeyPath(p), x, fsdp, rmesh), specs,
             configs.get_config(arch), mesh_kind)


def test_granite_experts_take_the_ff_fallback():
    """40 experts do not divide ``model`` 16: the expert-FF dimension is
    split over ``model`` instead (the spec the parity above also holds)."""
    cfg = configs.get_config("granite-moe-3b-a800m")
    params = dryrun.meta_model(cfg)
    mesh = sh.MeshShape(("data", "model"), (16, 16))
    moe = sh.filter_specs(sh.param_specs(params, "data", mesh), mesh,
                          params)["layers"][0]["moe"]
    assert tuple(moe["w_gate"]["w"]) == (None, "data", "model")
    assert tuple(moe["w_down"]["w"]) == (None, "model", "data")


@pytest.mark.parametrize("mesh_kind", list(MESHES))
def test_opt_specs_mirror_the_params(trees, mesh_kind):
    """AdamW's m and v take the parameters' specs, count is replicated."""
    arch = "qwen3-moe-30b-a3b"
    jparams, params = trees[arch]
    pmesh = sh.MeshShape(MESHES[mesh_kind][1], MESHES[mesh_kind][0])
    raw = sh.param_specs(params, "data", pmesh)
    opt = adamw_init(params)
    ospecs = sh.opt_specs(opt, raw)
    jopt = jax.eval_shape(j_adamw_init, jparams)
    jspecs = jsh.opt_specs(jopt, jsh.param_specs(
        jparams, "data", _RefMesh(*MESHES[mesh_kind])))
    assert tuple(ospecs.count) == tuple(jspecs.count) == ()
    for name in ("m", "v"):
        assert _port_leaves(getattr(ospecs, name)) == _port_leaves(raw)
        _compare(getattr(jopt, name), getattr(opt, name),
                 lambda p, x, t=getattr(jspecs, name): _spec_at(t, p),
                 getattr(ospecs, name), configs.get_config(arch), mesh_kind)


def _spec_at(spec_tree, path: str):
    flat = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda s: isinstance(s, jax.sharding.PartitionSpec)
    )[0]
    return {jsh._path_str(p): s for p, s in flat}[path]


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_batch_and_cache_specs_match_the_reference(arch, shape_name,
                                                   mesh_kind):
    shape, jshape = shapes.SHAPES[shape_name], jshapes.SHAPES[shape_name]
    cfg = shapes.variant_for_shape(configs.get_config(arch), shape)
    jcfg = jshapes.variant_for_shape(j_config(arch), jshape)
    port = shapes.input_specs(cfg, shape)
    ref = jshapes.input_specs(jcfg, jshape)
    jc = jsh.cache_specs(ref["cache"], jcfg)
    _compare(ref["cache"], port["cache"],
             lambda p, x: _spec_at(jc, p), sh.cache_specs(port["cache"], cfg),
             cfg, mesh_kind)
    jb = jsh.batch_specs({"tokens": ref["tokens"]})
    _compare({"tokens": ref["tokens"]}, {"tokens": port["tokens"]},
             lambda p, x: _spec_at(jb, p),
             sh.batch_specs({"tokens": port["tokens"]}), cfg, mesh_kind)


@pytest.mark.parametrize("arch", ["llava-next-34b", "seamless-m4t-large-v2",
                                  "qwen3-8b"])
@pytest.mark.parametrize("mesh_kind", list(MESHES))
def test_train_batch_specs_match_the_reference(arch, mesh_kind):
    shape, jshape = shapes.SHAPES["train_4k"], jshapes.SHAPES["train_4k"]
    cfg = shapes.variant_for_shape(configs.get_config(arch), shape)
    port = shapes.input_specs(cfg, shape)
    ref = jshapes.input_specs(jshapes.variant_for_shape(j_config(arch),
                                                        jshape), jshape)
    jb = jsh.batch_specs(ref)
    _compare(ref, port, lambda p, x: _spec_at(jb, p), sh.batch_specs(port),
             cfg, mesh_kind)


SPEC_ENTRIES = [None, "data", "model", "pod", ("pod", "data"),
                ("data", "model"), ("model", "pod")]


@pytest.mark.parametrize("mesh_kind", list(MESHES))
def test_filter_matches_the_reference(mesh_kind):
    """``_filter`` with and without shapes, on seeded specs and shapes
    (sizes that 2, 16, 32 and 256 divide and that they do not)."""
    rng = np.random.default_rng(27)
    rmesh = _RefMesh(*MESHES[mesh_kind])
    pmesh = sh.MeshShape(MESHES[mesh_kind][1], MESHES[mesh_kind][0])
    dims = [1, 2, 3, 16, 40, 48, 256, 49155, 512]
    for _ in range(300):
        n = int(rng.integers(0, 4))
        entries = [SPEC_ENTRIES[i] for i in rng.integers(0, 7, n)]
        shape = tuple(int(dims[i]) for i in rng.integers(0, 9,
                                                         int(rng.integers(0, 4))))
        want = jsh._filter(jax.sharding.PartitionSpec(*entries), rmesh, shape)
        got = sh._filter(sh.P(*entries), pmesh, shape)
        assert tuple(got) == tuple(want), (entries, shape)
        assert tuple(sh._filter(sh.P(*entries), pmesh)) == tuple(
            jsh._filter(jax.sharding.PartitionSpec(*entries), rmesh))


@pytest.mark.parametrize("names,sizes", [(("data", "model"), (2, 2)),
                                         (("pod", "data", "model"), (2, 2, 2))])
def test_shard_unshard_identity_and_tiling(names, sizes):
    """Every rank's ``shard`` of a smoke config's parameters: the local
    shapes ``local_shape`` gives, blocks that tile the whole exactly once
    per replica, and ``unshard`` of the parts is the tensor itself."""
    cfg = configs.get_smoke_config("recurrentgemma-2b")
    from repro_torch.models.transformer import init_model

    params = init_model(torch.Generator().manual_seed(0), cfg)
    mesh = sh.MeshShape(names, sizes)
    specs = sh.filter_specs(sh.param_specs(params, "data", mesh), mesh,
                            params)
    for spec, x in sh.spec_leaves(specs, params):
        parts = [sh.shard(x, spec, mesh, coords=sh._coords(mesh, r))
                 for r in range(mesh.size)]
        assert all(tuple(p.shape) == sh.local_shape(x.shape, spec, mesh)
                   for p in parts)
        hits = torch.zeros(x.shape, dtype=torch.int64)
        for r in range(mesh.size):
            hits[sh._slices(x.shape, spec, mesh, sh._coords(mesh, r))] += 1
        replicas = mesh.size * parts[0].numel() // x.numel()
        assert bool((hits == replicas).all())
        assert torch.equal(sh.unshard(parts, spec, mesh), x)


def test_plan_bytes_round_to_the_block():
    mesh = sh.MeshShape(("data", "model"), (2, 2))
    tree = {"a": torch.empty((6, 4), device="meta"),
            "b": torch.empty((3,), dtype=torch.bfloat16, device="meta")}
    specs = {"a": sh.P("data", "model"), "b": sh.P()}
    assert sh.plan_bytes(specs, tree, mesh) == 6 * 4 // 4 * 4 + 3 * 2
    assert sh.plan_bytes(specs, tree, mesh, block=512) == 1024
    with pytest.raises(ValueError):
        sh.local_shape((3, 4), sh.P("data"), mesh)
