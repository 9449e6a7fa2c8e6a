"""Port parity: ``repro_torch/launch/dryrun.py``, ``launch/mesh.py``,
``analysis/hillclimb.py`` and ``analysis/report.py`` against the
reference's, and the data-parallel step of ``training/steps.py``.

The reference's ``launch/dryrun.py`` and ``analysis/hillclimb.py`` set
``XLA_FLAGS`` (512 host devices) when imported, which would change this
test process's JAX backend; their functions are read from the source with
``ast`` and run alone.  The fake world of 256 or 512 ranks is
process-global, so every test that makes one runs in a subprocess.  The
data-parallel step runs in a two-rank gloo world (``mesh.spawn``, world
function in ``tests/torch_sharded_worlds.py``) against the one-process step
on the whole batch, and at two microbatches against the reference's
``train_step`` loss, with labels padded over a different share on each
rank, in norm within 1e-5 (the limit of phase 8e (c), fp32 reassociation
only).
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
import textwrap
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test process: xdist's workers share the cores

import jax  # noqa: E402

import torch_sharded_worlds as worlds  # noqa: E402
from repro import configs as jconfigs  # noqa: E402
from repro.launch import mesh as jmesh  # noqa: E402
from repro.launch import shapes as jshapes  # noqa: E402
from repro.models.transformer import init_model as j_init  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.analysis import hillclimb, report  # noqa: E402
from repro_torch.core import mesh  # noqa: E402
from repro_torch.launch import dryrun, shapes  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.transformer import param_count  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.training import steps  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF = ROOT / "src" / "repro"
DP_TOL = 1e-5


def _ref_function(path: Path, name: str):
    """A top-level function of a reference module, without importing it."""
    tree = ast.parse(path.read_text())
    node = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    ns: dict = {}
    exec(compile(ast.Module([node], []), str(path), "exec"), ns)
    return ns[name]


def _ref_cfg_parse(kvs):
    """The ``--cfg`` loop of the reference's ``hillclimb.main``."""
    path = REF / "analysis" / "hillclimb.py"
    tree = ast.parse(path.read_text())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    loop = next(n for n in main.body if isinstance(n, ast.For))
    body = ast.parse("overrides = {}").body + [loop]
    ns = {"args": types.SimpleNamespace(cfg=kvs)}
    exec(compile(ast.Module(body, []), str(path), "exec"), ns)
    return ns["overrides"]


def _ref_counts(arch):
    """(params, params_active) as the reference's ``_lower_one`` counts
    them, on ``jax.eval_shape``."""
    cfg = jconfigs.get_config(arch)
    tree = jax.eval_shape(lambda: j_init(jax.random.PRNGKey(0), cfg))
    n = sum(x.size for x in jax.tree.leaves(tree))
    moe_layers = sum(1 for k in cfg.layer_kinds() if k == "moe")
    moe_total = moe_layers * cfg.n_experts * 3 * cfg.d_model * cfg.moe_d_ff
    moe_active = (moe_layers * cfg.n_experts_active * 3 * cfg.d_model
                  * cfg.moe_d_ff)
    return n, n - moe_total + moe_active


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_counts_and_model_flops_match_the_reference(arch):
    ref_flops = _ref_function(REF / "launch" / "dryrun.py",
                              "model_flops_per_step")
    n, n_active = _ref_counts(arch)
    params = dryrun.meta_model(configs.get_config(arch))
    assert param_count(params) == n
    assert dryrun.active_params(configs.get_config(arch), n) == n_active
    for name in shapes.SHAPES:
        cfg = shapes.variant_for_shape(configs.get_config(arch),
                                       shapes.SHAPES[name])
        jcfg = jshapes.variant_for_shape(jconfigs.get_config(arch),
                                         jshapes.SHAPES[name])
        assert dryrun.model_flops_per_step(
            cfg, shapes.SHAPES[name], n, n_active) == ref_flops(
            jcfg, jshapes.SHAPES[name], n, n_active)


@pytest.mark.parametrize("kvs", [
    ["n_layers=4", "remat=True", "capacity_factor=1.25", "moe_impl=shardmap"],
    ["d_model=512", "rope_theta=1e6", "tie_embeddings=False", "x=-3"],
    [],
])
def test_cfg_parsing_matches_the_reference(kvs):
    got, want = hillclimb.parse_overrides(kvs), _ref_cfg_parse(kvs)
    assert got == want
    assert [type(v) for v in got.values()] == [type(v) for v in want.values()]


def test_mesh_constants_follow_the_reference():
    assert (tmesh.SINGLE_POD, tmesh.SINGLE_POD_AXES) == (
        jmesh.SINGLE_POD, jmesh.SINGLE_POD_AXES)
    assert (tmesh.MULTI_POD, tmesh.MULTI_POD_AXES) == (
        jmesh.MULTI_POD, jmesh.MULTI_POD_AXES)


def _row(arch, shape, peak_ok=True, ratio=None):
    return {"roofline": {"compute_s": 1.0, "memory_s": 2.0,
                         "collective_s": 3.0, "dominant": "collective_s",
                         "useful_flops_ratio": ratio},
            "memory": {"peak_estimate_bytes": 5e9, "peak_ok_80gb": peak_ok},
            "pass_seconds": 1.5}


def test_report_renders_a_row_per_combo(tmp_path):
    """A row per (arch, shape), MISSING where no JSON is, "—" for a null
    ratio, the 80 GB fit; the multi-pod summary likewise."""
    for tag, rec in (("qwen3-8b__train_4k__single", _row("", "")),
                     ("qwen3-8b__train_4k__multi", _row("", "")),
                     ("gemma-7b__decode_32k__single",
                      _row("", "", peak_ok=False, ratio=0.5))):
        (tmp_path / f"{tag}.json").write_text(json.dumps(rec))
    table = report.roofline_table(str(tmp_path)).splitlines()
    assert len(table) == 2 + len(report.ARCH_ORDER) * len(report.SHAPE_ORDER)
    assert "fits 80GB" in table[0]
    rows = {tuple(c.strip() for c in r.split("|")[1:3]): r for r in table[2:]}
    assert "| collective | — | 5.0 | ✓ |" in rows["qwen3-8b", "train_4k"]
    assert "| 0.50 | 5.0 | ✗ |" in rows["gemma-7b", "decode_32k"]
    assert "MISSING" in rows["qwen3-8b", "prefill_32k"]
    summary = report.multipod_summary(str(tmp_path))
    assert "| qwen3-8b | train_4k | ✓ (1.5s) |" in summary
    assert "| gemma-7b | decode_32k | MISSING | |" in summary


_FAKE_WORLD = textwrap.dedent("""
    import json, sys
    import torch
    torch.set_num_threads(1)
    from repro_torch import configs
    from repro_torch.analysis import hillclimb, report
    from repro_torch.core import mesh as core_mesh
    from repro_torch.launch import dryrun, mesh as tmesh
    out = {}
    with dryrun.fake_world(256):
        m = tmesh.make_production_mesh(device="meta")
        out["single"] = [m.axis_names, m.sizes, m.device.type]
        try:
            tmesh.make_production_mesh(multi_pod=True, device="meta")
        except RuntimeError as e:
            out["error"] = str(e)
        # the ring of the sharded fit on meta tensors: the fake group's
        # ppermute path, counted
        core_mesh.reset_collectives()
        cfg = configs.get_smoke_config("qwen3-8b")
        rec = dryrun._dmtl_pass(cfg, m, False, admm_iters=2)
        out["dmtl"] = rec["collectives"]
        plain = hillclimb.lower("recurrentgemma-2b", "decode_32k")
        bf16 = hillclimb.lower("recurrentgemma-2b", "decode_32k",
                               serve_bf16=True)
        out["hillclimb"] = [plain, bf16]
    with dryrun.fake_world(512):
        m = tmesh.make_production_mesh(multi_pod=True, device="meta")
        out["multi"] = [m.axis_names, m.sizes, m.device.type]
        # the first 4 ranks of 512 (this process is rank 0, inside it)
        m = tmesh.make_local_mesh(2, 2, device="meta")
        out["local"] = [m.axis_names, m.sizes, m.size]
    with dryrun.fake_world(4):
        m = tmesh.make_local_mesh(4, 1, device="meta")
        out["local_all"] = [m.axis_names, m.sizes]
    dryrun.main(["--arch", "recurrentgemma-2b", "--shape", "decode_32k",
                 "--mesh", "single", "--out", sys.argv[1]])
    dryrun.main(["--arch", "recurrentgemma-2b", "--shape", "decode_32k",
                 "--mesh", "multi", "--out", sys.argv[1]])
    out["table"] = report.roofline_table(sys.argv[1])
    print("RESULT " + json.dumps(out))
""")


@pytest.fixture(scope="module")
def fake_world_run(tmp_path_factory):
    out_dir = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _FAKE_WORLD, str(out_dir)],
                          capture_output=True, text=True, env=env,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(ln for ln in proc.stdout.splitlines()
                if ln.startswith("RESULT "))
    return json.loads(line[len("RESULT "):]), out_dir


def test_production_meshes_in_a_fake_world(fake_world_run):
    res, _ = fake_world_run
    assert res["single"] == [list(jmesh.SINGLE_POD_AXES),
                             list(jmesh.SINGLE_POD), "meta"]
    assert res["multi"] == [list(jmesh.MULTI_POD_AXES),
                            list(jmesh.MULTI_POD), "meta"]
    assert "need 512 ranks" in res["error"] and "torchrun" in res["error"]
    assert res["local"] == [list(jmesh.SINGLE_POD_AXES), [2, 2], 4]
    assert res["local_all"] == [list(jmesh.SINGLE_POD_AXES), [4, 1]]


def test_dmtl_ring_runs_on_meta_in_the_fake_world(fake_world_run):
    """The sharded fit's torus ppermutes (3 of U and 1 of lambda an
    iteration on the one agent axis) ran on meta tensors and were counted,
    as were the gathers of the fit's result."""
    coll = fake_world_run[0]["dmtl"]
    assert coll["counts"]["collective-permute"] == 2 * 4
    assert coll["counts"]["all-gather"] > 0
    assert coll["total"] == sum(coll[k] for k in mesh.COLLECTIVE_KINDS)


def test_lower_combo_writes_the_references_keys(fake_world_run):
    """``main`` of one combo on both meshes: the JSON has the reference's
    keys where the port computes the same quantity, params of the meta
    tree, the 80 GB fit, and the report's row; serve_bf16 halves the fp32
    parameters' bytes in ``hillclimb``."""
    res, out_dir = fake_world_run
    n, n_active = _ref_counts("recurrentgemma-2b")
    for kind, chips in (("single", 256), ("multi", 512)):
        d = json.loads((out_dir / f"recurrentgemma-2b__decode_32k__{kind}"
                        ".json").read_text())
        assert {"arch", "shape", "mesh", "chips", "params", "params_active",
                "memory", "collectives", "roofline", "cost_source",
                "pass_seconds"} <= set(d)
        assert d["chips"] == chips and d["params"] == n
        assert d["params_active"] == n_active
        assert {"argument_bytes_per_device", "output_bytes_per_device",
                "temp_bytes_per_device", "peak_estimate_bytes",
                "peak_ok_80gb"} == set(d["memory"])
        assert set(d["collectives"]) == {"all-reduce", "all-gather",
                                         "collective-permute", "total",
                                         "counts"}
        assert {"compute_s", "compute_s_analytic", "memory_s",
                "collective_s", "model_flops_total", "analytic_flops_total",
                "dominant", "useful_flops_ratio"} == set(d["roofline"])
        assert d["memory"]["peak_estimate_bytes"] == (
            d["memory"]["argument_bytes_per_device"]
            + d["memory"]["output_bytes_per_device"])
    assert "| recurrentgemma-2b | decode_32k |" in res["table"]
    plain, bf16 = res["hillclimb"]
    assert bf16["arg_gb"] < plain["arg_gb"] and bf16["temp_gb"] is None
    assert set(plain) == {"compile_s", "peak_gb", "temp_gb", "arg_gb",
                          "compute_s", "memory_s", "collective_s", "coll_gb",
                          "coll_counts"}


def _rel(a, b):
    return float(torch.linalg.vector_norm((a - b).double())
                 / torch.linalg.vector_norm(b.double()))


def _tree_rel(got, want):
    from repro_torch.optim import tree_leaves

    num = sum(float(((a.double() - b.double()) ** 2).sum())
              for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True))
    den = sum(float((b.double() ** 2).sum()) for b in tree_leaves(want))
    return (num / den) ** 0.5


def test_data_parallel_step_equals_the_whole_batch():
    """Two ranks of 2 rows each, labels padded with -1 over 3 and over 21 of
    32 positions, the reference's weights: the reduced loss, gradients and
    updated parameters equal the one-process step on the 4 rows, in one
    microbatch and in two; in two, both equal the reference's
    ``train_step`` loss (its microbatch i is the global rows [2 i, 2 i +
    2), so rank 0's 58 labels apart from rank 1's 22); and each rank ran on
    one thread."""
    from repro.optim import adamw as jadam
    from repro.training import steps as jsteps
    from repro_torch import convert
    from repro_torch.optim import tree_map

    cfg = dataclasses.replace(configs.get_smoke_config("recurrentgemma-2b"),
                              dtype="float32")
    jcfg = dataclasses.replace(
        jconfigs.get_smoke_config("recurrentgemma-2b"), dtype="float32")
    jp = jax.jit(j_init, static_argnums=1)(jax.random.PRNGKey(5), jcfg)
    weights = convert.model_from_numpy(jax.tree.map(np.asarray, jp), cfg,
                                       "cpu")
    rng = np.random.default_rng(27)
    B, S = 4, 32
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[:2, S - 3:] = -1
    labels[2:, S - 21:] = -1
    batch = {"tokens": tokens, "labels": labels}
    res = mesh.spawn(worlds.data_parallel_world, 2, timeout_s=300,
                     args=({"world": 2, "cfg": cfg, "params": weights,
                            "batch": batch},))

    def params():
        return tree_map(torch.clone, weights)

    whole = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, metrics, grads = steps.loss_and_grads(params(), cfg, whole)
    p = params()
    new, _, _ = steps.train_step(p, adamw_init(p), whole, cfg, AdamWConfig())
    for r in res:
        assert r["threads"] == 1
        assert abs(float(r["loss"]) - float(loss)) <= DP_TOL * abs(float(loss))
        assert abs(float(r["step_loss"]) - float(loss)) <= DP_TOL * abs(
            float(loss))
        assert int(r["metrics"]["tokens"]) == int(metrics["tokens"])
        assert _tree_rel(r["grads"], grads) <= DP_TOL
        assert _tree_rel(r["params"], new) <= DP_TOL
    # the ranks' own means would weigh rank 1's 11 labels like rank 0's 29
    assert _rel(res[0]["metrics"]["ce"], metrics["ce"]) <= DP_TOL
    l2, _, g2 = steps.loss_and_grads(params(), cfg, whole, 2)
    _, _, jm = jax.jit(jsteps.make_train_step(jcfg, jadam.AdamWConfig(),
                                              microbatches=2))(
        jp, jadam.adamw_init(jp), jax.tree.map(np.asarray, batch))
    j2 = float(jm["loss"])
    assert abs(float(l2) - j2) <= DP_TOL * abs(j2)
    for r in res:
        assert abs(float(r["loss_mb2"]) - j2) <= DP_TOL * abs(j2)
        assert abs(float(r["loss_mb2"]) - float(l2)) <= DP_TOL * abs(float(l2))
        assert _tree_rel(r["grads_mb2"], g2) <= DP_TOL
