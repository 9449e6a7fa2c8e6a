"""The port's sharded executors against the reference's, on the same
numpy inputs.

One module-scoped subprocess runs the reference's sharded cases on 8 host
devices (``--xla_force_host_platform_device_count=8`` must be set before
JAX starts, as ``tests/test_sharded_dmtl.py`` does) and saves its results
and two mid-run checkpoints with numpy; one gloo world of 8 ranks runs the
same cases in the port (``torch_sharded_worlds.ref8``) and resumes the
reference's checkpoints.  Tolerances: the reference's sharded-vs-dense
rtol 2e-3, atol 2e-4 (``tests/test_sharded_dmtl.py``); r = 1 (ROADMAP
queue 3: symmetric starts).
"""

import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_sharded_worlds as worlds
from repro_torch import checkpoint
from repro_torch.core import engine, mesh

torch.set_num_threads(1)  # one thread per test process: xdist's workers share the cores

RTOL, ATOL = 2e-3, 2e-4
CFG = engine.ConsensusConfig(r=1, iters=12, tau=2.0, zeta=1.0, delta=10.0)
CASES = ("torus8", "torus24", "star8", "gs_cube", "channel_aged_cube",
         "attack_median_cube", "fit_ring_telemetry")

_REF_SCRIPT = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, numpy as np
    from repro import netsim
    from repro.checkpoint import save_run_checkpoint
    from repro.core import engine, graph, sharded_dmtl, dmtl_elm
    from repro.core.engine import ConsensusConfig, SufficientStats

    out_dir = sys.argv[1]
    rng = np.random.default_rng(0)
    m, N, L, D = 8, 24, 8, 2
    H = (rng.standard_normal((m, N, L)) / np.sqrt(L)).astype(np.float32)
    T = rng.standard_normal((m, N, D)).astype(np.float32)
    st = engine.sufficient_stats(H, T)
    cfg = ConsensusConfig(r=1, iters=12, tau=2.0, zeta=1.0, delta=10.0)
    mesh8 = jax.make_mesh((8,), ("a",))
    mesh24 = jax.make_mesh((2, 4), ("pod", "data"))
    cube, star = graph.hypercube(3), graph.star(8)
    channel = netsim.ChannelModel(delay="geometric", scale=2.0, drop=0.2,
                                  straggler_prob=0.2, seed=3).sample(
        cube, cfg.iters)
    attack = netsim.AdversaryModel(
        n_byzantine=1, kinds=("sign_flip",), churn=((2, 3, 6),),
        seed=0).sample(cube, cfg.iters, L=L, r=cfg.r)
    median = dataclasses.replace(cfg, aggregator="coordinate_median")

    def fs(*a, **kw):
        return sharded_dmtl.dmtl_fit_from_stats(
            st.G, st.R, *a, n=st.n, t2=st.t2, **kw)

    res = {
        "torus8": fs(mesh8, ("a",), cfg),
        "torus24": fs(mesh24, ("pod", "data"), cfg),
        "star8": fs(mesh8, ("a",), cfg, g=star),
        "gs_cube": engine.fit_sharded_graph(
            st, mesh8, ("a",), cube, cfg,
            schedule=cube.chromatic_schedule()),
        "channel_aged_cube": fs(mesh8, ("a",), cfg, g=cube, tape=channel,
                                aged_duals=True),
        "attack_median_cube": fs(mesh8, ("a",), median, g=cube,
                                 tape=attack),
        "fit_ring_telemetry": dmtl_elm.fit(
            H, T, graph.ring(8), cfg, executor="sharded", mesh=mesh8,
            agent_axes=("a",), telemetry=True),
    }
    arrays = {"H": H, "T": T, "G": np.asarray(st.G), "R": np.asarray(st.R),
              "n": np.asarray(st.n), "t2": np.asarray(st.t2)}
    for name, (U, A, diags) in res.items():
        arrays[f"{name}/U"] = np.asarray(U)
        arrays[f"{name}/A"] = np.asarray(A)
        for key, v in diags.items():
            arrays[f"{name}/diags/{key}"] = np.asarray(v)
    np.savez(os.path.join(out_dir, "ref.npz"), **arrays)

    # mid-run checkpoints at iteration 4, in the reference's layout
    for name, runner in (
        ("torus", engine.make_runner(st, None, cfg, executor="sharded",
                                     mesh=mesh8, agent_axes=("a",))),
        ("cube", engine.make_runner(st, cube, cfg, executor="sharded_graph",
                                    mesh=mesh8, agent_axes=("a",),
                                    tape=channel, aged_duals=True)),
    ):
        state, diags = runner.run_segment(runner.init_state(), 4)
        save_run_checkpoint(os.path.join(out_dir, name), state, diags,
                            metadata={"executor": runner.executor,
                                      "iters": cfg.iters})
    print("REF_DONE")
    """
)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_ref")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run([sys.executable, "-c", _REF_SCRIPT, str(out)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0 and "REF_DONE" in proc.stdout, (
        f"stdout:\n{proc.stdout}\nstderr:\n{proc.stderr[-4000:]}")
    with np.load(out / "ref.npz") as z:
        arrays = dict(z)
    return out, arrays


@pytest.fixture(scope="module")
def port(ref):
    out, arrays = ref
    inp = {k: arrays[k] for k in ("H", "T", "G", "R", "n", "t2")}
    inp["cfg"] = CFG
    # the port resumes copies (and writes its later snapshots there)
    for name in ("torus", "cube"):
        shutil.copytree(out / name, out / "port" / name)
    inp["ckpt"] = str(out / "port")
    return mesh.spawn(worlds.ref8, 8, args=(inp,), timeout_s=400)[0]


def _ref_case(arrays, name):
    prefix = f"{name}/diags/"
    return {"U": arrays[f"{name}/U"], "A": arrays[f"{name}/A"],
            "diags": {k[len(prefix):]: v for k, v in arrays.items()
                      if k.startswith(prefix)}}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("part", ["U", "A", "diags"])
def test_port_matches_reference(ref, port, case, part):
    want = _ref_case(ref[1], case)
    got = port[case]
    if part != "diags":
        _close(got[part].numpy(), want[part], f"{case} {part}")
        return
    assert set(got["diags"]) == set(want["diags"])
    for key, v in want["diags"].items():
        _close(got["diags"][key].numpy(), v, f"{case} diags[{key!r}]")


@pytest.mark.parametrize("case", CASES)
def test_first_iterations_match_at_the_parity_tolerance(ref, port, case):
    """The first 3 iterations at the reference's own executor-parity
    tolerance (rtol 1e-5, atol 1e-5 over 3 iterations,
    ``tests/test_engine.py``'s vmap-vs-shard_map parity)."""
    want = _ref_case(ref[1], case)["diags"]
    for key in ("objective", "lagrangian", "consensus", "primal_sq",
                "gamma"):
        np.testing.assert_allclose(
            port[case]["diags"][key][:3].numpy().astype(np.float64),
            want[key][:3].astype(np.float64), rtol=1e-5, atol=1e-5,
            err_msg=f"{case} diags[{key!r}][:3]")


@pytest.mark.parametrize("case,full", [("torus", "torus8"),
                                       ("cube", "channel_aged_cube")])
def test_reference_checkpoint_resumes_in_the_port(ref, port, case, full):
    want = _ref_case(ref[1], full)
    got = port[f"resumed_{case}"]
    _close(got["U"].numpy(), want["U"], "U")
    _close(got["A"].numpy(), want["A"], "A")
    for key in ("objective", "consensus", "lagrangian"):
        _close(got["diags"][key].numpy(), want["diags"][key], key)


def test_objective_is_exact_from_threaded_stats(ref, port):
    """n/t2 threaded through: the objective is the whole eq. (12) value,
    ||T||^2 included (the reference's regression for dropped leaves)."""
    arrays = ref[1]
    st = engine.SufficientStats(*(torch.as_tensor(arrays[k])
                                  for k in ("G", "R", "n", "t2")))
    U, A = port["star8"]["U"], port["star8"]["A"]
    obj = engine.objective_from_stats(st, U, A, CFG.mu1, CFG.mu2)
    no_t2 = engine.objective_from_stats(st._replace(t2=0.0), U, A, CFG.mu1,
                                        CFG.mu2)
    _close(port["star8"]["diags"]["objective"][-1].numpy(), obj.numpy(),
           "objective")
    _close((obj - no_t2).numpy(), 0.5 * np.sum(arrays["t2"]), "||T||^2 / 2")


def test_reference_checkpoint_layout(ref):
    out = Path(ref[0])
    raw, meta = checkpoint.load_checkpoint(out / "cube", None)
    assert meta["metadata"]["executor"] == "sharded_graph"
    assert raw["state/hist"].shape[0] == 8 and raw["state/lam"].ndim == 4
