"""The sharded executors (``repro_torch.core.mesh``, ``engine.fit_sharded``,
``fit_sharded_graph``, ``sharded_dmtl``, ``fit(executor="sharded")``,
``heads.fit_head``) against the port's own single-process executors.

Each module fixture starts one gloo world on the CPU (``mesh.spawn``; the
world functions are in ``tests/torch_sharded_worlds.py``) that runs many
cases, because a world costs seconds to start.  Held at the reference's own
executor-parity tolerance (rtol 1e-5, atol 2e-5, ``tests/test_engine.py``'s
sharded-vs-dense parity): one agent's solve against the batched one may
differ in the last bits.  At r = 1, as the trajectories of a symmetric
start follow roundoff at r >= 2 (ROADMAP queue 3).  Identities the
executors claim for themselves (zero-delay tape, zero-attack tape, resume)
are held bit for bit.
"""

import dataclasses
import re
import time

import numpy as np
import pytest
import torch

import torch_sharded_worlds as worlds
from repro_torch import checkpoint, netsim
from repro_torch.core import engine, graph, mesh
from repro_torch.obs.counters import modeled_floats_per_iter

RTOL, ATOL = 1e-5, 2e-5
CFG = engine.ConsensusConfig(r=1, iters=12, tau=2.0, zeta=1.0, delta=10.0)
L, D = 8, 2


def _inputs(m, seed, N=24):
    rng = np.random.default_rng(seed)
    H = (rng.standard_normal((m, N, L)) / np.sqrt(L)).astype(np.float32)
    T = rng.standard_normal((m, N, D)).astype(np.float32)
    st = engine.sufficient_stats(torch.as_tensor(H), torch.as_tensor(T))
    return {"H": H, "T": T, "G": st.G.numpy(), "R": st.R.numpy(),
            "n": st.n.numpy(), "t2": st.t2.numpy(), "cfg": CFG}


def _close(got, want, what):
    torch.testing.assert_close(got.double(), want.double(), rtol=RTOL,
                               atol=ATOL, msg=lambda m: f"{what}: {m}")


def _same_as_dense(res, state, diags, keys=engine.DIAG_KEYS):
    _close(res["U"], state.U, "U")
    _close(res["A"], state.A, "A")
    for key in keys:
        _close(res["diags"][key], diags[key], key)


def _bitwise(got, want):
    assert torch.equal(got["U"], want["U"]) and torch.equal(got["A"],
                                                            want["A"])
    for key in want["diags"]:
        assert torch.equal(got["diags"][key], want["diags"][key]), key


@pytest.fixture(scope="module")
def w8(tmp_path_factory):
    inp = _inputs(8, 0)
    inp["tmp"] = str(tmp_path_factory.mktemp("sharded_ckpt"))
    res = mesh.spawn(worlds.port8, 8, args=(inp,), timeout_s=400)
    return inp, res


@pytest.fixture(scope="module")
def w5():
    inp = _inputs(5, 1)
    inp["schedule"] = graph.paper_fig2a().chromatic_schedule()
    return inp, mesh.spawn(worlds.port5, 5, args=(inp,), timeout_s=200)[0]


@pytest.fixture(scope="module")
def w2():
    inp = _inputs(2, 2)
    return inp, mesh.spawn(worlds.port2, 2, args=(inp,), timeout_s=200)[0]


def _stats(inp):
    return worlds.stats_of(inp)


def _torus24():
    return graph.Graph(m=8, edges=tuple(sorted(engine.torus_edges([2, 4]))))


@pytest.mark.parametrize("case", ["torus8", "torus24", "star8"])
def test_sharded_matches_fit_dense(w8, case):
    inp, res = w8
    g = {"torus8": graph.ring(8), "torus24": _torus24(),
         "star8": graph.star(8)}[case]
    state, diags = engine.fit_dense(_stats(inp), g, CFG)
    _same_as_dense(res[0][case], state, diags)


@pytest.mark.parametrize("case,key", [("torus8", "U"), ("star8", "A"),
                                      ("cube_zero_delay_aged1", "diags")])
def test_every_rank_returns_the_same(w8, case, key):
    _, res = w8
    first = res[0][case][key]
    for other in res[1:]:
        if key == "diags":
            for k, v in first.items():
                assert torch.equal(other[case][key][k], v), k
        else:
            assert torch.equal(other[case][key], first)


@pytest.mark.parametrize("case,g,agg", [
    ("ring_trimmed_mean", "ring", "trimmed_mean"),
    ("star_coordinate_median", "star", "coordinate_median"),
    ("cube_krum_like", "cube", "krum_like"),
])
def test_robust_aggregators_match_fit_dense(w8, case, g, agg):
    inp, res = w8
    g = {"ring": graph.ring(8), "star": graph.star(8),
         "cube": graph.hypercube(3)}[g]
    cfg = dataclasses.replace(CFG, aggregator=agg, telemetry=True)
    state, diags = engine.fit_dense(_stats(inp), g, cfg)
    _same_as_dense(res[0][case], state, diags,
                   keys=engine.DIAG_KEYS + ("resid_max", "agg_rejected"))


@pytest.mark.parametrize("case,executor,g", [
    ("ring_telemetry", "sharded", "ring"),
    ("star_telemetry", "sharded_graph", "star"),
])
def test_telemetry_counters(w8, case, executor, g):
    inp, res = w8
    g = graph.ring(8) if g == "ring" else graph.star(8)
    cfg = dataclasses.replace(CFG, telemetry=True)
    _, dense = engine.fit_dense(_stats(inp), g, cfg)
    got = res[0][case]["diags"]
    assert set(got) == set(dense)
    for key in ("msgs_delivered", "msgs_stale", "msgs_dropped",
                "agg_rejected"):
        assert torch.equal(got[key], dense[key]), key
    assert bool((got["msgs_delivered"] == 2 * g.n_edges).all())
    _close(got["resid_max"], dense["resid_max"], "resid_max")
    model = (modeled_floats_per_iter("sharded", L=L, r=CFG.r, m=8, n_axes=1)
             if executor == "sharded" else
             modeled_floats_per_iter("sharded_graph", L=L, r=CFG.r,
                                     n_edges=g.n_edges))
    assert bool((got["comm_floats"] == model).all())


@pytest.mark.parametrize("aged", [0, 1])
def test_zero_delay_tape_is_the_no_tape_run_bitwise(w8, aged):
    _, res = w8
    got, want = res[0][f"cube_zero_delay_aged{aged}"], res[0]["cube"]
    _bitwise({**got, "diags": {k: got["diags"][k] for k in want["diags"]}},
             want)
    assert torch.equal(got["diags"]["tape_cursor"],
                       torch.arange(CFG.iters, dtype=torch.int32))


def test_zero_attack_tape_is_its_base_tape_bitwise(w8):
    _, res = w8
    _bitwise(res[0]["cube_zero_attack_tape"], res[0]["cube_base_tape"])


@pytest.mark.parametrize("case", ["base", "attack"])
def test_in_mesh_replay_matches_fit_async(w8, case):
    inp, res = w8
    cube = graph.hypercube(3)
    cfg = dataclasses.replace(CFG, telemetry=True)
    if case == "base":
        tape = netsim.ChannelModel(delay="geometric", scale=2.0, drop=0.2,
                                   straggler_prob=0.2, seed=3).sample(
            cube, CFG.iters)
        got, kw = res[0]["cube_base_tape"], dict(aged_duals=True)
    else:
        tape = netsim.AdversaryModel(
            n_byzantine=1, kinds=("sign_flip",), churn=((2, 3, 6),),
            seed=0).sample(cube, CFG.iters, L=L, r=CFG.r)
        cfg = dataclasses.replace(cfg, aggregator="coordinate_median")
        got, kw = res[0]["cube_attack_median"], {}
    state, diags = engine.fit_async(_stats(inp), cube, cfg, tape, **kw)
    _same_as_dense(got, state, diags)
    for key in ("msgs_delivered", "msgs_stale", "msgs_dropped"):
        assert torch.equal(got["diags"][key], diags[key]), key


@pytest.mark.parametrize("case", ["torus", "cube_channel"])
def test_resume_is_the_uninterrupted_run_bitwise(w8, case):
    _, res = w8
    run = res[0][f"resume_{case}"]
    _bitwise(run["got"], run["want"])


def test_checkpoint_is_the_reference_layout(w8):
    inp, res = w8
    meta = res[0]["checkpoint_meta"]
    assert meta["step"] == CFG.iters
    assert meta["metadata"]["executor"] == "sharded_graph"
    raw, _ = checkpoint.load_checkpoint(f"{inp['tmp']}/cube_channel", None)
    sched = graph.compile_edge_schedule(graph.hypercube(3))
    depth = int(raw["state/hist"].shape[1])
    assert tuple(raw["state/U"].shape) == (8, L, CFG.r)
    assert tuple(raw["state/lam"].shape) == (8, sched.n_slots, L, CFG.r)
    assert tuple(raw["state/lam_hist"].shape) == (8, depth, sched.n_slots, L,
                                                  CFG.r)
    torus, _ = checkpoint.load_checkpoint(f"{inp['tmp']}/torus", None)
    assert tuple(torus["state/lam"].shape) == (8, 1, L, CFG.r)


def test_health_stops_every_rank_at_the_same_segment(w8):
    _, res = w8
    n_done = {int(r["health_stop"]["diags"]["objective"].shape[0])
              for r in res}
    assert len(n_done) == 1
    n_done = n_done.pop()
    assert n_done < CFG.iters and n_done % 2 == 0
    meta = res[0]["health_meta"]
    assert meta["step"] == n_done
    assert meta["metadata"]["dnf_reason"] == "consensus_stall"


def test_rank_zero_writes_the_trace_and_report(w8):
    inp, res = w8
    from pathlib import Path

    from repro_torch import obs

    trace = Path(inp["tmp"]) / "trace"
    assert obs.validate_trace(trace / "trace.json") > 0
    spans = [line for line in (trace / "spans.jsonl").read_text().splitlines()
             if '"segment"' in line]
    assert len(spans) == 1
    assert (trace / "report.md").exists()
    report = (trace / "report.json").read_text()
    assert '"sharded_graph"' in report
    assert bool((res[0]["traced"]["diags"]["comm_floats"] ==
                 modeled_floats_per_iter("sharded_graph", L=L, r=CFG.r,
                                         n_edges=12)).all())


def test_fit_takes_the_torus_path_for_a_flipped_ring(w8):
    inp, res = w8
    ring = graph.ring(8)
    flipped = graph.Graph(m=8, edges=((1, 0),) + ring.edges[1:])
    got = res[0]["fit_flipped_ring"]
    assert bool((got["diags"]["comm_floats"] == modeled_floats_per_iter(
        "sharded", L=L, r=CFG.r, m=8, n_axes=1)).all())
    state, diags = engine.fit_dense(_stats(inp), flipped, CFG)
    _same_as_dense(got, state, diags)


def test_fit_gauss_seidel_phases_match_fit_colored(w8):
    inp, res = w8
    cube = graph.hypercube(3)
    state, diags = engine.fit_colored(
        _stats(inp), cube, CFG, schedule=cube.chromatic_schedule())
    _same_as_dense(res[0]["fit_gauss_seidel_cube"], state, diags)


@pytest.mark.parametrize("case,g", [("fit_raw_star", "star"),
                                    ("fit_head", "ring")])
def test_entry_points_match_fit_dense(w8, case, g):
    inp, res = w8
    g = graph.star(8) if g == "star" else graph.ring(8)
    state, diags = engine.fit_dense(_stats(inp), g, CFG)
    _same_as_dense(res[0][case], state, diags)


@pytest.mark.parametrize("case,pattern", [
    ("graph_size", r"ValueError: .*prod\(agent axes\)=8"),
    ("stats_rows", r"ValueError: m=4 must equal prod\(agent axes\)=8"),
    ("non_agent_axis", r"NotImplementedError: .*sharding\.py"),
    ("axis_order", r"ValueError: .*mesh's order"),
    ("graph_runner_without_g", r"ValueError: .*needs g="),
    ("tape_with_schedule", r"ValueError: .*only the Jacobian sweep"),
    ("tape_without_g", r"ValueError: .*explicit g="),
    ("aged_duals_without_tape", r"ValueError: aged_duals=True needs"),
    ("remap_sharded_layout", r"ValueError: .*per-slot dual layouts"),
])
def test_validation_errors(w8, case, pattern):
    _, res = w8
    msg = res[0]["errors"][case]
    assert msg is not None and re.search(pattern, msg), msg


def test_transport_is_gloo(w8):
    _, res = w8
    assert [r["rank"] for r in res] == list(range(8))
    assert {r["transport"] for r in res} == {"gloo"}


@pytest.mark.parametrize("case", ["jacobian", "gauss_seidel"])
def test_fig2a_on_five_ranks(w5, case):
    inp, res = w5
    g = graph.paper_fig2a()
    if case == "jacobian":
        state, diags = engine.fit_dense(_stats(inp), g, CFG)
    else:
        state, diags = engine.fit_colored(_stats(inp), g, CFG,
                                          schedule=inp["schedule"],
                                          staleness=0)
    _same_as_dense(res[case], state, diags)


def test_gauss_seidel_counters(w5):
    inp, res = w5
    g = graph.paper_fig2a()
    diags = res["gauss_seidel_telemetry"]["diags"]
    assert bool((diags["msgs_delivered"] == 2 * g.n_edges).all())
    assert bool((diags["comm_floats"] == modeled_floats_per_iter(
        "sharded_graph", L=L, r=CFG.r, n_edges=g.n_edges)).all())
    _same_as_dense(res["gauss_seidel_telemetry"],
                   *engine.fit_colored(_stats(inp), g, CFG,
                                       schedule=inp["schedule"]))


@pytest.mark.parametrize("case,g", [("ring2", graph.ring(2)),
                                    ("chain2", graph.chain(2))])
def test_single_edge_on_two_ranks(w2, case, g):
    inp, res = w2
    cfg = dataclasses.replace(CFG, telemetry=True)
    state, diags = engine.fit_dense(_stats(inp), g, cfg)
    _same_as_dense(res[case], state, diags)
    # the one neighbor counted once: one delivery each way
    assert bool((res[case]["diags"]["msgs_delivered"] == 2.0).all())


def test_a_failing_rank_ends_the_world():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="fails on purpose"):
        mesh.spawn(worlds.failing, 4, args=(2,), timeout_s=120)
    assert time.monotonic() - t0 < 60


def test_make_runner_and_make_mesh_validation():
    st = _stats(_inputs(4, 3))
    with pytest.raises(ValueError, match="needs mesh= and agent_axes="):
        engine.make_runner(st, graph.ring(4), CFG, executor="sharded")
    with pytest.raises(ValueError, match="only apply to executor='sharded'"):
        engine.make_runner(st, graph.ring(4), CFG, mesh=object())
    with pytest.raises(RuntimeError, match="initialized process group"):
        mesh.make_mesh((4,), ("a",))
    from repro_torch.core import dmtl_elm

    H, T = torch.ones(4, 6, L), torch.ones(4, 6, 1)
    with pytest.raises(ValueError, match="only apply to executor='sharded'"):
        dmtl_elm.fit(H, T, graph.ring(4), CFG, mesh=object(),
                     agent_axes=("a",))
    with pytest.raises(ValueError, match="needs mesh= and agent_axes="):
        dmtl_elm.fit(H, T, graph.ring(4), CFG, executor="sharded")
    assert engine.graph_matches_torus(graph.ring(4), [4])
    assert engine.graph_matches_torus(
        graph.Graph(m=4, edges=((1, 0), (1, 2), (2, 3), (3, 0))), [4])
    assert not engine.graph_matches_torus(graph.star(4), [4])
    assert engine.torus_edges([2]) == {(0, 1)}
    assert len(engine.torus_edges([2, 4])) == 12
