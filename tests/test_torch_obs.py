"""Port parity: the observability layer (``repro_torch.obs``) and the
engine's telemetry and spans, against the JAX reference on the same numpy
inputs.

Counters, health verdicts and the run report's numbers must agree exactly.
Telemetry counters (message counts, ``comm_floats``) must equal the
reference's exactly; ``resid_max`` is a float of a trajectory, held at the
colored tests' fp32 tolerance (rtol 1e-4 plus atol 1e-5 of its scale) at
r = 1 (ROADMAP queue 3, symmetric start).
"""

import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test process: xdist's workers share the cores

import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.core import dmtl_elm as jd  # noqa: E402
from repro.core import engine as je  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch import quickstart  # noqa: E402
from repro_torch.core import dmtl_elm as td  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402

GRAPHS = {"ring": (5,), "paper_fig2a": ()}


def _stats(m, N=24, L=12, d=3, seed=0):
    rng = np.random.default_rng(seed)
    H = (rng.standard_normal((m, N, L)) / np.sqrt(L)).astype(np.float32)
    T = rng.standard_normal((m, N, d)).astype(np.float32)
    sj = je.sufficient_stats(jnp.asarray(H), jnp.asarray(T))
    return H, T, sj, convert.stats_from_numpy(sj.G, sj.R, sj.n, sj.t2,
                                              device="cpu")


# --------------------------------------------------------------------------
# counters, health, report
# --------------------------------------------------------------------------


@pytest.mark.parametrize("executor,kw", [
    ("dense", dict(n_edges=7)), ("colored", dict(n_edges=5)),
    ("async", dict(n_edges=9)), ("sharded", dict(m=8, n_axes=2)),
    ("sharded_graph", dict(n_edges=12)),
])
def test_modeled_floats_per_iter_matches_reference(executor, kw):
    for L, r in ((8, 1), (2048, 8)):
        assert (tobs.modeled_floats_per_iter(executor, L=L, r=r, **kw)
                == jobs.modeled_floats_per_iter(executor, L=L, r=r, **kw))


@pytest.mark.parametrize("executor", ["dense", "sharded", "sharded_graph",
                                      "gossip"])
def test_modeled_floats_per_iter_refuses_what_the_reference_refuses(executor):
    for mod in (tobs, jobs):
        with pytest.raises(ValueError):
            mod.modeled_floats_per_iter(executor, L=4, r=2)


def _trajectories():
    rng = np.random.default_rng(3)
    falling = np.linspace(10.0, 1.0, 60).astype(np.float32)
    cons = np.geomspace(1.0, 1e-3, 60).astype(np.float32)
    nan = falling.copy()
    nan[17] = np.nan
    diverging = falling.copy()
    diverging[30:] = 1e4
    flat = np.full(60, 2.0, np.float32)
    noisy = (falling + 0.01 * rng.standard_normal(60)).astype(np.float32)
    return {
        "healthy": {"objective": falling, "consensus": cons},
        "nan": {"objective": nan, "consensus": cons},
        "divergence": {"objective": diverging, "consensus": cons},
        "stall": {"objective": flat, "consensus": cons},
        "converged": {"objective": flat, "consensus": np.zeros(60, np.float32)},
        "short": {"objective": flat[:10], "consensus": cons[:10]},
        "empty": {"objective": flat[:0], "consensus": cons[:0]},
        "noisy": {"objective": noisy, "consensus": cons},
    }


@pytest.mark.parametrize("case", list(_trajectories()))
def test_health_and_classify_match_reference(case):
    diags = _trajectories()[case]
    tdiags = {k: torch.tensor(v) for k, v in diags.items()}
    for cfg_args in ({}, dict(stall_window=5, stall_tol=1e-2),
                     dict(divergence_factor=2.0, consensus_floor=0.0)):
        jcfg = jobs.HealthConfig(**cfg_args)
        tcfg = tobs.HealthConfig(**cfg_args)
        assert (tobs.check_health(tdiags, tcfg)
                == jobs.check_health(diags, jcfg))
        for reached in (True, False):
            assert (tobs.classify_run(tdiags, reached, tcfg)
                    == jobs.classify_run(diags, reached, jcfg))


def test_health_config_fields_match_reference():
    assert ([(f.name, f.default) for f in dataclasses.fields(tobs.HealthConfig)]
            == [(f.name, f.default)
                for f in dataclasses.fields(jobs.HealthConfig)])


def test_report_render_matches_reference():
    diags = dict(_trajectories()["healthy"])
    diags.update(msgs_delivered=np.full(60, 10.0, np.float32),
                 comm_floats=np.full(60, 96.0, np.float32),
                 resid_max=np.geomspace(1.0, 1e-2, 60).astype(np.float32))
    spans = [{"name": "stats", "ts": 0.0, "dur": 5.0, "depth": 0, "args": {}},
             {"name": "segment", "ts": 6.0, "dur": 50.0, "depth": 0,
              "args": {}},
             {"name": "inner", "ts": 7.0, "dur": 2.0, "depth": 1, "args": {}}]
    meta = {"executor": "dense", "m": 5}
    md_t, data_t = tobs.report.render(
        {k: torch.tensor(v) for k, v in diags.items()}, spans, meta)
    md_j, data_j = jobs.report.render(diags, spans, meta)
    assert md_t == md_j and data_t == data_j


# --------------------------------------------------------------------------
# tracer
# --------------------------------------------------------------------------


def test_spans_nest_and_tracing_off_is_a_no_op(tmp_path):
    assert tobs.current() is None
    assert tobs.span("x") is tobs.span("y")      # the shared null context
    tracer = tobs.Tracer()
    with tobs.use(tracer):
        assert tobs.current() is tracer
        with tobs.span("outer", a=1):
            with tobs.span("inner"):
                pass
            with tobs.span("inner"):
                pass
    assert tobs.current() is None
    assert [(s["name"], s["depth"]) for s in tracer.spans] == [
        ("inner", 1), ("inner", 1), ("outer", 0)]
    paths = tracer.export(tmp_path)
    assert tobs.validate_trace(paths["trace"]) == 3
    assert jobs.validate_trace(paths["trace"]) == 3
    assert len(paths["spans"].read_text().splitlines()) == 3
    # an overlap that does not nest is refused by both packages
    doc = json.loads(paths["trace"].read_text())
    doc["traceEvents"][1]["dur"] = 1e9
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps(doc))
    for mod in (tobs, jobs):
        with pytest.raises(ValueError, match="nesting"):
            mod.validate_trace(bad)


def test_timed_and_block_until_ready_on_cpu_tensors():
    x = torch.ones(3)
    out, dt = tobs.timed(lambda: {"a": (x + 1, [x * 2])}, repeats=2)
    assert torch.equal(out["a"][0], x + 1) and dt >= 0.0
    tobs.block_until_ready({"a": (x, None, [x])})      # nothing to wait for


def test_engine_spans_only_while_a_tracer_is_installed():
    _, _, _, st = _stats(5)
    runner = te.make_runner(st, tg.ring(5), te.ConsensusConfig(r=1, iters=4))
    tracer = tobs.Tracer()
    with tobs.use(tracer):
        s, _ = runner.run_segment(runner.init_state(), 3)
        runner.run(s)
        te.produce_stats(torch.ones(2, 4, 3), torch.ones(2, 4, 1))
    assert [(x["name"], x["args"]) for x in tracer.spans] == [
        ("segment", {"executor": "dense", "start": 0, "iters": 3}),
        ("segment", {"executor": "dense", "start": 3, "iters": 1}),
        ("stats", {"producer": "materialized", "precision": "fp32"})]
    runner.run()                # no tracer: nothing is recorded anywhere
    assert len(tracer.spans) == 3


# --------------------------------------------------------------------------
# telemetry
# --------------------------------------------------------------------------

RUNS = {
    "dense": ("dense", {}),
    "colored0": ("colored", dict(staleness=0)),
    "colored2": ("colored", dict(staleness=2)),
    "southwell": ("colored", dict(order="gauss_southwell")),
}


def _run(mod, st, g, cfg, run):
    executor, kw = RUNS[run]
    if executor == "dense":
        return mod.fit_dense(st, g, cfg)
    return mod.fit_colored(st, g, cfg, **kw)


@pytest.mark.parametrize("run", list(RUNS))
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_telemetry_counters_match_reference(graph, run):
    gt, gj = getattr(tg, graph)(*GRAPHS[graph]), getattr(jg, graph)(
        *GRAPHS[graph])
    _, _, sj, st = _stats(gt.m, seed=len(graph))
    kw = dict(r=1, iters=10, tau=2.0, zeta=1.0, telemetry=True)
    _, dj = _run(je, sj, gj, je.ConsensusConfig(**kw), run)
    _, dt = _run(te, st, gt, te.ConsensusConfig(**kw), run)
    assert set(dt) == set(dj)
    for key in ("msgs_delivered", "msgs_stale", "msgs_dropped",
                "agg_rejected", "comm_floats"):
        assert dt[key].dtype == torch.float32
        np.testing.assert_array_equal(dt[key].numpy(), np.asarray(dj[key]),
                                      err_msg=key)
    scale = float(np.abs(np.asarray(dj["resid_max"])).max())
    np.testing.assert_allclose(dt["resid_max"].numpy(),
                               np.asarray(dj["resid_max"]), rtol=1e-4,
                               atol=1e-5 * scale)


@pytest.mark.parametrize("run", list(RUNS))
def test_telemetry_off_keeps_keys_and_bits(run):
    """Telemetry adds keys and changes no bit of the others; with it off
    the keys are the six the engine always reported."""
    gt = tg.paper_fig2a()
    _, _, _, st = _stats(gt.m)
    cfg = te.ConsensusConfig(r=2, iters=6, tau=2.0, zeta=1.0)
    s0, d0 = _run(te, st, gt, cfg, run)
    s1, d1 = _run(te, st, gt, dataclasses.replace(cfg, telemetry=True), run)
    assert tuple(d0) == te.DIAG_KEYS
    assert set(d1) == set(te.DIAG_KEYS + te.TELEMETRY_KEYS + ("comm_floats",))
    for a, b in zip(s0, s1):
        assert torch.equal(a, b)
    for key in d0:
        assert torch.equal(d0[key], d1[key]), key


def test_telemetry_on_an_empty_segment():
    _, _, _, st = _stats(5)
    runner = te.make_runner(st, tg.ring(5),
                            te.ConsensusConfig(r=1, iters=2, telemetry=True))
    _, d = runner.run_segment(runner.init_state(), 0)
    assert all(v.shape == (0,) for v in d.values()) and "comm_floats" in d


# --------------------------------------------------------------------------
# fit(trace_dir=, telemetry=, health=) against the reference
# --------------------------------------------------------------------------


def test_fit_trace_dir_writes_a_trace_the_reference_accepts(tmp_path):
    H, T, _, _ = _stats(5)
    g = tg.ring(5)
    cfg = te.ConsensusConfig(r=1, iters=8, tau=2.0, zeta=1.0)
    st, diags = td.fit(torch.tensor(H), torch.tensor(T), g, cfg,
                       telemetry=True, trace_dir=tmp_path / "t")
    trace = tmp_path / "t" / "trace.json"
    assert tobs.validate_trace(trace) == jobs.validate_trace(trace) == 2
    names = [e["name"] for e in json.loads(trace.read_text())["traceEvents"]]
    assert names == ["stats", "segment"]
    report = json.loads((tmp_path / "t" / "report.json").read_text())
    assert report["health"]["healthy"] and report["iterations"] == 8
    assert report["meta"] == {"executor": "dense", "m": 5, "n_edges": 5,
                              "iters": 8, "aggregator": "mean",
                              "telemetry": True}
    assert report["comm"]["msgs_delivered_total"] == 2 * 5 * 8
    # the reference's traced fit on the same inputs: same layout, same meta
    jd.fit(jnp.asarray(H), jnp.asarray(T), jg.ring(5),
           je.ConsensusConfig(r=1, iters=8, tau=2.0, zeta=1.0),
           telemetry=True, trace_dir=tmp_path / "j")
    jreport = json.loads((tmp_path / "j" / "report.json").read_text())
    assert jreport["meta"] == report["meta"]
    assert set(jreport) == set(report)
    assert jreport["comm"].keys() == report["comm"].keys()
    assert tobs.validate_trace(tmp_path / "j" / "trace.json") >= 2
    for key in ("iterations",):
        assert jreport[key] == report[key]
    np.testing.assert_allclose(report["objective_final"],
                               jreport["objective_final"], rtol=1e-4)
    assert torch.isfinite(st.U).all()
    assert float(diags["comm_floats"][0]) == tobs.modeled_floats_per_iter(
        "dense", L=12, r=1, n_edges=5)


@pytest.mark.parametrize("kw,match", [
    (dict(checkpoint_every=2), "checkpoint_dir"),
    (dict(resume=True), "checkpoint_dir"),
    (dict(health=True), "checkpoint_dir"),
    (dict(checkpoint_dir="ck", checkpoint_every=-1), "checkpoint_every"),
])
def test_fit_checkpoint_and_health_validation_matches_reference(kw, match,
                                                                tmp_path):
    """The same bad calls raise the same ValueError in both packages,
    before the stats pass."""
    if "checkpoint_dir" in kw:
        kw = dict(kw, checkpoint_dir=tmp_path / "ck")
    cfg = dict(r=2, iters=2)
    with pytest.raises(ValueError, match=match) as tj:
        jd.fit(jnp.ones((4, 6, 5)), jnp.ones((4, 6, 1)), jg.ring(4),
               je.ConsensusConfig(**cfg), **kw)
    with pytest.raises(ValueError, match=match) as tt:
        td.fit(torch.ones(4, 6, 5), torch.ones(4, 6, 1), tg.ring(4),
               te.ConsensusConfig(**cfg), **kw)
    assert str(tt.value) == str(tj.value)
    assert not (tmp_path / "ck").exists()


def test_quickstart_trace_mode(tmp_path, capsys):
    out = quickstart.trace_demo(tmp_path / "qt", iters=30, device="cpu")
    assert "TRACE_OK" in capsys.readouterr().out
    assert out["report"]["health"]["healthy"] and out["n_events"] == 2
    assert float(out["diags"]["msgs_delivered"].sum()) == 2 * 8 * 30
