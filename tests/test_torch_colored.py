"""Port parity: the colored Gauss-Seidel executor (``engine.fit_colored``)
against the JAX reference, and the identities the port claims for itself.

Inputs are numpy draws through the reference's ``sufficient_stats``; the
port gets the same statistics.  Trajectories run at r = 1 for up to 12
iterations (the all-ones start is symmetric in U's columns, ROADMAP queue
3).  Tolerances, fp32: U, A, lam and U·A within atol 1e-4; every
diagnostic within rtol 1e-4 plus atol 1e-5 of its own scale.

The reference's own bitwise relations (staleness 1 ≡ Jacobian, Southwell
ties ≡ fixed order) fail on this toolchain's jax, so those identities are
tested inside ``repro_torch`` only, where on CPU tensors they hold bit for
bit.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.core import engine as je  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402

GRAPHS = {"paper_fig2a": (), "ring": (6,), "star": (5,)}


def _stats(m, N=24, L=12, d=3, seed=0):
    rng = np.random.default_rng(seed)
    H = (rng.standard_normal((m, N, L)) / np.sqrt(L)).astype(np.float32)
    T = rng.standard_normal((m, N, d)).astype(np.float32)
    sj = je.sufficient_stats(jnp.asarray(H), jnp.asarray(T))
    return sj, convert.stats_from_numpy(sj.G, sj.R, sj.n, sj.t2,
                                        device="cpu")


def _graphs(name):
    return getattr(tg, name)(*GRAPHS[name]), getattr(jg, name)(*GRAPHS[name])


def _close(a, b, **tol):
    np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


@pytest.mark.parametrize("order,staleness", [("fixed", 0), ("fixed", 1),
                                             ("fixed", 3),
                                             ("gauss_southwell", 0)])
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_fit_colored_matches_reference(graph, order, staleness):
    gt, gj = _graphs(graph)
    sj, st = _stats(gt.m, seed=len(graph))
    kw = dict(r=1, iters=12, tau=2.0, zeta=1.0)
    stj, dj = je.fit_colored(sj, gj, je.ConsensusConfig(**kw),
                             staleness=staleness, order=order)
    stt, dt = te.fit_colored(st, gt, te.ConsensusConfig(**kw),
                             staleness=staleness, order=order)
    for a, b in zip(stt, stj):
        _close(a, b, atol=1e-4, rtol=0)
    _close(stt.U @ stt.A, stj.U @ stj.A, atol=1e-4, rtol=0)
    assert set(dt) == set(dj)
    for k in dj:
        scale = float(np.abs(np.asarray(dj[k])).max())
        _close(dt[k], dj[k], rtol=1e-4, atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("agg", ["trimmed_mean", "coordinate_median"])
@pytest.mark.parametrize("order,staleness", [("fixed", 0), ("fixed", 3),
                                             ("gauss_southwell", 0)])
def test_robust_fit_colored_matches_reference(order, staleness, agg):
    """The robust aggregators in the colored sweeps, at r = 1 over 12
    iterations on paper_fig2a, with the audit counter's rows; the same
    tolerances as the mean path."""
    gt, gj = _graphs("paper_fig2a")
    sj, st = _stats(gt.m, seed=5)
    kw = dict(r=1, iters=12, tau=2.0, zeta=1.0, aggregator=agg,
              telemetry=True)
    stj, dj = je.fit_colored(sj, gj, je.ConsensusConfig(**kw),
                             staleness=staleness, order=order)
    stt, dt = te.fit_colored(st, gt, te.ConsensusConfig(**kw),
                             staleness=staleness, order=order)
    _close(stt.U @ stt.A, stj.U @ stj.A, atol=1e-4, rtol=0)
    assert set(dt) == set(dj)
    for k in dj:
        scale = float(np.abs(np.asarray(dj[k])).max())
        _close(dt[k], dj[k], rtol=1e-4, atol=1e-5 * scale, err_msg=k)


@pytest.mark.parametrize("graph", list(GRAPHS))
def test_jacobian_schedule_and_staleness_one_are_fit_dense(graph):
    """One class, or staleness 1 under any coloring, is the Jacobian sweep:
    the state and every diagnostic bit for bit on CPU tensors (each class's
    neighbor sums add the same edges in the same order as the full
    exchange, and both executors read a contiguous U, the dense step making
    the solver's result contiguous before its diagnostics)."""
    gt, _ = _graphs(graph)
    _, st = _stats(gt.m)
    cfg = te.ConsensusConfig(r=2, iters=15, tau=2.0, zeta=1.0)
    assert len(gt.chromatic_schedule()) > 1
    dense, ddiag = te.fit_dense(st, gt, cfg)
    runs = [te.fit_colored(st, gt, cfg,
                           schedule=te.jacobian_schedule(gt.m)),
            te.fit_colored(st, gt, cfg, staleness=1)]
    for state, diag in runs:
        for a, b in zip(state, dense):
            assert torch.equal(a, b)
        for k in ddiag:
            assert torch.equal(diag[k], ddiag[k]), k


def test_gauss_southwell_ties_keep_fixed_order():
    """Iteration 0 starts from equal subspaces, so every class score ties
    and the stable sort keeps schedule order: the first Southwell
    iteration IS the fixed sweep; with one class there is nothing to
    reorder at any iteration."""
    gt, _ = _graphs("paper_fig2a")
    _, st = _stats(gt.m)
    cfg = te.ConsensusConfig(r=2, iters=1, tau=2.0, zeta=1.0)
    fixed, _ = te.fit_colored(st, gt, cfg)
    gs, _ = te.fit_colored(st, gt, cfg, order="gauss_southwell")
    assert torch.equal(gs.U, fixed.U) and torch.equal(gs.A, fixed.A)
    cfg = te.ConsensusConfig(r=2, iters=10, tau=2.0, zeta=1.0)
    one = te.jacobian_schedule(gt.m)
    fixed, _ = te.fit_colored(st, gt, cfg, schedule=one)
    gs, _ = te.fit_colored(st, gt, cfg, schedule=one, order="gauss_southwell")
    assert torch.equal(gs.U, fixed.U)


def test_staleness_delays_messages_and_gauss_seidel_beats_jacobian():
    gt, _ = _graphs("paper_fig2a")
    _, st = _stats(gt.m)
    cfg1 = te.ConsensusConfig(r=2, iters=1, tau=2.0, zeta=1.0)
    dense1, _ = te.fit_dense(st, gt, cfg1)
    for k in (1, 2, 5):   # iteration 0 reads U^0 whatever the staleness
        assert torch.equal(te.fit_colored(st, gt, cfg1, staleness=k)[0].U,
                           dense1.U)
    cfg = te.ConsensusConfig(r=2, iters=20, tau=2.0, zeta=1.0)
    _, jac = te.fit_dense(st, gt, cfg)
    _, fresh = te.fit_colored(st, gt, cfg)
    _, stale = te.fit_colored(st, gt, cfg, staleness=3)
    assert float(fresh["objective"][-1]) < float(jac["objective"][-1])
    assert torch.isfinite(stale["objective"]).all()
    assert not torch.allclose(stale["objective"], fresh["objective"])


def test_colored_runner_segments_equal_one_run():
    """The staleness window rides in RunState.hist, so a split run is the
    uninterrupted run."""
    gt, _ = _graphs("ring")
    _, st = _stats(gt.m)
    cfg = te.ConsensusConfig(r=2, iters=9, tau=2.0, zeta=1.0)
    for kw in (dict(staleness=2), dict(order="gauss_southwell")):
        runner = te.make_runner(st, gt, cfg, executor="colored", **kw)
        s, d1 = runner.run_segment(runner.init_state(), 4)
        s, d2 = runner.run(s)
        s_all, d_all = runner.run()
        assert s.k == s_all.k == 9
        assert torch.equal(s.U, s_all.U) and torch.equal(s.lam, s_all.lam)
        assert torch.equal(torch.cat([d1["objective"], d2["objective"]]),
                           d_all["objective"])
    assert runner.executor == "colored"


@pytest.mark.parametrize("kw,match", [
    (dict(schedule=((0, 1), (2, 3))), "partition"),
    (dict(schedule=((0, 1, 2), (2, 3, 4))), "twice"),
    (dict(schedule=((0, 1, 2, 3, 7),)), "out of range"),
    (dict(staleness=-1), "staleness"),
    (dict(order="southwell"), "unknown order"),
    (dict(order="gauss_southwell", staleness=2), "staleness=0"),
])
def test_schedule_validation_matches_reference(kw, match):
    """The same bad calls raise the same ValueError in both packages."""
    sj, st = _stats(5)
    with pytest.raises(ValueError, match=match):
        je.fit_colored(sj, jg.ring(5), je.ConsensusConfig(r=2, iters=2), **kw)
    with pytest.raises(ValueError, match=match):
        te.fit_colored(st, tg.ring(5), te.ConsensusConfig(r=2, iters=2), **kw)


def test_make_runner_executor_dispatch():
    _, st = _stats(4)
    g, cfg = tg.ring(4), te.ConsensusConfig(r=2, iters=2)
    assert te.make_runner(st, g, cfg).executor == "dense"
    with pytest.raises(ValueError, match="needs tape="):
        te.make_runner(st, g, cfg, executor="async")
    from repro_torch import netsim

    runner = te.make_runner(st, g, cfg, executor="async",
                            tape=netsim.zero_delay_tape(2, g))
    assert runner.executor == "async"
    assert torch.isfinite(runner.run()[0].U).all()
    with pytest.raises(ValueError, match="only apply to executor='async'"):
        te.make_runner(st, g, cfg, tape=netsim.zero_delay_tape(2, g))
    with pytest.raises(ValueError, match="needs mesh= and agent_axes="):
        te.make_runner(st, g, cfg, executor="sharded")
    with pytest.raises(ValueError, match="unknown executor"):
        te.make_runner(st, g, cfg, executor="gossip")
    with pytest.raises(ValueError, match="only apply"):
        te.make_runner(st, g, cfg, staleness=1)
