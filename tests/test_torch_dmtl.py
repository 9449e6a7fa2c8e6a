"""Port parity: MTL-ELM, DMTL-ELM (materialized and fused), FO-DMTL-ELM and
the streaming stats pipeline, against the JAX reference on identical numpy
inputs.

Tolerances: first iterations 1e-4; long runs compare rotation-invariant
quantities (objective, lagrangian, U·A, predictions) at 1e-3 relative.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import dmtl_elm as jd  # noqa: E402
from repro.core import elm as jelm  # noqa: E402
from repro.core import engine as je  # noqa: E402
from repro.core import fo_dmtl_elm as jfo  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro.core import mtl_elm as jm  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import dmtl_elm as td  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import fo_dmtl_elm as tfo  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.core import mtl_elm as tm  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(a, b, **tol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), **tol)


def _regression(seed=0, m=6, n_train=16, n_test=40, L=24, r=2):
    data = jsyn.multitask_regression(jax.random.PRNGKey(seed), m=m,
                                     n_train=n_train, n_test=n_test, L=L,
                                     r=r, noise=0.1)
    return [np.asarray(x) for x in data]


# The paper's initializations are symmetric in the r columns of U (MTL:
# A = ones; DMTL: U = A = ones), so with r >= 2 the columns stay equal in
# exact arithmetic and only roundoff splits them: the early trajectory of
# an r >= 2 run follows the fp32 noise of whichever package runs it.  Port
# and reference trajectories are therefore compared at r = 1, and r = 2 runs
# where they have converged (ROADMAP queue 3).


@pytest.mark.parametrize("u_solver", ["kron", "cg"])
def test_mtl_elm_trajectory_matches_reference(u_solver):
    H, T, H_te, _ = _regression()
    kw = dict(r=1, mu1=0.1, mu2=0.1, iters=30, u_solver=u_solver)
    sj, oj = jm.mtl_elm_fit(jnp.asarray(H), jnp.asarray(T),
                            jm.MTLELMConfig(**kw))
    st, ot = tm.mtl_elm_fit(_t(H), _t(T), tm.MTLELMConfig(**kw))
    _close(ot, oj, rtol=1e-3)
    _close(st.U @ st.A, np.asarray(sj.U @ sj.A), rtol=1e-3, atol=1e-5)
    _close(tm.mtl_objective(_t(H), _t(T), st.U, st.A, 0.1, 0.1), ot[-1],
           rtol=1e-4)


@pytest.mark.parametrize("u_solver", ["kron", "cg"])
def test_mtl_elm_converged_r2_matches_reference(u_solver):
    H, T, H_te, _ = _regression()
    kw = dict(r=2, mu1=0.1, mu2=0.1, iters=150, u_solver=u_solver)
    sj, oj = jm.mtl_elm_fit(jnp.asarray(H), jnp.asarray(T),
                            jm.MTLELMConfig(**kw))
    st, ot = tm.mtl_elm_fit(_t(H), _t(T), tm.MTLELMConfig(**kw))
    _close(ot[-1], oj[-1], rtol=1e-3)
    _close(st.U @ st.A, np.asarray(sj.U @ sj.A), rtol=1e-3, atol=1e-5)
    _close(tm.mtl_elm_predict(st.U, st.A[0], _t(H_te[0])),
           jm.mtl_elm_predict(sj.U, sj.A[0], jnp.asarray(H_te[0])),
           rtol=1e-3, atol=1e-5)


@pytest.mark.parametrize("producer", ["materialized", "fused"])
def test_dmtl_fit_dense_matches_reference(producer):
    rng = np.random.default_rng(0)
    m, N, d_in, L = 5, 20, 6, 16
    X = rng.standard_normal((m, N, d_in)).astype(np.float32) / 2
    T = rng.standard_normal((m, N, 2)).astype(np.float32)
    fj = jelm.make_feature_map(jax.random.PRNGKey(3), d_in, L)
    ft = convert.feature_map_from_numpy(fj.W, fj.b, device="cpu")
    kw = dict(r=2, mu1=1.0, mu2=1.0, tau=2.0, zeta=1.0, iters=5,
              stats_producer=producer, u_solver="pcg")
    if producer == "fused":
        inj, intt, fmj, fmt = jnp.asarray(X), _t(X), fj, ft
    else:
        Hn = np.asarray(fj(jnp.asarray(X)))
        inj, intt, fmj, fmt = jnp.asarray(Hn), _t(Hn), None, None
    stj, dj = jd.fit(inj, jnp.asarray(T), jg.paper_fig2a(),
                     je.ConsensusConfig(**kw), feature_map=fmj)
    stt, dt = td.fit(intt, _t(T), tg.paper_fig2a(),
                     te.ConsensusConfig(**kw), feature_map=fmt)
    for a, b in zip(stt, stj):
        _close(a, b, rtol=1e-4, atol=1e-4)
    for k in dj:
        _close(dt[k], dj[k], rtol=1e-4, atol=1e-5)
    st2, _ = td.dmtl_elm_fit(intt, _t(T), tg.paper_fig2a(),
                             te.ConsensusConfig(**kw), feature_map=fmt)
    assert torch.equal(st2.U, stt.U)


def test_dmtl_helpers_match_reference():
    H, T, _, _ = _regression(m=4)
    g = jg.ring(4)
    S = g.incidence()
    rng = np.random.default_rng(1)
    U = rng.standard_normal((4, 24, 2)).astype(np.float32)
    A = rng.standard_normal((4, 2, 1)).astype(np.float32)
    lam = rng.standard_normal((4, 24, 2)).astype(np.float32)
    _close(td.augmented_lagrangian(_t(H), _t(T), _t(U), _t(A), _t(lam),
                                   _t(S), 0.3, 0.2, 1.0),
           jd.augmented_lagrangian(*(jnp.asarray(x) for x in
                                     (H, T, U, A, lam, S)), 0.3, 0.2, 1.0),
           rtol=1e-5)
    _close(td.consensus_residual(_t(U), _t(S)),
           jd.consensus_residual(jnp.asarray(U), jnp.asarray(S)), rtol=1e-5)
    _close(td.dmtl_objective(_t(H), _t(T), _t(U), _t(A), 0.3, 0.2),
           jd.dmtl_objective(*(jnp.asarray(x) for x in (H, T, U, A)),
                             0.3, 0.2), rtol=1e-5)
    _close(td.dmtl_elm_predict(_t(U[0]), _t(A[0]), _t(H[0])),
           jd.dmtl_elm_predict(*(jnp.asarray(x) for x in (U[0], A[0], H[0]))),
           rtol=1e-5, atol=1e-6)


def test_fo_dmtl_and_lipschitz_match_reference():
    H, T, _, _ = _regression(m=5)
    kw = dict(r=1, mu1=0.1, mu2=0.1, tau=8.0, zeta=1.0, iters=60)
    stj, dj = jfo.fo_dmtl_elm_fit(jnp.asarray(H), jnp.asarray(T),
                                  jg.ring(5), je.ConsensusConfig(**kw))
    stt, dt = tfo.fo_dmtl_elm_fit(_t(H), _t(T), tg.ring(5),
                                  te.ConsensusConfig(**kw))
    for k in ("objective", "lagrangian"):
        _close(dt[k], dj[k], rtol=1e-3, atol=1e-6)
    _close(stt.U @ stt.A, np.asarray(stj.U @ stj.A), rtol=1e-3, atol=1e-5)
    _close(tfo.lipschitz_bound(_t(H), stt.A),
           jfo.lipschitz_bound(jnp.asarray(H), jnp.asarray(stt.A.numpy())),
           rtol=1e-4)


def test_fit_rejects_what_later_slices_bring():
    """executor="colored" came with slice 2 (tested below), checkpointing,
    telemetry, tracing and health with ROADMAP queue 1 item 3
    (``test_torch_obs.py``, ``test_torch_checkpoint.py``), the async
    executor and the robust aggregators with netsim (item 4,
    ``test_torch_netsim.py``): they run, an unknown aggregator and an async
    call without exactly one of tape=/channel= are refused as the
    reference refuses them, "sharded" still raises naming slice 3, and the
    colored-only keywords are refused elsewhere with the reference's
    messages."""
    from repro_torch import netsim

    H = torch.ones(4, 6, 5)
    T = torch.ones(4, 6, 1)
    g, cfg = tg.ring(4), te.ConsensusConfig(r=2, iters=1)
    st, diags = td.fit(H, T, g, cfg, executor="async",
                       channel=netsim.ChannelModel(drop=0.5, seed=1))
    assert torch.isfinite(st.U).all() and "tape_cursor" in diags
    for kw in ({}, dict(tape=netsim.zero_delay_tape(1, g),
                        channel=netsim.ChannelModel())):
        with pytest.raises(ValueError, match="exactly one of"):
            td.fit(H, T, g, cfg, executor="async", **kw)
    with pytest.raises(ValueError, match="only apply to executor='async'"):
        td.fit(H, T, g, cfg, tape=netsim.zero_delay_tape(1, g))
    with pytest.raises(ValueError, match="mesh"):
        td.fit(H, T, g, cfg, executor="sharded")
    with pytest.raises(ValueError, match="unknown executor"):
        td.fit(H, T, g, cfg, executor="gossip")
    with pytest.raises(ValueError, match="feature_map"):
        td.fit(H, T, g, dataclasses.replace(cfg, stats_producer="fused"))
    st, _ = td.fit(H, T, g, dataclasses.replace(cfg, aggregator="krum_like"))
    assert torch.isfinite(st.U).all()
    bad = dataclasses.replace(cfg, aggregator="median_of_means")
    for fit, args in ((td.fit, (H, T, g, bad)),
                      (jd.fit, (jnp.ones((4, 6, 5)), jnp.ones((4, 6, 1)),
                                jg.ring(4), je.ConsensusConfig(
                                    r=2, iters=1,
                                    aggregator="median_of_means")))):
        with pytest.raises(ValueError, match="unknown cfg.aggregator"):
            fit(*args)
    for kw, match in ((dict(staleness=1), "staleness= only applies"),
                      (dict(order="gauss_southwell"), "order= only applies"),
                      (dict(schedule=((0, 1), (2, 3))),
                       "schedule= only applies")):
        with pytest.raises(ValueError, match=match):
            td.fit(H, T, g, cfg, **kw)
        with pytest.raises(ValueError, match=match):
            jd.fit(jnp.ones((4, 6, 5)), jnp.ones((4, 6, 1)), jg.ring(4),
                   je.ConsensusConfig(r=2, iters=1), **kw)


@pytest.mark.parametrize("order,staleness", [("fixed", 0),
                                             ("gauss_southwell", 0),
                                             ("fixed", 2)])
def test_fit_colored_executor_matches_reference(order, staleness):
    """``fit(executor="colored")`` and FO through it, r = 1, against the
    reference's entry points at 1e-4."""
    H, T, _, _ = _regression(m=5)
    kw = dict(r=1, mu1=0.1, mu2=0.1, tau=8.0, zeta=1.0, iters=8)
    ex = dict(executor="colored", order=order, staleness=staleness)
    stj, dj = jd.fit(jnp.asarray(H), jnp.asarray(T), jg.paper_fig2a(),
                     je.ConsensusConfig(**kw), **ex)
    stt, dt = td.fit(_t(H), _t(T), tg.paper_fig2a(), te.ConsensusConfig(**kw),
                     **ex)
    for a, b in zip(stt, stj):
        _close(a, b, rtol=1e-4, atol=1e-4)
    for k in dj:
        _close(dt[k], dj[k], rtol=1e-4, atol=1e-5)
    fj, _ = jfo.fo_dmtl_elm_fit(jnp.asarray(H), jnp.asarray(T),
                                jg.paper_fig2a(), je.ConsensusConfig(**kw),
                                **ex)
    ft, _ = tfo.fo_dmtl_elm_fit(_t(H), _t(T), tg.paper_fig2a(),
                                te.ConsensusConfig(**kw), **ex)
    _close(ft.U @ ft.A, np.asarray(fj.U @ fj.A), rtol=1e-4, atol=1e-4)


def test_fit_with_int8_stats():
    """``cfg.stats_precision="int8"`` runs the int8 stream (seed 0) in the
    stats pass: the fit equals fit_dense on the port's own int8 stats, and
    lands within 5% of the fp32 fit's objective (the reference's draws
    cannot be replayed, so its int8 fit is compared the same way)."""
    H, T, _, _ = _regression(m=5)
    kw = dict(r=1, mu1=0.1, mu2=0.1, tau=8.0, zeta=1.0, iters=20)
    cfg8 = te.ConsensusConfig(stats_precision="int8", **kw)
    st8, d8 = td.fit(_t(H), _t(T), tg.ring(5), cfg8)
    ref8, _ = te.fit_dense(te.sufficient_stats(_t(H), _t(T),
                                               precision="int8"),
                           tg.ring(5), cfg8)
    assert torch.equal(st8.U, ref8.U)
    _, d32 = td.fit(_t(H), _t(T), tg.ring(5), te.ConsensusConfig(**kw))
    _, dj8 = jd.fit(jnp.asarray(H), jnp.asarray(T), jg.ring(5),
                    je.ConsensusConfig(stats_precision="int8", **kw))
    for obj in (d8["objective"][-1], float(dj8["objective"][-1])):
        np.testing.assert_allclose(float(obj), float(d32["objective"][-1]),
                                   rtol=5e-2)
    gs8, _ = td.fit(_t(H), _t(T), tg.ring(5), cfg8, executor="colored")
    assert torch.isfinite(gs8.U).all()


def test_stream_int8_seeds_each_producer_call():
    """The i-th producer call of an int8 stream (a batch, or a chunk of
    one) rounds with quant_seed + i."""
    rng = np.random.default_rng(5)
    batches = [(_t(rng.standard_normal((2, B, 12)).astype(np.float32) / 4),
                _t(rng.standard_normal((2, B, 2)).astype(np.float32)))
               for B in (10, 7)]
    st = tpipe.stream_sufficient_stats(batches, chunk=4, precision="int8",
                                       quant_seed=3)
    base = te.init_stats(2, 12, 2, device="cpu")
    b0 = te.accumulate_stats_chunked(base, *batches[0], 4, precision="int8",
                                     quant_seed=3)       # calls 3, 4, 5
    want = te.accumulate_stats_chunked(b0, *batches[1], 4, precision="int8",
                                       quant_seed=6)     # calls 6, 7
    assert torch.equal(st.G, want.G) and torch.equal(st.R, want.R)
    one = tpipe.stream_sufficient_stats(batches, precision="int8",
                                        quant_seed=3)
    want = te.accumulate_stats(te.accumulate_stats(
        base, *batches[0], precision="int8", quant_seed=3),
        *batches[1], precision="int8", quant_seed=4)
    assert torch.equal(one.G, want.G)


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("producer", ["materialized", "fused"])
def test_stream_sufficient_stats_matches_reference(producer, compensated):
    rng = np.random.default_rng(2)
    fj = jelm.make_feature_map(jax.random.PRNGKey(4), 5, 12)
    ft = convert.feature_map_from_numpy(fj.W, fj.b, device="cpu")
    width = 5 if producer == "fused" else 12
    batches = [(rng.standard_normal((3, B, width)).astype(np.float32),
                rng.standard_normal((3, B, 2)).astype(np.float32))
               for B in (10, 7, 13)]
    kw_j = dict(feature_map=fj) if producer == "fused" else {}
    kw_t = dict(feature_map=ft) if producer == "fused" else {}
    sj = jpipe.stream_sufficient_stats(
        [(jnp.asarray(h), jnp.asarray(t)) for h, t in batches], chunk=4,
        compensated=compensated, producer=producer, **kw_j)
    st = tpipe.stream_sufficient_stats(
        [(_t(h), _t(t)) for h, t in batches], chunk=4,
        compensated=compensated, producer=producer, **kw_t)
    for a, b in zip(st, sj):
        _close(a, b, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="empty feature stream"):
        tpipe.stream_sufficient_stats([])
