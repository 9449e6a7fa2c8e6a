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
    H = torch.ones(4, 6, 5)
    T = torch.ones(4, 6, 1)
    g, cfg = tg.ring(4), te.ConsensusConfig(r=2, iters=1)
    for kw in (dict(executor="colored"), dict(executor="async"),
               dict(checkpoint_dir="ck"), dict(telemetry=True),
               dict(trace_dir="tr"), dict(health=True)):
        with pytest.raises(NotImplementedError, match="slice 2"):
            td.fit(H, T, g, cfg, **kw)
    with pytest.raises(NotImplementedError, match="slice 3"):
        td.fit(H, T, g, cfg, executor="sharded")
    with pytest.raises(ValueError, match="unknown executor"):
        td.fit(H, T, g, cfg, executor="gossip")
    with pytest.raises(ValueError, match="feature_map"):
        td.fit(H, T, g, dataclasses.replace(cfg, stats_producer="fused"))
    with pytest.raises(NotImplementedError, match="slice 2"):
        td.fit(H, T, g, dataclasses.replace(cfg, aggregator="krum_like"))


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
