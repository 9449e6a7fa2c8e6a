"""Port parity: the dense slice of ``repro_torch.core.engine`` against the
JAX reference on the same numpy inputs.

Tolerances (stated per check): stats producers as the Gram ops (fp32 2e-4,
fused fp32 1e-5, bf16 3e-2); one ``agent_update`` / ``dual_step`` 1e-5;
``fit_dense`` U, A and lam over the first 5 iterations 1e-4; longer runs
compare the rotation-invariant quantities (objective, lagrangian,
consensus, gamma, U·A) at 1e-3 relative.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test process: xdist's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import elm as jelm  # noqa: E402
from repro.core import engine as je  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402

DIAG_KEYS = ("objective", "lagrangian", "consensus", "gamma", "gamma_min",
             "primal_sq")


def _t(x):
    return torch.tensor(np.asarray(x))


def _paper_uniform(seed, m, N, L, d=1):
    """§IV-A setup in numpy: H, T ~ U(0, 1), stacked-H columns normalized."""
    rng = np.random.default_rng(seed)
    H = rng.uniform(size=(m * N, L))
    H = (H / np.linalg.norm(H, axis=0, keepdims=True)).reshape(m, N, L)
    return H.astype(np.float32), rng.uniform(size=(m, N, d)).astype(np.float32)


def _stats_pair(H, T):
    sj = je.sufficient_stats(jnp.asarray(H), jnp.asarray(T))
    return sj, convert.stats_from_numpy(sj.G, sj.R, sj.n, sj.t2, device="cpu")


def _close(a, b, **tol):
    np.testing.assert_allclose(np.asarray(a.float() if isinstance(a, torch.Tensor) else a),
                               np.asarray(b), **tol)


# ------------------------------------------------------------------ stats

@pytest.mark.parametrize("precision,tol", [("fp32", 2e-4), ("bf16", 3e-2)])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("shape", [(3, 20, 16), (25, 9)])
def test_sufficient_stats_matches_reference(shape, use_kernel, precision, tol):
    rng = np.random.default_rng(len(shape))
    H = rng.standard_normal(shape).astype(np.float32)
    T = rng.standard_normal(shape[:-1] + (2,)).astype(np.float32)
    sj = je.sufficient_stats(jnp.asarray(H), jnp.asarray(T),
                             use_pallas=use_kernel, precision=precision)
    st = te.sufficient_stats(_t(H), _t(T), use_kernel=use_kernel,
                             precision=precision)
    for a, b in zip(st, sj):
        _close(a, b, rtol=tol, atol=tol)
        assert tuple(a.shape) == tuple(np.shape(b))


@pytest.mark.parametrize("precision,tol", [("fp32", 1e-5), ("bf16", 3e-2)])
@pytest.mark.parametrize("activation", ["sigmoid", "gelu"])
def test_sufficient_stats_fused_matches_reference(activation, precision, tol):
    rng = np.random.default_rng(4)
    X = rng.standard_normal((2, 30, 6)).astype(np.float32) / 3
    T = rng.standard_normal((2, 30, 2)).astype(np.float32)
    fj = jelm.make_feature_map(jax.random.PRNGKey(1), 6, 24,
                               activation=activation)
    ft = convert.feature_map_from_numpy(fj.W, fj.b, activation, device="cpu")
    sj = je.sufficient_stats_fused(jnp.asarray(X), fj, jnp.asarray(T),
                                   precision=precision)
    st = te.sufficient_stats_fused(_t(X), ft, _t(T), precision=precision)
    for a, b in zip(st, sj):
        _close(a, b, rtol=tol, atol=tol)
    # fused == materialized on the same hidden layer
    sm = te.sufficient_stats(ft(_t(X)), _t(T), precision=precision)
    for a, b in zip(st, sm):
        _close(a, b.numpy() if isinstance(b, torch.Tensor) else b,
               rtol=tol, atol=tol)


def test_produce_stats_validation():
    H, T = torch.ones(2, 4, 3), torch.ones(2, 4, 1)
    fm = convert.feature_map_from_numpy(np.ones((3, 5)), np.zeros(5),
                                        device="cpu")
    with pytest.raises(ValueError, match="unknown stats producer"):
        te.produce_stats(H, T, producer="lazy")
    with pytest.raises(ValueError, match="feature_map"):
        te.produce_stats(H, T, producer="fused")
    with pytest.raises(ValueError, match="only applies"):
        te.produce_stats(H, T, feature_map=fm)
    with pytest.raises(ValueError, match="int8"):
        te.produce_stats(H, T, producer="fused", feature_map=fm,
                         precision="int8")
    # int8 is the materialized stream (ported in slice 2)
    st = te.produce_stats(H, T, precision="int8")
    assert st.G.shape == (2, 3, 3) and st.R.shape == (2, 3, 1)


@pytest.mark.parametrize("use_kernel", [True, False])
@pytest.mark.parametrize("B,chunk", [(24, 8), (29, 8)])
def test_int8_chunked_stream_uses_per_chunk_seeds(B, chunk, use_kernel):
    """int8 chunk c rounds with quant_seed + c and the ragged tail with
    quant_seed + k, as the reference's accumulate_stats_chunked: the fold
    equals the port's own one-shot calls on those seeds, added in order."""
    rng = np.random.default_rng(B)
    H = rng.standard_normal((3, B, 12)).astype(np.float32) / 4
    T = rng.standard_normal((3, B, 2)).astype(np.float32)
    seed, k = 5, B // chunk
    st = te.accumulate_stats_chunked(
        te.init_stats(3, 12, 2, device="cpu"), _t(H), _t(T), chunk,
        precision="int8", quant_seed=seed, use_kernel=use_kernel)
    G = torch.zeros(3, 12, 12)
    R = torch.zeros(3, 12, 2)
    bounds = [(c * chunk, (c + 1) * chunk, seed + c) for c in range(k)]
    if B > k * chunk:
        bounds.append((k * chunk, B, seed + k))
    for lo, hi, s in bounds:
        b = te.sufficient_stats(_t(H[:, lo:hi]), _t(T[:, lo:hi]),
                                precision="int8", quant_seed=s,
                                use_kernel=use_kernel)
        G, R = G + b.G, R + b.R
    assert torch.equal(st.G, G) and torch.equal(st.R, R)
    assert float(st.n[0]) == B
    # a different base seed is a different rounding stream
    other = te.accumulate_stats_chunked(
        te.init_stats(3, 12, 2, device="cpu"), _t(H), _t(T), chunk,
        precision="int8", quant_seed=seed + 1, use_kernel=use_kernel)
    assert not torch.equal(other.G, st.G)


@pytest.mark.parametrize("compensated", [False, True])
@pytest.mark.parametrize("producer", ["materialized", "fused"])
@pytest.mark.parametrize("B,chunk", [(24, 8), (29, 8), (5, 8)])
def test_accumulate_stats_chunked_matches_reference(B, chunk, producer,
                                                    compensated):
    """Full chunks plus ONE producer call on the true ragged tail (a zero-
    padded tail would add act(b) rows under the fused producer)."""
    rng = np.random.default_rng(B + chunk)
    d_in, L = 5, 12
    fj = jelm.make_feature_map(jax.random.PRNGKey(2), d_in, L)
    ft = convert.feature_map_from_numpy(fj.W, fj.b, device="cpu")
    if producer == "fused":
        H = rng.standard_normal((3, B, d_in)).astype(np.float32)
        kw_j, kw_t = dict(feature_map=fj), dict(feature_map=ft)
    else:
        H = rng.standard_normal((3, B, L)).astype(np.float32)
        kw_j, kw_t = {}, {}
    T = rng.standard_normal((3, B, 2)).astype(np.float32)
    base_j = je.init_stats(3, L, 2)
    base_t = te.init_stats(3, L, 2, device="cpu")
    sj = je.accumulate_stats_chunked(
        base_j, jnp.asarray(H), jnp.asarray(T), chunk,
        compensated=compensated, producer=producer, **kw_j)
    st = te.accumulate_stats_chunked(
        base_t, _t(H), _t(T), chunk, compensated=compensated,
        producer=producer, **kw_t)
    for a, b in zip(st, sj):
        _close(a, b, rtol=1e-5, atol=1e-5)
    one = te.accumulate_stats(base_t, _t(H), _t(T), producer=producer,
                              **kw_t)
    for a, b in zip(st, one):
        _close(a, b.numpy(), rtol=1e-5, atol=1e-5)
    assert st.n.shape == (3,) and float(st.n[0]) == B


def test_objectives_from_stats_match_reference():
    H, T = _paper_uniform(0, 4, 10, 6, 2)
    sj, st = _stats_pair(H, T)
    rng = np.random.default_rng(0)
    U = rng.standard_normal((4, 6, 3)).astype(np.float32)
    A = rng.standard_normal((4, 3, 2)).astype(np.float32)
    _close(te.objective_from_stats(st, _t(U), _t(A), 0.5, 0.3),
           je.objective_from_stats(sj, jnp.asarray(U), jnp.asarray(A),
                                   0.5, 0.3), rtol=1e-5)
    _close(te.objective_from_stats(st, _t(U[0]), _t(A), 0.5, 0.3,
                                   shared_u=True),
           je.objective_from_stats(sj, jnp.asarray(U[0]), jnp.asarray(A),
                                   0.5, 0.3, shared_u=True), rtol=1e-5)


# ------------------------------------------------------------ ADMM round

def _round_inputs(seed, m=5, N=12, L=8, r=2, d=1):
    H, T = _paper_uniform(seed, m, N, L, d)
    rng = np.random.default_rng(seed)
    U = rng.standard_normal((m, L, r)).astype(np.float32)
    A = rng.standard_normal((m, r, d)).astype(np.float32)
    neigh = rng.standard_normal((m, L, r)).astype(np.float32)
    ct_lam = rng.standard_normal((m, L, r)).astype(np.float32) * 0.1
    deg = np.asarray([2, 3, 2, 2, 3], np.float32)[:m]
    return H, T, U, A, neigh, ct_lam, deg


@pytest.mark.parametrize("u_solver,first_order", [
    ("kron", False), ("sylvester", False), ("cg", False), ("pcg", False),
    ("sylvester", True)])
def test_agent_update_matches_reference(u_solver, first_order):
    H, T, U, A, neigh, ct_lam, deg = _round_inputs(1)
    m = H.shape[0]
    cfg_j = je.ConsensusConfig(r=2, mu1=0.5, mu2=0.5, u_solver=u_solver,
                               first_order=first_order)
    cfg_t = te.ConsensusConfig(r=2, mu1=0.5, mu2=0.5, u_solver=u_solver,
                               first_order=first_order)
    sj, st = _stats_pair(H, T)
    tau = deg + 2.0
    zeta = np.ones(m, np.float32)
    mj = je.NeighborMsgs(*(jnp.asarray(x) for x in (neigh, ct_lam, deg, tau,
                                                    zeta)))
    mt = te.NeighborMsgs(*(_t(x) for x in (neigh, ct_lam, deg, tau, zeta)))
    pre_j = je.hoist_precomp(sj, cfg_j)
    body = jax.vmap(
        lambda s, st_, ms, pc: je.agent_update(s, st_, ms, cfg_j, m_total=m,
                                               precomp=pc),
        in_axes=(0, je.AgentState(0, 0, None), 0,
                 None if pre_j is None else 0))
    Uj, Aj = body(sj, je.AgentState(jnp.asarray(U), jnp.asarray(A), None),
                  mj, pre_j)
    Ut, At = te.agent_update(st, te.AgentState(_t(U), _t(A)), mt, cfg_t,
                             m_total=m, precomp=te.hoist_precomp(st, cfg_t))
    _close(Ut, Uj, rtol=1e-5, atol=1e-5)
    _close(At, Aj, rtol=1e-5, atol=1e-5)


def test_unknown_u_solver_raises():
    H, T, U, A, neigh, ct_lam, deg = _round_inputs(2)
    _, st = _stats_pair(H, T)
    cfg = te.ConsensusConfig(r=2, u_solver="lu")
    msgs = te.NeighborMsgs(_t(neigh), _t(ct_lam), _t(deg), _t(deg + 2),
                           torch.ones(5))
    with pytest.raises(ValueError, match="u_solver"):
        te.agent_update(st, te.AgentState(_t(U), _t(A)), msgs, cfg,
                        m_total=5)


@pytest.mark.parametrize("gamma_floor", [0.0, 0.05])
def test_dual_step_matches_reference(gamma_floor):
    rng = np.random.default_rng(3)
    lam, r_old, r_new = (rng.standard_normal((6, 4, 2)).astype(np.float32)
                         for _ in range(3))
    r_new[2] = 0.0   # a converged edge takes gamma_cap
    cfg_j = je.ConsensusConfig(r=2, gamma_floor=gamma_floor)
    cfg_t = te.ConsensusConfig(r=2, gamma_floor=gamma_floor)
    out_j = je.dual_step(*(jnp.asarray(x) for x in (lam, r_old, r_new)),
                         cfg_j)
    out_t = te.dual_step(_t(lam), _t(r_old), _t(r_new), cfg_t)
    for a, b in zip(out_t, out_j):
        _close(a, b, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- fit_dense

GRAPHS = {"ring": (tg.ring, jg.ring, (5,)),
          "paper_fig2a": (tg.paper_fig2a, jg.paper_fig2a, ()),
          "star": (tg.star, jg.star, (5,))}


@pytest.mark.parametrize("graph,u_solver,first_order", [
    ("ring", "sylvester", False), ("paper_fig2a", "pcg", False),
    ("star", "kron", False), ("ring", "cg", False),
    ("paper_fig2a", "sylvester", True)])
def test_fit_dense_first_iterations_match_reference(graph, u_solver,
                                                    first_order):
    tmake, jmake, args = GRAPHS[graph]
    H, T = _paper_uniform(5, 5, 10, 6, 1)
    sj, st = _stats_pair(H, T)
    kw = dict(r=2, mu1=1.0, mu2=1.0, tau=2.0, zeta=1.0, iters=5,
              u_solver=u_solver, first_order=first_order)
    stj, dj = je.fit_dense(sj, jmake(*args), je.ConsensusConfig(**kw))
    stt, dt = te.fit_dense(st, tmake(*args), te.ConsensusConfig(**kw))
    for a, b in zip(stt, stj):
        _close(a, b, rtol=1e-4, atol=1e-4)
    for k in DIAG_KEYS:
        _close(dt[k], dj[k], rtol=1e-4, atol=1e-5)
        assert dt[k].shape == (5,)


LONG_ITERS = 80
# gamma (a ratio of vanishing residual differences) and the consensus RMS
# amplify fp32 roundoff: on these problems the port in fp64 and the port in
# fp32 differ in gamma about as much after 80 iterations as port and
# reference do.  Both are compared over the first iterations, where they
# are well above that noise; ROADMAP queue 3 records the finding.
RATIO_WINDOW = 12


def _long_runs(graph):
    tmake, jmake, args = GRAPHS[graph]
    H, T = _paper_uniform(6, 5, 10, 6, 1)
    sj, st = _stats_pair(H, T)
    kw = dict(r=2, mu1=1.0, mu2=1.0, iters=LONG_ITERS, u_solver="sylvester")
    stj, dj = je.fit_dense(sj, jmake(*args), je.ConsensusConfig(**kw))
    stt, dt = te.fit_dense(st, tmake(*args), te.ConsensusConfig(**kw))
    return H, (stj, dj), (stt, dt)


@pytest.mark.parametrize("graph", ["ring", "paper_fig2a", "star"])
def test_fit_dense_long_run_invariants_match_reference(graph):
    """Over a long run U itself may drift by a rotation; the objective,
    lagrangian, U·A and the predictions must not."""
    H, (stj, dj), (stt, dt) = _long_runs(graph)
    for k in ("objective", "lagrangian"):
        _close(dt[k], dj[k], rtol=1e-3, atol=1e-6)
    for k in ("consensus", "gamma"):
        _close(dt[k][:RATIO_WINDOW], dj[k][:RATIO_WINDOW], rtol=1e-3,
               atol=1e-6)
    _close(stt.U @ stt.A, np.asarray(stj.U @ stj.A), rtol=1e-3, atol=1e-5)
    _close(_t(H) @ stt.U @ stt.A, np.asarray(H @ stj.U @ stj.A), rtol=1e-3,
           atol=1e-5)


@pytest.mark.xfail(strict=True, reason=(
    "gamma and consensus amplify fp32 roundoff over long runs: the port's "
    "own fp32 and fp64 runs differ in gamma about as much as port and "
    "reference at 80 iterations (ROADMAP queue 3)"))
def test_fit_dense_long_run_gamma_and_consensus_at_1e3():
    _, (_, dj), (_, dt) = _long_runs("ring")
    for k in ("consensus", "gamma"):
        _close(dt[k], dj[k], rtol=1e-3, atol=1e-6)


def test_runner_segments_equal_one_run():
    H, T = _paper_uniform(7, 4, 8, 5, 1)
    _, st = _stats_pair(H, T)
    cfg = te.ConsensusConfig(r=2, iters=9)
    runner = te.make_runner(st, tg.ring(4), cfg)
    s, d1 = runner.run_segment(runner.init_state(), 4)
    s, d2 = runner.run(s)
    s_all, d_all = runner.run()
    assert s.k == s_all.k == 9
    assert torch.equal(s.U, s_all.U) and torch.equal(s.lam, s_all.lam)
    assert torch.equal(torch.cat([d1["objective"], d2["objective"]]),
                       d_all["objective"])
    with pytest.raises(ValueError, match="past cfg.iters"):
        runner.run_segment(s_all, 1)


def test_per_agent_tau_and_scalar_stats_leaves():
    """A per-agent tau array and (G, R)-only stats (scalar n/t2) resolve
    like the reference."""
    H, T = _paper_uniform(8, 4, 8, 5, 1)
    sj, st = _stats_pair(H, T)
    tau = np.asarray([3.0, 4.0, 3.5, 4.5], np.float32)
    sj0 = je.SufficientStats(sj.G, sj.R)
    st0 = te.SufficientStats(st.G, st.R)
    stj, dj = je.fit_dense(sj0, jg.ring(4),
                           je.ConsensusConfig(r=2, tau=tau, iters=4))
    stt, dt = te.fit_dense(st0, tg.ring(4),
                           te.ConsensusConfig(r=2, tau=tau, iters=4))
    _close(stt.U, stj.U, rtol=1e-4, atol=1e-4)
    _close(dt["objective"], dj["objective"], rtol=1e-4, atol=1e-5)


def test_robust_aggregator_names_the_later_slice():
    """The robust aggregators came with netsim (ROADMAP queue 1 item 4):
    ``fit_dense`` with each of them against the reference at r = 1 over 10
    iterations on paper_fig2a (objective and lagrangian at rtol 1e-4, U·A
    at 1e-4, consensus at rtol 1e-3), with the audit counter's rows."""
    H, T = _paper_uniform(9, 5, 8, 6, 1)
    sj, st = _stats_pair(H, T)
    for agg in ("trimmed_mean", "coordinate_median", "krum_like"):
        kw = dict(r=1, iters=10, tau=2.0, zeta=1.0, aggregator=agg,
                  telemetry=True)
        stj, dj = je.fit_dense(sj, jg.paper_fig2a(),
                               je.ConsensusConfig(**kw))
        stt, dt = te.fit_dense(st, tg.paper_fig2a(),
                               te.ConsensusConfig(**kw))
        assert set(dt) == set(dj)
        assert torch.isfinite(stt.U).all()
        if agg == "krum_like":      # a roundoff tie flips its argmin
            continue
        for k in ("objective", "lagrangian"):
            _close(dt[k], dj[k], rtol=1e-4)
        _close(dt["consensus"], dj["consensus"], rtol=1e-3)
        _close(stt.U @ stt.A, stj.U @ stj.A, rtol=1e-4, atol=1e-4)
        _close(dt["agg_rejected"], dj["agg_rejected"], rtol=0)


@pytest.mark.parametrize("graph", ["ring", "paper_fig2a", "star"])
def test_dense_exchange_matches_reference(graph):
    """Segment sums add in edge order like the reference's segment_sum, on
    every device."""
    from repro.core import exchange as jx
    from repro_torch.core import exchange as tx

    tmake, jmake, args = GRAPHS[graph]
    gt, gj = tmake(*args), jmake(*args)
    rng = np.random.default_rng(11)
    U = rng.standard_normal((gt.m, 6, 2)).astype(np.float32)
    lam = rng.standard_normal((gt.n_edges, 6, 2)).astype(np.float32)
    ej = jx.DenseExchange(gj, jnp.float32, None)
    et = tx.DenseExchange(gt, torch.float32, device="cpu")
    vj = ej.gather_views(jnp.asarray(U), jnp.asarray(lam))
    vt = et.gather_views(_t(U), _t(lam))
    _close(vt.neigh, vj.neigh, rtol=1e-6, atol=1e-6)
    _close(vt.ct_lam, vj.ct_lam, rtol=1e-6, atol=1e-6)
    _close(vt.deg_eff, vj.deg_eff, rtol=0)
    _close(et.edge_diff(_t(U)), ej.edge_diff(jnp.asarray(U)), rtol=0)
    for a, b in zip(tx.neighbor_table(gt), jx.neighbor_table(gj)):
        np.testing.assert_array_equal(a, b)
    # the robust path: the candidate table through each aggregator, and
    # its audit
    for agg in ("trimmed_mean", "coordinate_median", "krum_like"):
        ej = jx.DenseExchange(gj, jnp.float32, je.AGGREGATORS[agg])
        et = tx.DenseExchange(gt, torch.float32, te.AGGREGATORS[agg],
                              device="cpu")
        vj = ej.gather_views(jnp.asarray(U), jnp.asarray(lam))
        vt = et.gather_views(_t(U), _t(lam))
        _close(vt.neigh, vj.neigh, rtol=1e-6, atol=1e-6)
        _close(vt.ct_lam, vj.ct_lam, rtol=1e-6, atol=1e-6)
        _close(et.audit(_t(U)), ej.audit(jnp.asarray(U)), rtol=0)


@pytest.mark.parametrize("graph", ["ring", "paper_fig2a", "star"])
def test_fixed_order_segment_sums_keep_index_add_bits(graph):
    """The exchange's fixed-order segment sums give the bits of
    ``index_add_`` on the CPU (a sequential add in edge order onto zeros),
    the sums the exchange made before it, on a hub with 7 terms too."""
    from repro_torch.core import exchange as tx

    tmake, _, args = GRAPHS[graph]
    g = tmake(*args) if graph != "star" else tg.star(8)
    rng = np.random.default_rng(5)
    U = _t(rng.standard_normal((g.m, 6, 2)).astype(np.float32))
    lam = _t(rng.standard_normal((g.n_edges, 6, 2)).astype(np.float32))
    ex = tx.DenseExchange(g, torch.float32, device="cpu")

    def index_add(x, idx):
        return torch.zeros((g.m,) + x.shape[1:]).index_add_(0, idx, x)

    assert torch.equal(ex.neighbor_sum(U), index_add(U[ex.dst], ex.src)
                       + index_add(U[ex.src], ex.dst))
    assert torch.equal(ex.ct_transpose(lam), index_add(lam, ex.src)
                       - index_add(lam, ex.dst))
