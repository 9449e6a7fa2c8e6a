"""Port parity: ``repro_torch.core.solvers`` and ``core.elm`` against the JAX
reference on the same numpy inputs.

Tolerances: 1e-4 relative (plus 1e-5 absolute) for the direct solves in
fp32; CG solutions are compared where both sides stop on the same residual
rule, so the solutions agree to the solve tolerance and the iteration
counts exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test process: xdist's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import elm as jelm  # noqa: E402
from repro.core import solvers as jsol  # noqa: E402
from repro_torch.core import elm as telm  # noqa: E402
from repro_torch.core import solvers as tsol  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-5)


def _spd_problem(seed, m=3, L=12, r=3, N=40):
    rng = np.random.default_rng(seed)
    H = rng.standard_normal((m, N, L)).astype(np.float32) / np.sqrt(N)
    G = np.einsum("mnl,mnk->mlk", H, H).astype(np.float32)
    Ah = rng.standard_normal((m, r, r)).astype(np.float32) / np.sqrt(r)
    M = (Ah @ Ah.transpose(0, 2, 1) + 0.1 * np.eye(r)).astype(np.float32)
    R = rng.standard_normal((L, r)).astype(np.float32)
    return G, M, R


def _t(x):
    return torch.from_numpy(np.asarray(x))


def test_ridge_solve_and_elm_fit_match_reference():
    rng = np.random.default_rng(1)
    H = rng.standard_normal((40, 15)).astype(np.float32)
    T = rng.standard_normal((40, 2)).astype(np.float32)
    ref = np.asarray(jsol.ridge_solve(jnp.asarray(H), jnp.asarray(T), 2.0))
    np.testing.assert_allclose(tsol.ridge_solve(_t(H), _t(T), 2.0).numpy(),
                               ref, **TOL)
    np.testing.assert_allclose(telm.elm_fit(_t(H), _t(T), 2.0).numpy(), ref,
                               **TOL)
    beta = telm.elm_fit(_t(H), _t(T), 2.0)
    np.testing.assert_allclose(
        float(telm.elm_objective(_t(H), _t(T), beta, 2.0)),
        float(jelm.elm_objective(jnp.asarray(H), jnp.asarray(T),
                                 jnp.asarray(beta.numpy()), 2.0)), rtol=1e-5)


def test_kron_solve_matches_reference_multi_and_single_term():
    G, M, R = _spd_problem(0)
    ref = jsol.kron_ridge_solve(jnp.asarray(G), jnp.asarray(M),
                                jnp.asarray(R), 0.5)
    np.testing.assert_allclose(
        tsol.kron_ridge_solve(_t(G), _t(M), _t(R), 0.5).numpy(),
        np.asarray(ref), **TOL)
    ref1 = jsol.kron_ridge_solve(jnp.asarray(G[0]), jnp.asarray(M[0]),
                                 jnp.asarray(R), 0.5)
    np.testing.assert_allclose(
        tsol.kron_ridge_solve(_t(G[0]), _t(M[0]), _t(R), 0.5).numpy(),
        np.asarray(ref1), **TOL)


def test_sylvester_solve_matches_reference_and_kron():
    G, M, R = _spd_problem(2)
    ref = np.asarray(jsol.sylvester_ridge_solve(
        jnp.asarray(G[0]), jnp.asarray(M[0]), jnp.asarray(R), 0.3))
    ours = tsol.sylvester_ridge_solve(_t(G[0]), _t(M[0]), _t(R), 0.3)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-3, atol=1e-4)
    eig = torch.linalg.eigh(_t(G[0]))
    np.testing.assert_allclose(
        tsol.sylvester_ridge_solve(_t(G[0]), _t(M[0]), _t(R), 0.3,
                                   eig_g=eig).numpy(), ref,
        rtol=1e-3, atol=1e-4)
    kron = tsol.kron_ridge_solve(_t(G[0]), _t(M[0]), _t(R), 0.3)
    np.testing.assert_allclose(ours.numpy(), kron.numpy(), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("precond", [None, "jacobi"])
def test_sum_sylvester_cg_matches_reference(precond):
    G, M, R = _spd_problem(3)
    x_ref, it_ref = jsol.sum_sylvester_cg(
        jnp.asarray(G), jnp.asarray(M), jnp.asarray(R), 0.2, tol=1e-5,
        precond=precond, return_info=True)
    x, it = tsol.sum_sylvester_cg(_t(G), _t(M), _t(R), 0.2, tol=1e-5,
                                  precond=precond, return_info=True)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=1e-3,
                               atol=1e-4)
    assert abs(int(it) - int(it_ref)) <= 1


def test_cg_solve_plain_matches_reference():
    G, _, R = _spd_problem(4)
    A = G[0] + 0.5 * np.eye(G.shape[-1], dtype=np.float32)
    b = R[:, 0]
    x_ref, it_ref = jsol.cg_solve(lambda v: jnp.asarray(A) @ v,
                                  jnp.asarray(b), tol=1e-6, return_info=True)
    x, it = tsol.cg_solve(lambda v: _t(A) @ v, _t(b), tol=1e-6,
                          return_info=True)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=1e-3,
                               atol=1e-4)
    assert abs(int(it) - int(it_ref)) <= 1


def test_batched_pcg_agents_converge_at_different_iterations():
    """The reference vmaps CG over agents: the loop runs until EVERY agent
    has converged, and a converged agent keeps its state.  Agents with very
    different conditioning stop at different counts; the batched port must
    give each agent its own count and solution."""
    rng = np.random.default_rng(7)
    m, L, r = 4, 16, 2
    Gs, Ms, Rs = [], [], []
    for t in range(m):
        scales = np.logspace(0, t, L).astype(np.float32)
        H = rng.standard_normal((64, L)).astype(np.float32) / 8.0 * scales
        Gs.append(H.T @ H)
        Ah = rng.standard_normal((r, r)).astype(np.float32)
        Ms.append(Ah @ Ah.T + 0.1 * np.eye(r, dtype=np.float32))
        Rs.append(rng.standard_normal((L, r)).astype(np.float32))
    G, M, R = (np.stack(x).astype(np.float32) for x in (Gs, Ms, Rs))
    c = np.asarray([0.1, 0.2, 0.3, 0.4], np.float32)

    def one(g, mm, rr, cc):
        return jsol.sum_sylvester_cg(g, mm, rr, cc, tol=1e-5,
                                     precond="jacobi", return_info=True)

    x_ref, it_ref = jax.vmap(one)(*(jnp.asarray(a) for a in (G, M, R, c)))
    x, it = tsol.sum_sylvester_cg(_t(G)[:, None], _t(M)[:, None], _t(R),
                                  _t(c), tol=1e-5, precond="jacobi",
                                  return_info=True)
    it_ref = np.asarray(it_ref)
    assert len(set(it_ref.tolist())) > 1, "agents should stop apart"
    # each agent of the batch stops exactly where its own solve stops
    single = [
        int(tsol.sum_sylvester_cg(_t(G[t]), _t(M[t]), _t(R[t]), float(c[t]),
                                  tol=1e-5, precond="jacobi",
                                  return_info=True)[1])
        for t in range(m)
    ]
    np.testing.assert_array_equal(it.numpy(), single)
    # against the reference: the stopping test compares an fp32 residual
    # with the threshold, so summation-order roundoff can move a count by
    # an iteration or two; the solutions agree to the solve tolerance
    np.testing.assert_allclose(it.numpy(), it_ref, atol=3)
    np.testing.assert_allclose(x.numpy(), np.asarray(x_ref), rtol=2e-3,
                               atol=2e-4)


def test_gram_diag_precond_matches_reference():
    G, M, R = _spd_problem(5)
    ref = jsol.gram_diag_precond(jnp.asarray(G), jnp.asarray(M), 0.7)
    ours = tsol.gram_diag_precond(_t(G), _t(M), 0.7)
    np.testing.assert_allclose(ours(_t(R)).numpy(),
                               np.asarray(ref(jnp.asarray(R))), rtol=1e-6)


def test_unknown_precond_raises():
    G, M, R = _spd_problem(6)
    with pytest.raises(ValueError, match="precond"):
        tsol.sum_sylvester_cg(_t(G), _t(M), _t(R), 0.1, precond="ilu")


@pytest.mark.parametrize("activation", ["sigmoid", "tanh", "relu", "gelu"])
def test_feature_map_matches_reference_on_carried_weights(activation):
    """W, b carried from the reference through numpy: same hidden layer."""
    fj = jelm.make_feature_map(jax.random.PRNGKey(0), 6, 20,
                               activation=activation)
    from repro_torch.convert import feature_map_from_numpy

    ft = feature_map_from_numpy(np.asarray(fj.W), np.asarray(fj.b),
                                activation, device="cpu")
    X = np.random.default_rng(0).standard_normal((9, 6)).astype(np.float32)
    np.testing.assert_allclose(ft(_t(X)).numpy(),
                               np.asarray(fj(jnp.asarray(X))),
                               rtol=1e-5, atol=1e-6)
    beta = np.ones((20, 2), np.float32)
    np.testing.assert_allclose(
        telm.elm_predict(ft, _t(beta), _t(X)).numpy(),
        np.asarray(jelm.elm_predict(fj, jnp.asarray(beta), jnp.asarray(X))),
        rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dist", ["uniform", "normal"])
def test_make_feature_map_draws_from_the_seeded_distribution(dist):
    a = telm.make_feature_map(3, 64, 512, dist=dist, device="cpu")
    b = telm.make_feature_map(torch.Generator().manual_seed(3), 64, 512,
                              dist=dist, device="cpu")
    assert torch.equal(a.W, b.W) and torch.equal(a.b, b.b)
    assert a.W.shape == (64, 512) and a.b.shape == (512,) and a.L == 512
    if dist == "uniform":
        assert float(a.W.min()) >= -1.0 and float(a.W.max()) <= 1.0
        assert abs(float(a.W.mean())) < 0.02
    else:
        assert abs(float(a.W.std()) - 1 / 8) < 0.01
    with pytest.raises(ValueError, match="dist"):
        telm.make_feature_map(0, 2, 2, dist="laplace", device="cpu")
