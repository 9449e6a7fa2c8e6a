"""Port parity: the quickstart flow, ``convert`` and the data generators.

The quickstart's default mode runs on identical numpy inputs (the
reference's own quickstart data) through both packages, the consensus fits
from the same tilted start: the five test MSEs (Gauss-Seidel included)
agree within 1e-3 relative.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test process: xdist's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import elm as jelm  # noqa: E402
from repro.core import engine as je  # noqa: E402
from repro.core import graph as jg  # noqa: E402
from repro.core import mtl_elm as jm  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch import convert, quickstart  # noqa: E402
from repro_torch.core import engine as te  # noqa: E402
from repro_torch.core import graph as tg  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402


def _t(x):
    return torch.tensor(np.asarray(x))


def _close(a, b, **tol):
    a = a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_allclose(a, np.asarray(b), **tol)


@pytest.fixture(scope="module")
def quickstart_both():
    """The quickstart's default mode on identical inputs (the reference's
    own quickstart data): (reference MSEs, port MSEs)."""
    H_tr, T_tr, H_te, T_te = (np.asarray(x) for x in
                              jsyn.multitask_regression(
                                  jax.random.PRNGKey(0), m=8, n_train=16,
                                  n_test=300, L=64, r=2, noise=0.1))
    r, mu = 2, 0.1
    Hj, Tj, Hte, Tte = (jnp.asarray(x) for x in (H_tr, T_tr, H_te, T_te))

    def mse(pred):
        return float(jnp.mean((pred - Tte) ** 2))

    betas = jax.vmap(lambda h, t: jelm.elm_fit(h, t, mu))(Hj, Tj)
    stats = je.sufficient_stats(Hj, Tj)
    stm, _ = jm.mtl_elm_fit_from_stats(
        stats, jm.MTLELMConfig(r=r, mu1=mu, mu2=mu, iters=150))
    cfg = je.ConsensusConfig(r=r, mu1=mu, mu2=mu, tau=1.0, zeta=1.0,
                             iters=2000)

    def from_tilted_start(c, executor="dense"):
        # the port quickstart's start (quickstart.tilted_start), built here
        # for the reference's runner
        runner = je.make_runner(stats, jg.ring(8), c, executor=executor)
        s0 = runner.init_state()
        L = s0.U.shape[-2]
        ramp = (np.linspace(-1.0, 1.0, L, dtype=np.float32)[:, None]
                * np.arange(r, dtype=np.float32))
        return runner.run(s0._replace(U=s0.U + quickstart.TILT * ramp))[0]

    std = from_tilted_start(cfg)
    stf = from_tilted_start(dataclasses.replace(cfg, first_order=True))
    stg = from_tilted_start(dataclasses.replace(cfg, gamma_floor=0.05),
                            executor="colored")
    ref = {
        "local": mse(jnp.einsum("mnl,mld->mnd", Hte, betas)),
        "mtl": mse(jnp.einsum("mnl,lr,mrd->mnd", Hte, stm.U, stm.A)),
        "dmtl": mse(jnp.einsum("mnl,mlr,mrd->mnd", Hte, std.U, std.A)),
        "fo": mse(jnp.einsum("mnl,mlr,mrd->mnd", Hte, stf.U, stf.A)),
        "gs": mse(jnp.einsum("mnl,mlr,mrd->mnd", Hte, stg.U, stg.A)),
    }
    ours = quickstart.run(*(_t(x) for x in (H_tr, T_tr, H_te, T_te)), r=r,
                          mu=mu)
    return ref, ours


def test_quickstart_flow_matches_reference(quickstart_both):
    """Local, MTL, DMTL, FO and Gauss-Seidel test MSEs within 1e-3
    relative of the reference's (the consensus fits from the same tilted
    start); MTL and DMTL beat local training.  On this data the
    Gauss-Seidel fit from the tilted start ends just above Local ELM in
    both packages (0.0451 against 0.0444), so its own check is the port
    quickstart's, on the port's data (test_quickstart_main_runs_on_cpu)."""
    ref, ours = quickstart_both
    for k in ("local", "mtl", "dmtl", "fo", "gs"):
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-3, err_msg=k)
    assert ours["mtl"] < ours["local"] and ours["dmtl"] < ours["local"]


def test_symmetric_start_leaves_rank_one_only_through_roundoff():
    """Why the quickstart tilts its start: from the engine's all-ones start
    the r columns of every U_t are equal, and the update keeps them equal
    in exact arithmetic.  In fp64 they stay equal to ~1e-8 after 50
    iterations; in fp32 roundoff has already split them."""
    H_tr, T_tr, _, _ = (_t(x) for x in jsyn.multitask_regression(
        jax.random.PRNGKey(0), m=8, n_train=16, n_test=4, L=64, r=2,
        noise=0.1))
    stats = te.sufficient_stats(H_tr, T_tr)
    cfg = te.ConsensusConfig(r=2, mu1=0.1, mu2=0.1, tau=1.0, zeta=1.0,
                             iters=50)
    gaps = {}
    for dtype in (torch.float64, torch.float32):
        st = te.SufficientStats(*(x.to(dtype) for x in stats))
        U = te.fit_dense(st, tg.ring(8), cfg)[0].U
        gaps[dtype] = float((U[..., 0] - U[..., 1]).abs().max())
    assert gaps[torch.float64] < 1e-6 < 1e-2 < gaps[torch.float32]
    U0 = quickstart.tilted_start(
        te.make_runner(stats, tg.ring(8), cfg).init_state()).U
    assert torch.equal(U0[..., 0], torch.ones_like(U0[..., 0]))
    assert float((U0[..., 0] - U0[..., 1]).abs().max()) == \
        pytest.approx(quickstart.TILT)


def test_quickstart_main_runs_on_cpu(capsys):
    """The port's quickstart on its own data; ``main`` asserts that MTL,
    DMTL and Gauss-Seidel all beat Local ELM."""
    res = quickstart.main(device="cpu")
    assert "beats local training" in capsys.readouterr().out
    assert np.isfinite([res[k] for k in ("local", "mtl", "dmtl", "fo",
                                         "gs")]).all()


def test_convert_round_trips():
    rng = np.random.default_rng(3)
    W, b = rng.standard_normal((4, 7)), rng.standard_normal(7)
    fm = convert.feature_map_from_numpy(W, b, "tanh", device="cpu")
    np.testing.assert_array_equal(fm.W.numpy(), W.astype(np.float32))
    np.testing.assert_array_equal(fm.b.numpy(), b.astype(np.float32))
    assert fm.activation == "tanh" and fm.W.dtype == torch.float32
    G, R = rng.standard_normal((2, 3, 3)), rng.standard_normal((2, 3, 1))
    n, t2 = np.array([5.0, 6.0]), np.array([1.5, 2.5])
    st = convert.stats_from_numpy(G, R, n, t2, device="cpu")
    for a, b_ in zip(st, (G, R, n, t2)):
        np.testing.assert_array_equal(a.numpy(), np.float32(b_))
    U, A, lam = (rng.standard_normal(s) for s in ((2, 3, 2), (2, 2, 1),
                                                  (1, 3, 2)))
    ds = convert.state_from_numpy(U, A, lam, device="cpu")
    for a, b_ in zip(ds, (U, A, lam)):
        np.testing.assert_array_equal(a.numpy(), np.float32(b_))


def test_synthetic_generators_shapes_and_seeds():
    a = tsyn.multitask_classification(0, m=4, n_train=30, n_test=10,
                                      n_in=16, device="cpu")
    b = tsyn.multitask_classification(0, m=4, n_train=30, n_test=10,
                                      n_in=16, device="cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a.X_train.shape == (4, 30, 16) and a.Y_test.shape == (4, 10, 3)
    assert torch.all(a.Y_train.sum(-1) == 1)
    assert all(len(set(row.tolist())) == 3 for row in a.task_classes)
    H, T = tsyn.paper_uniform(1, m=3, N=5, L=4, d=2, device="cpu")
    np.testing.assert_allclose(
        torch.linalg.norm(H.reshape(15, 4), dim=0).numpy(), 1.0, rtol=1e-6)
    assert T.shape == (3, 5, 2)
    Htr, Ttr, Hte, Tte = tsyn.multitask_regression(2, m=3, L=10, r=2,
                                                   device="cpu")
    assert Htr.shape == (3, 16, 10) and Tte.shape == (3, 200, 1)
    logits = np.random.default_rng(0).standard_normal((3, 20, 3))
    onehot = np.eye(3)[np.random.default_rng(1).integers(0, 3, (3, 20))]
    _close(tsyn.classification_error(_t(logits), _t(onehot)),
           jsyn.classification_error(jnp.asarray(logits), jnp.asarray(onehot)),
           rtol=1e-6)
