"""Port parity: the paper's comparison methods (``repro_torch.baselines``)
and its §IV setups (``repro_torch.configs.paper``), against the JAX
reference on the same numpy inputs, at the shapes of ``usps_like()`` and
``mnist_like()`` (the reference's own synthetic stand-ins).

fp64, the reference scoped by ``jax.enable_x64(True)``: predictions within
1e-7 of max |reference| (the widest reading, MTFL's, is 7.5e-9).

fp32: each package's fp32 result departs from the fp64 one by the
function's own roundoff on these inputs (MTFL ~5e-4, GO-MTL ~5e-3, DGSP
~1e-4, DNSP up to 4e-2: its Newton step solves XᵀX + lam I with 12
samples in 64 or 87 dimensions).  So the port's fp32 predictions are held
against the reference's fp32 ones within 4x the reference's own fp32
distance from the fp64 result (the port's fp64 run on the same inputs,
itself within 1e-7 of the reference's): at Table I's settings at most
2.9x was read over 3 seeds of both setups.

GO-MTL runs a cut-down fit (k 4, its default, 10 alternations of 10 ISTA
steps; Table I's is k 10, 40 x 25): its 640-wide L-step solves cost the
reference minutes under the suite's parallel workers.

DGSP/DNSP build U from ``eigh`` eigenvectors, fixed only up to their sign
(``src/repro/baselines/subspace_pursuit.py:46-47``), so they are compared
through predictions and U Uᵀ, not U.
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import baselines as jb  # noqa: E402
from repro.configs import paper as jpaper  # noqa: E402
from repro.data.synthetic import multitask_classification  # noqa: E402
from repro_torch import baselines as tb  # noqa: E402
from repro_torch.configs import paper as tpaper  # noqa: E402

SETUPS = ("usps_like", "mnist_like")
FP64_TOL = 1e-7
FP32_ROUNDOFF_FACTOR = 4.0
GOMTL = dict(lam_s=0.05, iters=10, ista_steps=10)
GOMTL_K = 4


# The reference's functions, compiled whole: its pursuits run eagerly op by
# op otherwise, each round at a new shape (seconds per call on the CPU).
_J = {
    "mtfl_fit": jax.jit(jb.mtfl_fit, static_argnames=("iters",)),
    "gomtl_fit": jax.jit(jb.gomtl_fit, static_argnames=("k", "iters",
                                                         "ista_steps")),
    "dgsp_fit": jax.jit(jb.dgsp_fit, static_argnames=("r",)),
    "dnsp_fit": jax.jit(jb.dnsp_fit, static_argnames=("r",)),
}


@functools.lru_cache(maxsize=None)
def _data(setup_name):
    setup = getattr(jpaper, setup_name)()
    data = multitask_classification(
        jax.random.PRNGKey(0), m=setup.m, n_train=setup.n_train,
        n_test=setup.n_test, n_in=setup.n_in, n_cls=setup.n_cls,
        class_sep=setup.class_sep, noise=setup.noise,
        latent_r=setup.latent_r)
    return setup, tuple(np.asarray(a, np.float64)
                        for a in (data.X_train, data.Y_train, data.X_test))


def _ref(method, setup, X, Y, Xt):
    """The reference's predictions (and U Uᵀ for the pursuits); GO-MTL
    also returns the start it drew, in the dtype of the inputs."""
    if method == "mtfl":
        return {"pred": jb.mtfl_predict(_J["mtfl_fit"](X, Y, gamma=10.0), Xt)}
    if method == "gomtl":
        L0 = jax.random.normal(jax.random.PRNGKey(0),
                               (X.shape[-1], GOMTL_K)) / jnp.sqrt(X.shape[-1])
        Lm, S = _J["gomtl_fit"](X, Y, k=GOMTL_K, **GOMTL)
        return {"pred": jb.gomtl_predict(Lm, S, Xt), "L0": L0}
    U, A = _J[f"{method}_fit"](X, Y, r=setup.r, lam=setup.mu)
    return {"pred": jb.sp_predict(U, A, Xt), "UUt": U @ U.T}


def _port(method, setup, X, Y, Xt, L0=None):
    if method == "mtfl":
        return {"pred": tb.mtfl_predict(tb.mtfl_fit(X, Y, gamma=10.0), Xt)}
    if method == "gomtl":
        Lm, S = tb.gomtl_fit(X, Y, L0, **GOMTL)
        return {"pred": tb.gomtl_predict(Lm, S, Xt)}
    fit = tb.dgsp_fit if method == "dgsp" else tb.dnsp_fit
    U, A = fit(X, Y, r=setup.r, lam=setup.mu)
    return {"pred": tb.sp_predict(U, A, Xt), "UUt": U @ U.T}


def _rel(got, want):
    got = got.double().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


METHODS = ("mtfl", "gomtl", "dgsp", "dnsp")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The fits are a thousand tiny products: torch's thread pool only adds
    wake-ups, which cost ~100x more when the suite's parallel workers run
    more threads than there are cores (GO-MTL: 0.5 s on one thread, 50 s on
    eight beside five such processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("setup_name", SETUPS)
def test_baseline_matches_reference_in_fp64(setup_name, method):
    setup, arrays = _data(setup_name)
    with jax.enable_x64(True):
        want = _ref(method, setup, *(jnp.asarray(a) for a in arrays))
        want = {k: np.asarray(v) for k, v in want.items()}
    assert want["pred"].dtype == np.float64
    L0 = torch.tensor(want.pop("L0")) if "L0" in want else None
    got = _port(method, setup, *(torch.tensor(a) for a in arrays), L0=L0)
    assert got["pred"].dtype == torch.float64
    for key in want:
        assert _rel(got[key], want[key]) <= FP64_TOL, key


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("setup_name", SETUPS)
def test_baseline_matches_reference_in_fp32(setup_name, method):
    setup, arrays = _data(setup_name)
    arrays32 = [a.astype(np.float32) for a in arrays]
    want = {k: np.asarray(v)
            for k, v in _ref(method, setup,
                             *(jnp.asarray(a) for a in arrays32)).items()}
    assert want["pred"].dtype == np.float32
    L0 = torch.tensor(want.pop("L0")) if "L0" in want else None
    got = _port(method, setup, *(torch.tensor(a) for a in arrays32), L0=L0)
    exact = _port(method, setup,
                  *(torch.tensor(a.astype(np.float64)) for a in arrays32),
                  L0=None if L0 is None else L0.double())
    for key in want:
        roundoff = _rel(want[key], exact[key].numpy())
        assert _rel(got[key], want[key]) <= FP32_ROUNDOFF_FACTOR * max(
            roundoff, 1e-6), key


def test_gomtl_takes_its_start_and_mtfl_refuses_no_iteration():
    setup, (X, Y, _) = _data("usps_like")
    X, Y = torch.tensor(X[:2, :, :8]), torch.tensor(Y[:2])
    L0 = torch.randn(8, 3, dtype=torch.float64)
    Lm, S = tb.gomtl_fit(X, Y, L0, iters=0)
    assert torch.equal(Lm, L0) and S.shape == (2, 3, Y.shape[-1])
    Lm, S = tb.gomtl_fit(X, Y, L0, iters=2)
    assert Lm.shape == (8, 3) and not torch.equal(Lm, L0)
    with pytest.raises(ValueError, match="iters"):
        tb.mtfl_fit(X, Y, iters=0)


# --------------------------------------------------------------------------
# configs/paper.py
# --------------------------------------------------------------------------


@pytest.mark.parametrize("cls", ["PaperConvergenceSetup",
                                 "PaperGeneralizationSetup"])
def test_paper_setups_equal_the_references_field_for_field(cls):
    t, j = getattr(tpaper, cls), getattr(jpaper, cls)
    assert ([(f.name, f.type, f.default) for f in dataclasses.fields(t)]
            == [(f.name, f.type, f.default) for f in dataclasses.fields(j)])
    assert dataclasses.asdict(t()) == dataclasses.asdict(j())


@pytest.mark.parametrize("setup_name", SETUPS)
def test_paper_configs_equal_the_references(setup_name):
    ts, js = getattr(tpaper, setup_name)(), getattr(jpaper, setup_name)()
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)
    assert dataclasses.asdict(tpaper.mtl_cfg(ts)) == dataclasses.asdict(
        jpaper.mtl_cfg(js))
    for fo in (False, True):
        t, j = (dataclasses.asdict(tpaper.dmtl_cfg(ts, first_order=fo)),
                dataclasses.asdict(jpaper.dmtl_cfg(js, first_order=fo)))
        # every field the port's config has equals the reference's; the
        # reference's other fields (the executors the port has yet to
        # bring) are at their defaults
        assert {k: j[k] for k in t} == t
        jdefault = dataclasses.asdict(type(jpaper.dmtl_cfg(js))(r=1))
        assert {k: v for k, v in j.items() if k not in t} == {
            k: v for k, v in jdefault.items() if k not in t}
