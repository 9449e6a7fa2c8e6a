"""Port parity: the Gram ops of ``repro_torch`` against the JAX reference.

The reference runs as its own tests run it on the CPU: ``gram_batched`` /
``gram_fused`` through the Pallas kernels in interpret mode, and their
``force_ref`` oracles.  The port's ops on CPU tensors take the plain
versions of the CUDA kernels.  Inputs are numpy draws from a seed.

Tolerances: fp32 Gram 2e-4 (``TOL`` of tests/test_kernels.py), fused fp32
1e-5 (as test_gram_fused_2d_matches_oracle), bf16 3e-2.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.gram import ops as jops  # noqa: E402
from repro.kernels.gram import ref as jref  # noqa: E402
from repro_torch.core import elm as telm  # noqa: E402
from repro_torch.kernels.gram import kernel as tkernel  # noqa: E402
from repro_torch.kernels.gram import ops as tops  # noqa: E402
from repro_torch.kernels.gram import ref as tref  # noqa: E402

TOL = {"fp32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=3e-2, atol=3e-2)}
FUSED_TOL = {"fp32": dict(rtol=1e-5, atol=1e-5),
             "bf16": dict(rtol=3e-2, atol=3e-2)}
SHAPES = [(1, 5, 3, 1), (2, 33, 40, 3), (3, 64, 64, 2), (8, 17, 9, 1)]


def _draw(seed, *shapes, scale=1.0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal(s) * scale).astype(np.float32)
            for s in shapes]


def _np(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("m,N,L,D", SHAPES)
def test_gram_batched_matches_reference(m, N, L, D, precision):
    H, T = _draw(m * N + L, (m, N, L), (m, N, D))
    Gt, Rt = tops.gram_batched(torch.from_numpy(H), torch.from_numpy(T),
                               precision=precision)
    for force_ref in (False, True):
        Gj, Rj = jops.gram_batched(jnp.asarray(H), jnp.asarray(T),
                                   precision=precision, force_ref=force_ref)
        np.testing.assert_allclose(_np(Gt), np.asarray(Gj), **TOL[precision])
        np.testing.assert_allclose(_np(Rt), np.asarray(Rj), **TOL[precision])
    assert Gt.dtype == Rt.dtype == torch.float32


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("N,L,D", [(5, 3, 1), (40, 70, 3), (9, 129, 2)])
def test_gram_single_agent_matches_reference(N, L, D, precision):
    H, T = _draw(N + L, (N, L), (N, D))
    Gt, Rt = tops.gram(torch.from_numpy(H), torch.from_numpy(T),
                       precision=precision)
    Gj, Rj = jops.gram(jnp.asarray(H), jnp.asarray(T), precision=precision)
    np.testing.assert_allclose(_np(Gt), np.asarray(Gj), **TOL[precision])
    np.testing.assert_allclose(_np(Rt), np.asarray(Rj), **TOL[precision])


@pytest.mark.parametrize("activation", ["sigmoid", "tanh", "relu", "gelu"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("m,N,d_in,L,D", [(2, 33, 8, 40, 3), (1, 7, 11, 20, 1),
                                          (3, 64, 16, 64, 2)])
def test_gram_fused_matches_reference(m, N, d_in, L, D, activation, precision):
    X, W, b, T = _draw(m + N + d_in + L, (m, N, d_in), (d_in, L), (L,),
                       (m, N, D))
    X /= np.sqrt(d_in)
    Gt, Rt = tops.gram_fused(
        torch.from_numpy(X), torch.from_numpy(W), torch.from_numpy(b),
        torch.from_numpy(T), activation=activation, precision=precision)
    for force_ref in (False, True):
        Gj, Rj = jops.gram_fused(
            jnp.asarray(X), jnp.asarray(W), jnp.asarray(b), jnp.asarray(T),
            activation=activation, precision=precision, block_l=16,
            block_n=16, force_ref=force_ref)
        np.testing.assert_allclose(_np(Gt), np.asarray(Gj),
                                   **FUSED_TOL[precision])
        np.testing.assert_allclose(_np(Rt), np.asarray(Rj),
                                   **FUSED_TOL[precision])


def test_gram_fused_2d_and_force_ref():
    X, W, b, T = _draw(9, (40, 12), (12, 48), (48,), (40, 2))
    args = [torch.from_numpy(a) for a in (X, W, b, T)]
    G, R = tops.gram_fused(*args)
    Gr, Rr = tops.gram_fused(*args, force_ref=True)
    Go, Ro = jref.gram_fused_ref(*(jnp.asarray(a) for a in (X, W, b, T)))
    assert G.shape == (48, 48) and R.shape == (48, 2)
    for ours in ((G, R), (Gr, Rr)):
        np.testing.assert_allclose(_np(ours[0]), np.asarray(Go), **FUSED_TOL["fp32"])
        np.testing.assert_allclose(_np(ours[1]), np.asarray(Ro), **FUSED_TOL["fp32"])


@pytest.mark.parametrize("x", [np.linspace(-6, 6, 97, dtype=np.float32)])
@pytest.mark.parametrize("activation", ["sigmoid", "tanh", "relu", "gelu"])
def test_activations_match_reference(activation, x):
    """gelu is the tanh approximation on both sides."""
    from repro.core.elm import ACTIVATIONS as JACTS

    ours = tref.ACTIVATIONS[activation](torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(JACTS[activation](x)),
                               rtol=1e-6, atol=1e-6)
    assert tref.ACTIVATIONS.keys() == telm.ACTIVATIONS.keys()
    assert tref.ACTIVATIONS[activation] is telm.ACTIVATIONS[activation]


def test_int8_and_dense_variant_name_the_later_slice():
    H, T = (torch.ones(4, 8), torch.ones(4, 2))
    with pytest.raises(NotImplementedError, match="slice 2"):
        tops.gram(H, T, precision="int8")
    with pytest.raises(NotImplementedError, match="slice 2"):
        tops.gram_batched(H[None], T[None], precision="int8")
    with pytest.raises(NotImplementedError, match="slice 2"):
        tops.gram(H, T, variant="dense")
    with pytest.raises(ValueError, match="int8"):
        tops.gram_fused(H, torch.ones(8, 16), torch.ones(16), T,
                        precision="int8")
    with pytest.raises(ValueError, match="precision"):
        tops.gram(H, T, precision="fp16")


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    tkernel.reset_launches()
    H, T, X, W, b = _draw(3, (2, 20, 30), (2, 20, 2), (2, 20, 5), (5, 30),
                          (30,))
    H, T, X, W, b = map(torch.from_numpy, (H, T, X, W, b))
    G, R = tkernel.gram_tri(H, T)
    Gr, Rr = tref.gram_ref(H, T)
    assert torch.equal(G, Gr) and torch.equal(R, Rr)
    G, R = tkernel.gram_fused(X, W, b, T, "tanh")
    Gr, Rr = tref.gram_fused_ref(X, W, b, T, "tanh")
    assert torch.equal(G, Gr) and torch.equal(R, Rr)
    assert tkernel.LAUNCHES == {"gram_tri": 0, "gram_fused": 0}


def test_mixed_devices_raise():
    H = torch.ones(1, 4, 8)
    T = torch.ones(1, 4, 2, device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        tkernel.gram_tri(H, T)
