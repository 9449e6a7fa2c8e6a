"""The CUDA Gram kernels against their plain versions, on the card.

Marked ``cuda``: each test skips where CUDA is absent.  Run them on the
card with ``python -m pytest -q -m cuda tests/test_torch_cuda.py`` (this
file imports no JAX).  Tolerances: max |kernel - plain| / max |plain| below
1e-4 in fp32 (only the summation order differs) and 3e-2 in bf16.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.gram import kernel, ref  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = {"fp32": 1e-4, "bf16": 3e-2}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("m,N,L,D", [(1, 1, 1, 1), (2, 33, 40, 3),
                                     (3, 1000, 300, 3), (1, 5, 129, 20)])
def test_gram_tri_matches_plain(gen, m, N, L, D, precision):
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    H = torch.randn(m, N, L, device="cuda", generator=gen).to(dtype)
    T = torch.randn(m, N, D, device="cuda", generator=gen).to(dtype)
    before = kernel.LAUNCHES["gram_tri"]
    G, R = kernel.gram_tri(H, T)
    torch.cuda.synchronize()
    Gr, Rr = ref.gram_ref(H, T)
    assert kernel.LAUNCHES["gram_tri"] == before + 1
    assert torch.equal(G, G.mT)
    assert _rel(G, Gr) <= TOL[precision] and _rel(R, Rr) <= TOL[precision]


@pytest.mark.parametrize("activation", ["sigmoid", "tanh", "relu", "gelu"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("m,N,d_in,L,D", [(2, 33, 8, 40, 3),
                                          (3, 1000, 70, 300, 3),
                                          (1, 7, 1, 129, 17)])
def test_gram_fused_matches_plain(gen, m, N, d_in, L, D, activation,
                                  precision):
    X = torch.randn(m, N, d_in, device="cuda", generator=gen)
    W = torch.randn(d_in, L, device="cuda", generator=gen) / d_in**0.5
    b = torch.randn(L, device="cuda", generator=gen)
    T = torch.randn(m, N, D, device="cuda", generator=gen)
    if precision == "bf16":
        T = T.bfloat16()
    G, R = kernel.gram_fused(X, W, b, T, activation, precision)
    torch.cuda.synchronize()
    Gr, Rr = ref.gram_fused_ref(X, W, b, T, activation, precision)
    assert torch.equal(G, G.mT)
    assert _rel(G, Gr) <= TOL[precision] and _rel(R, Rr) <= TOL[precision]


def test_cuda_wrappers_reject_what_the_kernel_does_not_take(gen):
    H = torch.randn(2, 8, 16, device="cuda", generator=gen)
    with pytest.raises(ValueError, match="dtype"):
        kernel.gram_tri(H.double(), H.double())
    with pytest.raises(ValueError, match="contiguous"):
        kernel.gram_tri(H.mT, H.mT)
    with pytest.raises(ValueError, match="dtype"):
        kernel.gram_tri(H, H.bfloat16())
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        kernel.gram_tri(H, H.cpu())
