"""Port parity: the RG-LRU scan op (``kernels/rglru``).

The same numpy inputs go through the reference's ``rglru_scan`` (its
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it) and
``rglru_scan_ref``, and through the port's ``rglru_scan`` on CPU tensors
(the kernel's plain version, a loop over time): within 1e-5, with h0 != 0
and S, D that are not block multiples.  The CUDA kernel itself is held
against the plain version on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test process: xdist's workers share the cores

import jax.numpy as jnp  # noqa: E402

from repro.kernels.rglru.ops import rglru_scan as j_rglru_scan  # noqa: E402
from repro.kernels.rglru.ref import rglru_scan_ref as j_rglru_ref  # noqa: E402
from repro_torch.kernels.rglru import kernel, ops  # noqa: E402
from repro_torch.kernels.rglru.ref import rglru_scan_ref  # noqa: E402


def _inputs(seed, B, S, D):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    log_a = -np.log1p(np.exp(x)).astype(np.float32)          # -softplus
    b = rng.standard_normal((B, S, D)).astype(np.float32)
    h0 = rng.standard_normal((B, D)).astype(np.float32)
    return log_a, b, h0


@pytest.mark.parametrize("B,S,D,bs,bd", [(2, 64, 32, 16, 16),
                                         (2, 100, 48, 32, 32),
                                         (3, 17, 130, 8, 64),
                                         (1, 1, 5, 8, 8)])
def test_rglru_scan_matches_reference(B, S, D, bs, bd):
    log_a, b, h0 = _inputs(S * D, B, S, D)
    ja, jb, jh = (jnp.asarray(x) for x in (log_a, b, h0))
    want_kernel = np.asarray(j_rglru_scan(ja, jb, jh, block_s=bs, block_d=bd))
    want_ref = np.asarray(j_rglru_ref(ja, jb, jh))
    before = kernel.LAUNCHES["rglru"]
    got = ops.rglru_scan(torch.tensor(log_a), torch.tensor(b),
                         torch.tensor(h0))
    assert kernel.LAUNCHES["rglru"] == before    # CPU: the plain version
    assert got.shape == (B, S, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_kernel, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=1e-5, atol=1e-5)


def test_rglru_identity_decay_is_a_cumulative_sum():
    _, b, h0 = _inputs(1, 1, 20, 8)
    out = ops.rglru_scan(torch.zeros(1, 20, 8), torch.tensor(b),
                         torch.tensor(h0))
    want = np.cumsum(b, axis=1) + h0[:, None]
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)


def test_rglru_casts_to_fp32_and_force_ref():
    log_a, b, h0 = (torch.tensor(x) for x in _inputs(2, 2, 9, 3))
    got = ops.rglru_scan(log_a.bfloat16(), b.bfloat16(), h0)
    assert got.dtype == torch.float32
    torch.testing.assert_close(
        got, rglru_scan_ref(log_a.bfloat16().float(), b.bfloat16().float(),
                            h0), rtol=0, atol=0)
    torch.testing.assert_close(ops.rglru_scan(log_a, b, h0, force_ref=True),
                               rglru_scan_ref(log_a, b, h0), rtol=0, atol=0)


def test_rglru_is_forward_only_and_checks_devices():
    log_a, b, h0 = (torch.tensor(x) for x in _inputs(3, 1, 4, 2))
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.rglru_scan(log_a, b.requires_grad_(), h0)
    with pytest.raises(RuntimeError, match="forward-only"):
        kernel.rglru(log_a, b, h0)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        kernel.rglru(log_a.to("meta"), b.detach(), h0)
