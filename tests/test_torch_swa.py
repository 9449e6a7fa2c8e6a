"""Port parity: the sliding-window attention op (``kernels/swa``).

The same numpy inputs go through the reference's ``swa_attention`` (its
Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs it) and
``swa_ref``, and through the port's ``swa_attention`` on CPU tensors (the
kernel's plain version, ``ref.swa_ref``).  fp32 agrees within 1e-5; bf16
within the bf16 tolerance 3e-2.  The CUDA kernel itself is held against
the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.swa.ops import swa_attention as j_swa_attention  # noqa: E402
from repro.kernels.swa.ref import swa_ref as j_swa_ref  # noqa: E402
from repro_torch.kernels.swa import kernel, ops  # noqa: E402
from repro_torch.kernels.swa.ref import swa_ref  # noqa: E402


def _qkv(seed, B, H, KV, S, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D)).astype(np.float32),
            rng.standard_normal((B, KV, S, D)).astype(np.float32),
            rng.standard_normal((B, KV, S, D)).astype(np.float32))


# S not a multiple of the block, W < block, W > S, GQA groups 1/2/4,
# head dims 64 and 120
CASES = [
    (2, 4, 4, 100, 64, 16),     # G = 1, ragged S, W below the block
    (1, 4, 2, 70, 120, 200),    # G = 2, D = 120, W > S
    (2, 8, 2, 96, 64, 33),      # G = 4
    (1, 4, 1, 45, 120, 7),      # MQA, D = 120, ragged S
]


@pytest.mark.parametrize("B,H,KV,S,D,W", CASES)
def test_swa_attention_matches_reference_fp32(B, H, KV, S, D, W):
    q, k, v = _qkv(S * D + W, B, H, KV, S, D)
    want_kernel = np.asarray(j_swa_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), window=W,
        block_q=32, block_k=32))
    want_ref = np.asarray(j_swa_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), W))
    before = kernel.LAUNCHES["swa"]
    got = ops.swa_attention(torch.tensor(q), torch.tensor(k),
                            torch.tensor(v), window=W)
    assert kernel.LAUNCHES["swa"] == before      # CPU: the plain version
    assert got.shape == (B, H, S, D) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want_kernel, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("B,H,KV,S,D,W", [CASES[0], CASES[1]])
def test_swa_attention_matches_reference_bf16(B, H, KV, S, D, W):
    q, k, v = _qkv(7 + S, B, H, KV, S, D)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(j_swa_ref(jq, jk, jv, W).astype(jnp.float32))
    tq, tk, tv = (torch.tensor(x).bfloat16() for x in (q, k, v))
    got = ops.swa_attention(tq, tk, tv, window=W)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=3e-2, atol=3e-2)


def test_swa_window_one_is_identity_and_full_window_is_causal():
    """W = 1: each query sees only itself, so o = v (per kv head).  W >= S:
    plain causal attention."""
    q, k, v = (torch.tensor(x) for x in _qkv(3, 1, 2, 1, 20, 16))
    out = ops.swa_attention(q, k, v, window=1)
    torch.testing.assert_close(out, v.expand(1, 2, 20, 16), rtol=0, atol=1e-6)
    full = ops.swa_attention(q, k, v, window=20)
    s = torch.einsum("bhid,bjd->bhij", q, k[:, 0]) * 16 ** -0.5
    s = s.masked_fill(torch.ones(20, 20, dtype=torch.bool).triu(1), -torch.inf)
    want = torch.einsum("bhij,bjd->bhid", s.softmax(-1), v[:, 0])
    torch.testing.assert_close(full, want, rtol=1e-5, atol=1e-5)


def test_swa_padding_matches_unpadded():
    """The op pads nothing: a ragged S gives the first S rows of the same
    inputs run at a longer S (later keys lie after every earlier query,
    so causality masks them), and ``force_ref`` is the plain version."""
    q, k, v = (torch.tensor(x) for x in _qkv(5, 1, 2, 2, 64, 8))
    got = ops.swa_attention(q[:, :, :50], k[:, :, :50], v[:, :, :50],
                            window=9)
    longer = ops.swa_attention(q, k, v, window=9)
    assert got.shape == (1, 2, 50, 8)
    torch.testing.assert_close(got, longer[:, :, :50], rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(
        ops.swa_attention(q, k, v, window=9, force_ref=True),
        swa_ref(q, k, v, 9), rtol=0, atol=0)


def test_swa_is_forward_only_and_checks_devices():
    q, k, v = (torch.tensor(x) for x in _qkv(1, 1, 2, 1, 8, 4))
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.swa_attention(q.requires_grad_(), k, v, window=4)
    with pytest.raises(RuntimeError, match="forward-only"):
        kernel.swa(q, k, v, 4)
    with torch.no_grad():
        kernel.swa(q, k, v, 4)        # no graph is built, nothing is lost
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        kernel.swa(q.detach().to("meta"), k, v, 4)
    with pytest.raises(ValueError, match="window"):
        kernel.swa(q.detach(), k, v, 0)
