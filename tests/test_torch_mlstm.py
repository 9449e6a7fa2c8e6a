"""Port parity: the chunkwise mLSTM op (``kernels/mlstm``).

The same numpy inputs go through the reference's ``mlstm_chunkwise`` (its
Pallas kernel in interpret mode, as ``tests/test_kernels_mlstm.py`` runs it)
and ``mlstm_sequential_ref``, and through the port's ``mlstm_chunkwise`` on
CPU tensors (the kernel's plain version, the chunk algebra in PyTorch) and
its ``mlstm_sequential_ref``: within 2e-4, the reference's tolerance, over
the reference's four shapes (ragged S included), a long-memory gate where
the carried state matters most, and a strongly negative input gate where
the e^{-m} floor of the denominator is active.  The CUDA kernel itself is
held against the plain version on the card.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.mlstm.ops import mlstm_chunkwise as j_chunkwise  # noqa: E402
from repro.kernels.mlstm.ref import mlstm_sequential_ref as j_seq  # noqa: E402
from repro_torch.kernels.mlstm import kernel, ops  # noqa: E402
from repro_torch.kernels.mlstm.ref import (  # noqa: E402
    bf16_terms,
    mlstm_chunkwise_ref,
    mlstm_sequential_ref,
)

TOL = dict(rtol=2e-4, atol=2e-4)


def _inputs(seed, B, H, S, D, log_f=None, i_shift=0.0, i_scale=1.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, S, D)).astype(np.float32)
               for _ in range(3))
    if log_f is None:
        x = rng.standard_normal((B, H, S)) + 2.0
        f = -np.log1p(np.exp(-x)).astype(np.float32)          # log-sigmoid
    else:
        f = np.full((B, H, S), log_f, np.float32)
    i = (i_scale * rng.standard_normal((B, H, S)) + i_shift).astype(np.float32)
    return q, k, v, f, i


def _both(arrays, chunk):
    got = ops.mlstm_chunkwise(*(torch.tensor(a) for a in arrays), chunk=chunk)
    want = np.asarray(j_chunkwise(*(jnp.asarray(a) for a in arrays),
                                  chunk=chunk))
    return got.numpy(), want


@pytest.mark.parametrize("S,D,chunk", [(64, 16, 16), (96, 32, 32),
                                       (77, 16, 32), (40, 64, 8)])
def test_mlstm_matches_reference_kernel_and_oracle(S, D, chunk):
    arrays = _inputs(S * D, 2, 2, S, D)
    before = kernel.LAUNCHES["mlstm"]
    got, want = _both(arrays, chunk)
    assert kernel.LAUNCHES["mlstm"] == before     # CPU: the plain version
    assert got.shape == (2, 2, S, D) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)
    oracle = np.asarray(j_seq(*(jnp.asarray(a) for a in arrays)))
    np.testing.assert_allclose(got, oracle, **TOL)
    port_oracle = mlstm_sequential_ref(*(torch.tensor(a) for a in arrays))
    np.testing.assert_allclose(port_oracle.numpy(), oracle, **TOL)


def test_mlstm_state_carry_is_chunk_independent():
    """Long memory (log_f = -0.01): chunk 8 against chunk S, and both
    against the reference."""
    arrays = _inputs(7, 1, 2, 64, 16, log_f=-0.01)
    small, want = _both(arrays, 8)
    whole = ops.mlstm_chunkwise(*(torch.tensor(a) for a in arrays),
                                chunk=64).numpy()
    np.testing.assert_allclose(small, whole, **TOL)
    np.testing.assert_allclose(small, want, **TOL)


@pytest.mark.parametrize("i_shift", [-80.0, -100.0])
def test_mlstm_strongly_negative_input_gate(i_shift):
    """i ~ -80: m ~ -80, the floor e^{-m} (~1e35) outweighs |n . q| and h is
    ~1e-34, held relative to its own size; i ~ -100: e^{-m} overflows to
    +inf and h is exactly 0 in both packages, with no NaN."""
    arrays = _inputs(3, 1, 2, 48, 16, i_shift=i_shift, i_scale=0.5)
    got, want = _both(arrays, 16)
    assert np.isfinite(got).all()
    if i_shift == -100.0:
        assert not got.any() and not want.any()
        return
    assert 0 < np.abs(want).max() < 1e-30
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= 2e-4


def test_mlstm_casts_widens_and_force_ref():
    q, k, v, f, i = (torch.tensor(a) for a in _inputs(2, 1, 2, 20, 16))
    got = ops.mlstm_chunkwise(q.bfloat16(), k.bfloat16(), v.bfloat16(), f, i,
                              chunk=8)
    assert got.dtype == torch.float32
    torch.testing.assert_close(
        got, mlstm_chunkwise_ref(q.bfloat16().float(), k.bfloat16().float(),
                                 v.bfloat16().float(), f, i, 8),
        rtol=0, atol=0)
    torch.testing.assert_close(
        ops.mlstm_chunkwise(q, k, v, f, i, chunk=8, force_ref=True),
        mlstm_chunkwise_ref(q, k, v, f, i, 8), rtol=0, atol=0)
    # a chunk above S is one chunk of S steps
    torch.testing.assert_close(ops.mlstm_chunkwise(q, k, v, f, i, chunk=256),
                               mlstm_chunkwise_ref(q, k, v, f, i, 20),
                               rtol=0, atol=0)


def test_mlstm_is_forward_only_and_checks_devices():
    q, k, v, f, i = (torch.tensor(a) for a in _inputs(4, 1, 1, 4, 16))
    with pytest.raises(RuntimeError, match="forward-only"):
        ops.mlstm_chunkwise(q, k, v.requires_grad_(), f, i)
    with pytest.raises(RuntimeError, match="forward-only"):
        kernel.mlstm(q, k, v, f, i, 4)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        kernel.mlstm(q.to("meta"), k, v.detach(), f, i, 4)
    with pytest.raises(ValueError, match="chunk"):
        kernel.mlstm(q, k, v.detach(), f, i, 0)


# chip_smoke.MLSTM_NORM_TOL: the card's gate of the kernel against its plain
# version, in norm, in every dtype
MLSTM_NORM_TOL = 1e-5


def _norm_rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


@pytest.mark.parametrize("log_f", [None, -0.01], ids=["std", "long_memory"])
def test_mlstm_operand_split_two_terms_hold_one_does_not(log_f):
    """The CUDA kernel's bf16 body multiplies C and w v as sums of bf16
    terms.  Its plain model on bf16 q, k, v at (1, 2, 512, 256): two terms
    stay within half the card's norm gate of the fp32 algebra (6.8e-7 and
    1.8e-6 measured here), one term fails the gate by more than 20x (4.5e-4
    and 1.2e-3), so the gate tells a lost low term."""
    q, k, v, f, i = (torch.tensor(a) for a in
                     _inputs(11, 1, 2, 512, 256, log_f=log_f))
    q, k, v = q.bfloat16(), k.bfloat16(), v.bfloat16()
    want = mlstm_chunkwise_ref(q, k, v, f, i, 128)
    two = mlstm_chunkwise_ref(q, k, v, f, i, 128, operand_terms=2)
    one = mlstm_chunkwise_ref(q, k, v, f, i, 128, operand_terms=1)
    assert _norm_rel(two, want) <= MLSTM_NORM_TOL / 2
    assert _norm_rel(one, want) >= 20 * MLSTM_NORM_TOL


@pytest.mark.parametrize("S,D,chunk", [(96, 32, 32), (77, 16, 32)])
def test_mlstm_operand_split_model_matches_reference(S, D, chunk):
    """``operand_terms=None`` is the plain version bit for bit; the
    two-term model computes the reference's function within its 2e-4."""
    arrays = _inputs(S + D, 2, 2, S, D)
    q, k, v, f, i = (torch.tensor(a) for a in arrays)
    plain = mlstm_chunkwise_ref(q, k, v, f, i, chunk)
    assert torch.equal(
        mlstm_chunkwise_ref(q, k, v, f, i, chunk, operand_terms=None), plain)
    two = mlstm_chunkwise_ref(q, k, v, f, i, chunk, operand_terms=2)
    want = np.asarray(j_chunkwise(*(jnp.asarray(a) for a in arrays),
                                  chunk=chunk))
    np.testing.assert_allclose(two.numpy(), want, **TOL)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_bf16_terms_keep_8_bits_a_term(n):
    """Each bf16 term (8 significant bits, round to nearest) leaves at most
    2^-8 of what it splits, so n terms hold x to 2^-8n of |x|; one term is
    x rounded to bf16."""
    rng = np.random.default_rng(n)
    x = torch.tensor(rng.standard_normal(4096)
                     * 10.0 ** rng.uniform(-6, 6, 4096), dtype=torch.float32)
    got = bf16_terms(x, n)
    assert bool(((got - x).abs() <= 2.0 ** (-8 * n) * x.abs()).all())
    if n == 1:
        assert torch.equal(got, x.bfloat16().float())
