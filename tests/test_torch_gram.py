"""Port parity: the Gram ops of ``repro_torch`` against the JAX reference.

The reference runs as its own tests run it on the CPU: ``gram_batched`` /
``gram_fused`` through the Pallas kernels in interpret mode, and their
``force_ref`` oracles.  The port's ops on CPU tensors take the plain
versions of the CUDA kernels.  Inputs are numpy draws from a seed.

Tolerances: fp32 Gram 2e-4 (``TOL`` of tests/test_kernels.py), fused fp32
1e-5 (as test_gram_fused_2d_matches_oracle), bf16 3e-2.

int8: the reference draws its rounding uniforms from ``jax.random``, which
torch cannot replay, so the kernel's plain version is held against the
reference's kernel on the reference's own Hq/scales (atol 2e-5, as
test_gram_int8_pallas_matches_emulation), the rounding is held bitwise on
the reference's uniforms, and the port's own draws by the envelope (5e-2
of the fp32 Gram) and by unbiasedness over seeds.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread per test process: xdist's workers share the cores

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.gram import kernel as jkernel  # noqa: E402
from repro.kernels.gram import ops as jops  # noqa: E402
from repro.kernels.gram import ref as jref  # noqa: E402
from repro_torch import convert  # noqa: E402
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
    """Slice 2 brought both: int8 and the dense variant run (shapes here),
    int8 on the dense variant raises as in the reference, and the fused
    producer still refuses int8."""
    H, T = (torch.ones(4, 8), torch.ones(4, 2))
    assert tops.gram(H, T, precision="int8")[0].shape == (8, 8)
    assert tops.gram_batched(H[None], T[None], precision="int8")[1].shape \
        == (1, 8, 2)
    assert tops.gram(H, T, variant="dense")[0].shape == (8, 8)
    with pytest.raises(ValueError, match="tri"):
        tops.gram(H, T, precision="int8", variant="dense")
    with pytest.raises(ValueError, match="tri"):
        jops.gram(jnp.ones((4, 8)), jnp.ones((4, 2)), precision="int8",
                  variant="dense")
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
    G, R = tkernel.gram_dense(H[0], T[0])
    Gr, Rr = tref.gram_ref(H[0], T[0])
    assert torch.equal(G, Gr) and torch.equal(R, Rr)
    Hq, s = tref.quantize_tiles(H, 8, 16, torch.Generator().manual_seed(0))
    G, R = tkernel.gram_tri_q(Hq, s, T.bfloat16(), block_n=8, block_l=16)
    Gr, Rr = tref.gram_tri_q_ref(Hq, s, T, 8, 16)
    assert torch.equal(G, Gr) and torch.equal(R, Rr)
    assert tkernel.LAUNCHES == {"gram_tri": 0, "gram_fused": 0,
                                "gram_tri_q": 0, "gram_dense": 0}


def test_mixed_devices_raise():
    H = torch.ones(1, 4, 8)
    T = torch.ones(1, 4, 2, device="meta")
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        tkernel.gram_tri(H, T)


# ------------------------------------------------- gram_fused's chunk plan

PLAN_CASES = [(8, 8192, 2048, "fp32", None), (8, 8192, 2048, "bf16", None),
              (3, 1000, 300, "fp32", 1_000_000),
              (3, 1000, 300, "bf16", 600_000),
              (2, 7, 5, "bf16", 1), (1, 1, 1, "fp32", None)]


def _plan(monkeypatch, m, N, L, precision, budget):
    if budget is not None:
        monkeypatch.setattr(tkernel, "FUSED_WORKSPACE_BYTES", budget)
    return tkernel.fused_chunks(m, N, L, precision)


@pytest.mark.parametrize("m,N,L,precision,budget", PLAN_CASES)
def test_fused_chunks_cover_the_samples_in_order(monkeypatch, m, N, L,
                                                 precision, budget):
    chunks = _plan(monkeypatch, m, N, L, precision, budget)
    assert chunks[0][0] == 0 and all(rows >= 1 for _, rows in chunks)
    for (n0, rows), (n1, _) in zip(chunks, chunks[1:]):
        assert n1 == n0 + rows
    assert chunks[-1][0] + chunks[-1][1] == N
    # every chunk but the last has the first chunk's rows
    assert {rows for _, rows in chunks[:-1]} <= {chunks[0][1]}


@pytest.mark.parametrize("m,N,L,precision,budget", PLAN_CASES)
def test_fused_chunks_fit_the_budget(monkeypatch, m, N, L, precision,
                                     budget):
    chunks = _plan(monkeypatch, m, N, L, precision, budget)
    width = tkernel.fused_workspace_width(L, precision)
    row_bytes = m * width * (4 if precision == "fp32" else 2)
    assert width >= L and (precision == "fp32" or width % 8 == 0)
    for _, rows in chunks:
        # one row is the floor, whatever the budget
        assert rows * row_bytes <= tkernel.FUSED_WORKSPACE_BYTES or rows == 1
    if len(chunks) > 1:     # the most rows that fit
        assert (chunks[0][1] + 1) * row_bytes > tkernel.FUSED_WORKSPACE_BYTES


def test_fused_chunks_of_the_main_and_full_shapes():
    """At the default 256 MiB: the main path's batch (m 8, N 2048, L 2048,
    128 MiB in fp32) is one chunk; the full shape (N 8192) is two chunks
    in fp32 and one in bf16."""
    assert tkernel.FUSED_WORKSPACE_BYTES == 256 * 2**20
    assert tkernel.fused_chunks(8, 2048, 2048, "fp32") == [(0, 2048)]
    assert tkernel.fused_chunks(8, 8192, 2048, "fp32") == [(0, 4096),
                                                           (4096, 4096)]
    assert tkernel.fused_chunks(8, 8192, 2048, "bf16") == [(0, 8192)]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_fused_chunks_of_one_sample(monkeypatch, precision):
    assert tkernel.fused_chunks(4, 1, 2048, precision) == [(0, 1)]
    monkeypatch.setattr(tkernel, "FUSED_WORKSPACE_BYTES", 1)
    assert tkernel.fused_chunks(4, 1, 2048, precision) == [(0, 1)]
    assert tkernel.fused_chunks(4, 3, 2048, precision) == [(0, 1), (1, 1),
                                                           (2, 1)]


# ------------------------------------------------------------ int8 stream


def _ref_quantized(H, bn, bl, seed):
    """The reference's quantization of H (m, N, L) at its padded layout:
    (Hq, scales, u) as numpy, u being the uniforms it drew."""
    m, N, L = H.shape
    Hp = jnp.pad(jnp.asarray(H), ((0, 0), (0, (-N) % bn), (0, (-L) % bl)))
    Hq, scales = jops.quantize_tiles(Hp, bn, bl, seed)
    nn, nl = Hp.shape[1] // bn, Hp.shape[2] // bl
    u = jax.random.uniform(jax.random.PRNGKey(jnp.asarray(seed, jnp.uint32)),
                           (m, nn, bn, nl, bl))
    return np.asarray(Hq), np.asarray(scales), np.asarray(u)


@pytest.mark.parametrize("m,N,L,bn,bl,seed", [
    (2, 96, 48, 32, 32, 7), (1, 33, 40, 16, 16, 3), (3, 20, 24, 8, 16, 0),
])
def test_round_tiles_reproduces_reference_quantization(m, N, L, bn, bl, seed):
    """On the reference's own uniforms, the port's tiles, scales and
    rounding give the reference's Hq and scales bit for bit, padding
    included."""
    H, = _draw(seed + N, (m, N, L), scale=1.0 / np.sqrt(N))
    Hq_j, s_j, u = _ref_quantized(H, bn, bl, seed)
    x, s_t = tref._tiles(torch.from_numpy(H), bn, bl)
    q = tref._round_tiles(x, torch.from_numpy(u.copy()))
    np.testing.assert_array_equal(s_t.numpy(), s_j)
    np.testing.assert_array_equal(q.reshape(Hq_j.shape).numpy(), Hq_j)
    assert q.dtype == torch.int8


@pytest.mark.parametrize("m,N,L,bn,bl", [(2, 96, 48, 32, 32),
                                          (1, 33, 40, 16, 16)])
def test_gram_tri_q_ref_matches_reference_kernel(m, N, L, bn, bl):
    """The plain version of the int8 kernel against the reference's
    ``gram_pallas_tri_q`` (interpret mode) on the reference's Hq/scales:
    the tile products are exact, only the fp32 order differs."""
    H, T = _draw(11, (m, N, L), (m, N, 3))
    H /= np.sqrt(N)
    Hq, scales, _ = _ref_quantized(H, bn, bl, 5)
    Tp = jnp.pad(jnp.asarray(T), ((0, 0), (0, (-N) % bn), (0, 0)))
    Gj, Rj = jkernel.gram_pallas_tri_q(
        jnp.asarray(Hq), jnp.asarray(scales), Tp.astype(jnp.bfloat16),
        block_l=bl, block_n=bn, interpret=True)
    Hq_t, s_t = convert.quantized_from_numpy(Hq[:, :N, :L], scales,
                                             device="cpu")
    Gt, Rt = tref.gram_tri_q_ref(Hq_t, s_t, torch.from_numpy(T), bn, bl)
    np.testing.assert_allclose(Gt.numpy(), np.asarray(Gj)[:, :L, :L],
                               atol=2e-5, rtol=0)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj)[:, :L],
                               atol=2e-5, rtol=0)
    assert torch.equal(Gt, Gt.mT)
    Gk, Rk = tkernel.gram_tri_q(Hq_t, s_t, torch.from_numpy(T).bfloat16(),
                                block_n=bn, block_l=bl)
    assert torch.equal(Gk, Gt) and torch.equal(Rk, Rt)


@pytest.mark.parametrize("N,L", [(96, 48), (33, 40)])
def test_gram_int8_within_quantization_envelope(N, L):
    """The port's own draws: within 5e-2 of the fp32 Gram's max, as the
    reference's test_gram_int8_within_quantization_envelope."""
    H, T = _draw(N + L, (1, N, L), (1, N, 3))
    H /= np.sqrt(N)
    Gq, Rq = tops.gram_batched(torch.from_numpy(H), torch.from_numpy(T),
                               block_l=32, block_n=32, precision="int8")
    Gr, Rr = tref.gram_ref(torch.from_numpy(H), torch.from_numpy(T))
    assert float((Gq - Gr).abs().max()) <= 5e-2 * float(Gr.abs().max())
    assert float((Rq - Rr).abs().max()) <= 5e-2 * float(Rr.abs().max())


def test_gram_int8_stochastic_rounding_unbiased():
    """Averaged over 32 seeds the int8 Gram closes on the fp32 truth: the
    mean's error is below half the mean single-seed error."""
    H, T = _draw(11, (1, 64, 32), (1, 64, 2))
    H /= 8.0
    Gr, _ = tref.gram_ref(torch.from_numpy(H), torch.from_numpy(T))
    gs = [tops.gram_batched(torch.from_numpy(H), torch.from_numpy(T),
                            block_l=16, block_n=32, precision="int8",
                            quant_seed=s, force_ref=True)[0]
          for s in range(32)]
    single = [float((g - Gr).abs().max()) for g in gs]
    mean_err = float((sum(gs) / len(gs) - Gr).abs().max())
    assert mean_err < 0.5 * (sum(single) / len(single)), (mean_err, single)


def test_quantize_padding_is_exact_zero():
    """Zero input quantizes to exact zeros, and the padding rows/columns of
    a ragged H stay exact zeros in the tile layout for any uniforms."""
    Hdq = tref.quantize_dequantize(torch.zeros(1, 20, 24), block_l=16,
                                   block_n=16, quant_seed=0)
    assert torch.equal(Hdq, torch.zeros(1, 20, 24))
    H, = _draw(2, (2, 20, 24))
    x, _ = tref._tiles(torch.from_numpy(H), 16, 16)
    q = tref._round_tiles(x, torch.full(x.shape, 0.999999)).reshape(2, 32, 32)
    assert not q[:, 20:].any() and not q[:, :, 24:].any()
    assert q[:, :20, :24].abs().max() == 127


def test_int8_kernel_path_matches_emulation_on_same_draws():
    """The int8 op and its ``force_ref`` emulation draw the same uniforms
    from ``quant_seed``: the same quantized H, fp32 order apart."""
    H, T = _draw(4, (2, 50, 36), (2, 50, 3))
    H /= np.sqrt(50)
    args = (torch.from_numpy(H), torch.from_numpy(T))
    G, R = tops.gram_batched(*args, block_l=16, block_n=24, quant_seed=9,
                             precision="int8")
    Ge, Re = tops.gram_batched(*args, block_l=16, block_n=24, quant_seed=9,
                               precision="int8", force_ref=True)
    np.testing.assert_allclose(G.numpy(), Ge.numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(R.numpy(), Re.numpy(), atol=2e-5, rtol=0)
    G2, _ = tops.gram(args[0][0], args[1][0], block_l=16, block_n=24,
                      quant_seed=9, precision="int8")
    assert G2.shape == (36, 36)
    G3, _ = tops.gram_batched(*args, block_l=16, block_n=24, quant_seed=10,
                              precision="int8")
    assert not torch.equal(G3, G)


@pytest.mark.parametrize("N,block_n", [(1, 512), (7, 512), (9, 4), (100, 30),
                                       (5000, 512), (96, 32)])
def test_resolve_block_n_matches_reference(N, block_n):
    assert tops.resolve_block_n(N, block_n) == jops.resolve_block_n(N,
                                                                    block_n)


def test_int8_block_n_limit_raises():
    """int32 tile sums are exact in fp32 only up to block_n = 1040."""
    assert tref.MAX_INT8_BLOCK_N == 1040
    H = torch.ones(1, 2048, 8)
    with pytest.raises(ValueError, match="block_n"):
        tops.gram_batched(H, torch.ones(1, 2048, 1), block_n=2048,
                          precision="int8")
    tops.gram_batched(H, torch.ones(1, 2048, 1), block_n=1040,
                      precision="int8")


# ------------------------------------------- the int8 body's K-major copy

# (m, N, L, D, block_n, block_l): a stage-multiple block_n, ones that are
# not (40, 104), N = 1, L % 4 != 0, D > 16, the largest exact block_n
KMAJOR_CASES = [(2, 96, 48, 3, 32, 32), (2, 500, 130, 3, 40, 32),
                (1, 333, 129, 2, 1040, 64), (2, 700, 60, 17, 104, 64),
                (3, 1, 20, 3, 8, 8), (2, 1000, 70, 3, 512, 128)]


def _kmajor_case(m, N, L, D, bn, bl):
    H, T = _draw(N + L + bn, (m, N, L), (m, N, D))
    Hq, scales = tref.quantize_tiles(torch.from_numpy(H / np.sqrt(N)), bn, bl,
                                     torch.Generator().manual_seed(bn))
    stage, bnp = tkernel.q_layout(N, bn)
    return Hq, scales, torch.from_numpy(T), stage, bnp


@pytest.mark.parametrize("m,N,L,D,bn,bl", KMAJOR_CASES)
def test_q_kmajor_ref_holds_each_row_block_then_zeros(m, N, L, D, bn, bl):
    """Row block nb's samples sit at positions nb * bnp .. of every row of
    L, in order, and every padded position holds an exact 0."""
    Hq, _, _, stage, bnp = _kmajor_case(m, N, L, D, bn, bl)
    Hk = tref.q_kmajor_ref(Hq, bn, bnp)
    nn = -(-N // bn)
    assert Hk.shape == (m, L, nn * bnp) and Hk.dtype == torch.int8
    for nb in range(nn):
        rows = min(bn, N - nb * bn)
        block = Hk[:, :, nb * bnp:(nb + 1) * bnp]
        assert torch.equal(block[:, :, :rows], Hq[:, nb * bn:nb * bn + rows].mT)
        assert not block[:, :, rows:].any()


@pytest.mark.parametrize("m,N,L,D,bn,bl", KMAJOR_CASES)
def test_gram_tri_q_ref_from_the_kmajor_copy_is_the_same(m, N, L, D, bn, bl):
    """What the int8 body computes from the K-major copy: per padded row
    block, the int products of whole stages, zero samples included, scaled
    as the plain version scales them.  G equals ``gram_tri_q_ref`` on Hq bit
    for bit (the products are exact); R too from each block's own samples,
    and to fp32 roundoff from the padded block (the CPU's matrix product
    sums a longer k in another blocking: 7e-7 at (2, 1000, 70, 3))."""
    Hq, scales, T, stage, bnp = _kmajor_case(m, N, L, D, bn, bl)
    Hk = tref.q_kmajor_ref(Hq, bn, bnp)
    cols = torch.arange(L) // bl
    Tf = torch.nn.functional.pad(T.bfloat16().float(), (0, 0, 0, bnp))
    G = torch.zeros((m, L, L))
    R = torch.zeros((m, L, D))
    R_padded = torch.zeros((m, L, D))
    for nb in range(-(-N // bn)):
        rows = min(bn, N - nb * bn)
        q = Hk[:, :, nb * bnp:(nb + 1) * bnp].float()    # (m, L, bnp)
        s = scales[:, nb][:, cols]
        G = G + (q @ q.mT) * (s[:, :, None] * s[:, None, :])
        qs = q * s[:, :, None]
        R = R + qs[:, :, :rows] @ Tf[:, nb * bn:nb * bn + rows]
        # the padded positions meet the next block's T, as in the kernel
        R_padded = R_padded + qs @ Tf[:, nb * bn:nb * bn + bnp]
    Gr, Rr = tref.gram_tri_q_ref(Hq, scales, T, bn, bl)
    assert torch.equal(G, Gr) and torch.equal(R, Rr)
    np.testing.assert_allclose(R_padded.numpy(), Rr.numpy(), rtol=0,
                               atol=1e-6 * float(Rr.abs().max()))


@pytest.mark.parametrize("N,block_n", [(1, 1), (1, 512), (2048, 512),
                                       (1000, 512), (500, 40), (700, 104),
                                       (96, 32), (333, 1040), (8192, 8),
                                       (300, 300), (160, 160), (2000, 16)])
def test_q_layout_pads_each_row_block_to_whole_stages(N, block_n):
    """A stage of 128, 64 or 32 samples; the padded block a whole number of
    stages that holds a row block; at most a quarter more than the least
    padding (to 32 samples), and no stage deeper than that allows."""
    stage, bnp = tkernel.q_layout(N, block_n)
    rows = min(block_n, N)
    least = -(-rows // 32) * 32
    assert stage in (128, 64, 32) and bnp % stage == 0 and bnp >= rows
    assert bnp == -(-rows // stage) * stage and 4 * bnp <= 5 * least
    deeper = [s for s in (128, 64, 32) if s > stage]
    assert all(4 * (-(-rows // s) * s) > 5 * least for s in deeper)
    if rows >= 16:
        assert bnp <= 2 * rows


def test_q_layout_of_the_main_path_pads_nothing():
    """Phase 4's int8 stream (block_n 512 at N 2048 a batch, 8192 at full):
    128-sample stages, and the copy is Hq's size."""
    for N in (2048, 8192):
        assert tkernel.q_layout(N, tops.resolve_block_n(N, 512)) == (128, 512)


@pytest.mark.parametrize("m,N,L,D,bn,bl", KMAJOR_CASES[:3])
def test_q_kmajor_of_cpu_tensors_is_the_plain_layout(m, N, L, D, bn, bl):
    """Hq's copy, and T's (m, D, kp) in the same positions, zeros between."""
    Hq, _, T, _, bnp = _kmajor_case(m, N, L, D, bn, bl)
    T = T.bfloat16()
    Hk, Tk = tkernel.q_kmajor(Hq, T, bn)
    assert torch.equal(Hk, tref.q_kmajor_ref(Hq, bn, bnp))
    assert Tk.shape == (m, D, Hk.shape[-1]) and Tk.dtype == torch.bfloat16
    for nb in range(-(-N // bn)):
        rows = min(bn, N - nb * bn)
        block = Tk[:, :, nb * bnp:(nb + 1) * bnp]
        assert torch.equal(block[:, :, :rows], T[:, nb * bn:nb * bn + rows].mT)
        assert not block[:, :, rows:].any()


@pytest.mark.parametrize("block_n,block_l", [(0, 16), (1041, 16), (8, 0),
                                             (2048, 128)])
def test_gram_tri_q_refuses_block_sizes_as_before(block_n, block_l):
    """The wrapper's refusals are those of the old body: block_n in
    [1, 1040], block_l >= 1, raised before anything runs; ``q_kmajor``
    refuses the same block_n, and the plain layout a bnp that cannot hold a
    row block."""
    Hq = torch.zeros(1, 8, 16, dtype=torch.int8)
    s = torch.ones(1, 1, 1)
    T = torch.zeros(1, 8, 3, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="block_n"):
        tkernel.gram_tri_q(Hq, s, T, block_n=block_n, block_l=block_l)
    if block_l >= 1:
        with pytest.raises(ValueError, match="block_n"):
            tkernel.q_kmajor(Hq, T, block_n)
    with pytest.raises(ValueError, match="hold a row block"):
        tref.q_kmajor_ref(Hq, 8, 7)


def test_gram_body_of_int8_is_the_tensor_cores():
    assert tkernel.gram_body(torch.int8) == "wgmma"


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("N,L,D", [(40, 70, 3), (9, 129, 2)])
def test_gram_dense_variant_matches_reference(N, L, D, precision):
    """``variant="dense"`` (the dense-tile baseline) against the
    reference's Pallas baseline in interpret mode."""
    H, T = _draw(N * L, (N, L), (N, D))
    Gt, Rt = tops.gram(torch.from_numpy(H), torch.from_numpy(T),
                       variant="dense", precision=precision)
    Gj, Rj = jops.gram(jnp.asarray(H), jnp.asarray(T), variant="dense",
                       precision=precision, block_l=32, block_n=16)
    np.testing.assert_allclose(_np(Gt), np.asarray(Gj), **TOL[precision])
    np.testing.assert_allclose(_np(Rt), np.asarray(Rj), **TOL[precision])
    Gf, _ = tops.gram(torch.from_numpy(H), torch.from_numpy(T),
                      variant="dense", precision=precision, force_ref=True)
    assert torch.equal(Gf, Gt)


def test_fp32_block_keywords_are_tiling_hints():
    """The reference's block_l/block_n keywords are accepted; for fp32 and
    bf16 they do not change the result."""
    H, T = map(torch.from_numpy, _draw(6, (2, 30, 20), (2, 30, 2)))
    G, R = tops.gram_batched(H, T)
    for kw in (dict(block_l=32, block_n=8), dict(block_l=16, block_n=64)):
        G2, R2 = tops.gram_batched(H, T, **kw)
        assert torch.equal(G2, G) and torch.equal(R2, R)
        assert torch.equal(tops.gram(H[0], T[0], **kw)[0], G[0])


def test_quantized_from_numpy():
    q = np.array([[[-127, 0], [5, 127]]], np.int8)
    Hq, s = convert.quantized_from_numpy(q, np.ones((1, 1, 1)), device="cpu")
    assert Hq.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(Hq.numpy(), q)
    with pytest.raises(ValueError, match="int8"):
        convert.quantized_from_numpy(q.astype(np.int32), np.ones((1, 1, 1)),
                                     device="cpu")


# ------------------------------------------------ the kernels' build key

def test_library_name_follows_the_shared_headers(monkeypatch, tmp_path):
    """A kernel library's name hashes its source and every shared header
    (``kernels/include/*.cuh``), so editing a header rebuilds the kernels
    that include it; the shipped header is on that list."""
    from repro_torch.kernels import _build

    assert (_build.INCLUDE_DIR / "ptx.cuh").is_file()
    assert '#include "ptx.cuh"' in tkernel.SOURCE.read_text()
    monkeypatch.setattr(_build, "INCLUDE_DIR", tmp_path)
    (tmp_path / "ptx.cuh").write_text("// one\n")
    first = _build.library_path(tkernel.SOURCE)
    assert first == _build.library_path(tkernel.SOURCE)
    assert first.name.startswith("gram-") and first.suffix == ".so"
    (tmp_path / "ptx.cuh").write_text("// two\n")
    assert _build.library_path(tkernel.SOURCE) != first


# ------------------------------------------- the bf16 body, chosen by shape

def _bf16(shape):
    return torch.zeros(shape, dtype=torch.bfloat16)


def _off16(shape):
    """A contiguous bf16 view one element past its buffer's start, so off
    16 bytes."""
    n = int(np.prod(shape))
    view = _bf16(n + 1)[1:].view(shape)
    assert view.is_contiguous() and view.data_ptr() % 16 != 0
    return view


@pytest.mark.parametrize("L", [8, 64, 120, 136, 256, 296, 2048])
def test_gram_body_takes_the_tensor_cores_for_bf16_rows_tma_can_read(L):
    """bf16 H with L % 8 == 0 (16-byte row strides) on 16 bytes: TMA + wgmma,
    reading H in place."""
    H = _bf16((2, 3, L))
    assert H.data_ptr() % 16 == 0
    assert tkernel.gram_body(H.dtype) == "wgmma"
    assert tkernel.h_buffer(H) is H


@pytest.mark.parametrize("case", ["fp32", "L300", "L4", "offset_view"])
def test_gram_body_takes_the_fma_body_elsewhere(case):
    """The FMA body is fp32's alone: bf16 rows that are not a multiple of 8
    values, and a bf16 view off 16 bytes, take the tensor cores too, read
    from the padded copy ``h_buffer`` makes."""
    H = {"fp32": torch.zeros(2, 3, 2048), "L300": _bf16((2, 3, 300)),
         "L4": _bf16((2, 3, 4)), "offset_view": _off16((2, 3, 2048))}[case]
    want = "fma" if case == "fp32" else "wgmma"
    assert tkernel.gram_body(H.dtype) == want
    if case != "fp32":
        assert tkernel.h_buffer(H) is not H


@pytest.mark.parametrize("shape", [(8, 2048, 2048, 3), (8, 8192, 2048, 8),
                                   (1, 8192, 2048, 3)],
                         ids=["main", "full", "dense_main"])
def test_gram_body_of_the_main_and_full_shapes(shape):
    """The bf16 stream's H as ``ops`` hands it over (cast, contiguous) at
    the main path's and the full shape's widths takes the tensor cores
    (the body depends on the dtype, L and H's base, not on m or N)."""
    m, _, L, _ = shape
    H, _ = tops._cast(torch.zeros(m, 2, L), torch.zeros(m, 2, 3), "bf16")
    H = H.contiguous()
    assert tkernel.gram_body(H.dtype) == "wgmma"
    assert tkernel.h_buffer(H) is H


def test_cpu_gram_calls_record_no_body():
    """``LAST_GRAM`` is written where a kernel launches: the plain versions
    on CPU tensors leave it as it was."""
    tkernel.LAST_GRAM.update(kernel="sentinel", body="sentinel")
    H, T = _bf16((2, 4, 16)), _bf16((2, 4, 3))
    tkernel.gram_tri(H, T)
    tkernel.gram_dense(H[0], T[0])
    assert tkernel.LAST_GRAM == {"kernel": "sentinel", "body": "sentinel"}


@pytest.mark.parametrize("D", [1, 3, 8, 9, 16, 33])
def test_t_buffer_has_rows_of_16_bytes(D):
    """Where the tensor-core body reads T from: rows of 8 ceil(D / 8) values,
    contiguous, on 16 bytes; T itself where it already is so, else a new
    buffer (which the launch fills)."""
    T = torch.from_numpy(_draw(D, (2, 5, D))[0]).bfloat16()
    Tp = tkernel.t_buffer(T)
    assert Tp.shape == (2, 5, -(-D // 8) * 8) and Tp.is_contiguous()
    assert Tp.data_ptr() % 16 == 0 and Tp.dtype == T.dtype
    assert (Tp is T) == (D % 8 == 0)


def test_t_buffer_of_a_view_off_16_bytes_is_new():
    T = _off16((2, 5, 8))
    Tp = tkernel.t_buffer(T)
    assert Tp is not T and Tp.shape == T.shape and Tp.data_ptr() % 16 == 0


@pytest.mark.parametrize("L", [1, 4, 8, 257, 296, 300, 2048])
def test_h_buffer_has_rows_of_16_bytes(L):
    """Where the tensor-core body reads H from: rows of 8 ceil(L / 8) values,
    contiguous, on 16 bytes; H itself where it already is so, else a new
    buffer (which the launch fills)."""
    H = torch.from_numpy(_draw(L, (2, 5, L))[0]).bfloat16()
    Hp = tkernel.h_buffer(H)
    assert Hp.shape == (2, 5, -(-L // 8) * 8) and Hp.is_contiguous()
    assert Hp.data_ptr() % 16 == 0 and Hp.dtype == H.dtype
    assert (Hp is H) == (L % 8 == 0)


def test_h_buffer_of_a_view_off_16_bytes_is_new():
    H = _off16((2, 5, 16))
    Hp = tkernel.h_buffer(H)
    assert Hp is not H and Hp.shape == H.shape and Hp.data_ptr() % 16 == 0


@pytest.mark.parametrize("L", [4, 257, 300])
def test_zero_columns_of_the_padded_h_add_exact_zeros(L):
    """What the padded route computes: G and R of H with zero columns up to
    8 ceil(L / 8), cut back to L, equal G and R of H itself, and the padding
    adds nothing but zeros (small-integer inputs: every sum exact)."""
    rng = np.random.default_rng(L)
    H = torch.from_numpy(rng.integers(-2, 3, (2, 9, L)).astype(np.float32)).bfloat16()
    T = torch.from_numpy(rng.integers(-2, 3, (2, 9, 3)).astype(np.float32)).bfloat16()
    Hp = torch.zeros((2, 9, -(-L // 8) * 8), dtype=H.dtype)
    Hp[..., :L] = H
    G, R = tref.gram_ref(H, T)
    Gp, Rp = tref.gram_ref(Hp, T)
    assert torch.equal(Gp[:, :L, :L], G) and torch.equal(Rp[:, :L], R)
    assert not Gp[:, L:].any() and not Rp[:, L:].any()
