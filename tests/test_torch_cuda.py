"""The CUDA kernels (Gram, sliding-window attention, RG-LRU scan, chunkwise
mLSTM) against their plain versions, on the card.

Marked ``cuda``: each test skips where CUDA is absent.  Run them on the
card with ``python -m pytest -q -m cuda tests/test_torch_cuda.py`` (this
file imports no JAX).  Tolerances: max |kernel - plain| / max |plain| below
1e-4 in fp32 (only the summation order differs) and 3e-2 in bf16.  ``swa``
is also held in norm, ||kernel - plain|| / ||plain|| below SWA_NORM_TOL:
its max |plain| comes from early rows with few live keys (row 0's output
is v_0), so the max-based limit alone is loose on the rows with a full
window, whose entries are ~W^-1/2 smaller.  ``mlstm`` returns fp32 from
widened inputs, so it is held at fp32 level in every dtype, in norm below
MLSTM_NORM_TOL as well.
"""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.gram import kernel, ops, ref  # noqa: E402
from repro_torch.kernels.mlstm import kernel as mlstm_kernel  # noqa: E402
from repro_torch.kernels.mlstm import ops as mlstm_ops  # noqa: E402
from repro_torch.kernels.mlstm.ref import (  # noqa: E402
    mlstm_chunkwise_ref,
    mlstm_sequential_ref,
)
from repro_torch.kernels.rglru import kernel as rglru_kernel  # noqa: E402
from repro_torch.kernels.rglru import ops as rglru_ops  # noqa: E402
from repro_torch.kernels.rglru.ref import rglru_scan_ref  # noqa: E402
from repro_torch.kernels.swa import kernel as swa_kernel  # noqa: E402
from repro_torch.kernels.swa import ops as swa_ops  # noqa: E402
from repro_torch.kernels.swa.ref import swa_ref  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = {"fp32": 1e-4, "bf16": 3e-2}
SWA_NORM_TOL = {"fp32": 1e-5, "bf16": 2e-3}
MLSTM_NORM_TOL = 1e-5


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _norm_rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b))


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


@pytest.mark.parametrize("activation", ["sigmoid", "tanh", "relu", "gelu"])
@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_gram_fused_over_several_chunks(gen, monkeypatch, activation,
                                        precision):
    """A workspace budget of 350 rows runs N = 1000 in chunks of 350, 350
    and a ragged 300: later chunks add into G and R, G stays exactly
    symmetric, and the call counts one launch."""
    m, N, d_in, L, D = 3, 1000, 70, 300, 3
    row_bytes = m * kernel.fused_workspace_width(L, precision) * (
        4 if precision == "fp32" else 2)
    monkeypatch.setattr(kernel, "FUSED_WORKSPACE_BYTES", 350 * row_bytes)
    assert kernel.fused_chunks(m, N, L, precision) == [
        (0, 350), (350, 350), (700, 300)]
    X = torch.randn(m, N, d_in, device="cuda", generator=gen)
    W = torch.randn(d_in, L, device="cuda", generator=gen) / d_in**0.5
    b = torch.randn(L, device="cuda", generator=gen)
    T = torch.randn(m, N, D, device="cuda", generator=gen)
    if precision == "bf16":
        T = T.bfloat16()
    before = kernel.LAUNCHES["gram_fused"]
    G, R = kernel.gram_fused(X, W, b, T, activation, precision)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES["gram_fused"] == before + 1
    # what the wrapper launched: three chunks, the hidden layer once per row
    assert kernel.LAST_FUSED == {"chunks": 3, "hidden_rows": N,
                                 "workspace_bytes": 350 * row_bytes}
    Gr, Rr = ref.gram_fused_ref(X, W, b, T, activation, precision)
    assert torch.equal(G, G.mT)
    assert _rel(G, Gr) <= TOL[precision] and _rel(R, Rr) <= TOL[precision]


def _off16(shape, dtype, gen):
    """A contiguous tensor whose storage starts 1 element past a 16-byte
    boundary (a view of a larger buffer)."""
    n = 1
    for d in shape:
        n *= d
    buf = torch.randn(n + 1, device="cuda", generator=gen).to(dtype)
    t = buf[1:].view(shape)
    assert t.is_contiguous() and t.data_ptr() % 16 != 0
    return t


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_gram_fused_takes_views_off_16_bytes(gen, precision):
    """d_in and L multiples of 4 with X and W off 16 bytes: the hidden layer
    takes its one-float loads, not float4 (which would fault)."""
    m, N, d_in, L, D = 2, 33, 8, 40, 3
    X = _off16((m, N, d_in), torch.float32, gen)
    W = _off16((d_in, L), torch.float32, gen)
    b = torch.randn(L, device="cuda", generator=gen)
    T = torch.randn(m, N, D, device="cuda", generator=gen)
    if precision == "bf16":
        T = T.bfloat16()
    G, R = kernel.gram_fused(X, W, b, T, "tanh", precision)
    torch.cuda.synchronize()
    Gr, Rr = ref.gram_fused_ref(X, W, b, T, "tanh", precision)
    assert torch.equal(G, G.mT)
    assert _rel(G, Gr) <= TOL[precision] and _rel(R, Rr) <= TOL[precision]


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_gram_fused_chunk_refuses_another_workspace_row_width(gen, precision):
    """The C entry takes the workspace's row width from the caller and
    refuses one its Gram grid cannot read (fp32: not L; bf16: below L or not
    a multiple of 8) before it launches anything."""
    m, N, d_in, L, D = 1, 4, 4, 12, 1
    t_dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    X = torch.randn(m, N, d_in, device="cuda", generator=gen)
    W = torch.randn(d_in, L, device="cuda", generator=gen)
    b = torch.randn(L, device="cuda", generator=gen)
    T = torch.randn(m, N, D, device="cuda", generator=gen).to(t_dtype)
    G = torch.empty(m, L, L, device="cuda")
    R = torch.empty(m, L, D, device="cuda")
    ws = torch.empty(m * N * 32, dtype=t_dtype, device="cuda")
    lib = kernel.library()
    fn = (lib.gram_fused_chunk_bf16 if precision == "bf16"
          else lib.gram_fused_chunk_f32)
    stream = torch.cuda.current_stream().cuda_stream

    def call(ldh):
        return fn(X.data_ptr(), W.data_ptr(), b.data_ptr(), T.data_ptr(),
                  G.data_ptr(), R.data_ptr(), ws.data_ptr(), m, N, L, D, d_in,
                  0, N, ldh, 0, stream)

    bad = [L - 1, L + 4] if precision == "fp32" else [L - 4, L + 1]
    for ldh in bad:
        assert call(ldh) != 0, ldh
    assert call(kernel.fused_workspace_width(L, precision)) == 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("m,N,L,D,bn,bl", [
    (1, 1, 1, 1, 8, 128),        # one row, one column
    (2, 96, 48, 3, 32, 32),      # the reference's int8 test shape
    (3, 1000, 300, 3, 512, 128),  # ragged: block_n does not divide N
    (2, 520, 260, 17, 40, 32),   # block_l = 32 inside the 128 tile, D > 16
    (1, 333, 129, 2, 1040, 64),  # the largest exact block_n
    (2, 500, 300, 3, 40, 128),   # block_n not a multiple of a stage: 64-sample stages
    (2, 700, 260, 3, 104, 64),   # ... padded to one 128-sample stage
    (2, 1, 300, 3, 8, 32),       # N = 1: one sample in a 32-sample stage
    (2, 1000, 300, 3, 512, 32),  # L 300 at block_l 32 and 64
    (2, 1000, 300, 3, 512, 64),
    (1, 600, 200, 17, 96, 64),   # D 17: two passes of R, 32-sample stages
    (9, 300, 140, 3, 104, 128),  # m 9
])
def test_gram_tri_q_matches_plain(gen, m, N, L, D, bn, bl):
    """Same Hq/scales into both: the int32 tile products are exact and G is
    scaled into fp32 in the plain version's order, so G equals it bit for
    bit; only the fp32 order of R differs."""
    H = torch.randn(m, N, L, device="cuda", generator=gen) / N**0.5
    T = torch.randn(m, N, D, device="cuda", generator=gen).bfloat16()
    Hq, scales = ref.quantize_tiles(H, bn, bl, gen)
    before = kernel.LAUNCHES["gram_tri_q"]
    G, R = kernel.gram_tri_q(Hq, scales, T, block_n=bn, block_l=bl)
    torch.cuda.synchronize()
    Gr, Rr = ref.gram_tri_q_ref(Hq, scales, T, bn, bl)
    assert kernel.LAUNCHES["gram_tri_q"] == before + 1
    assert kernel.LAST_GRAM == {"kernel": "gram_tri_q", "body": "wgmma"}
    assert torch.equal(G, G.mT)
    assert torch.equal(G, Gr)
    assert _rel(G, Gr) <= TOL["fp32"] and _rel(R, Rr) <= TOL["fp32"]


@pytest.mark.parametrize("m,N,L,D,bn", [(1, 1, 1, 1, 8), (2, 1000, 300, 3, 512),
                                        (2, 520, 261, 17, 40),
                                        (3, 700, 130, 8, 104),
                                        (1, 333, 129, 2, 1040),
                                        (2, 100, 33, 3, 1)])
def test_q_kmajor_matches_plain(gen, m, N, L, D, bn):
    """The int8 body's K-major copies of Hq and T equal their plain layout
    byte for byte: each row block's samples, then zeros up to the padded
    length (L % 16 != 0 takes the pre-pass's byte loads)."""
    Hq = torch.randint(-127, 128, (m, N, L), device="cuda", generator=gen,
                       dtype=torch.int8)
    T = torch.randn(m, N, D, device="cuda", generator=gen).bfloat16()
    bnp = kernel.q_layout(N, bn)[1]
    Hk, Tk = kernel.q_kmajor(Hq, T, bn)
    torch.cuda.synchronize()
    assert torch.equal(Hk, ref.q_kmajor_ref(Hq, bn, bnp))
    assert torch.equal(Tk, ref.q_kmajor_ref(T, bn, bnp))


def test_q_kmajor_reads_hq_off_16_bytes(gen):
    """A view of Hq one byte past its buffer's start takes the byte loads
    (L % 16 == 0 otherwise takes 16-byte ones)."""
    buf = torch.randint(-127, 128, (2 * 64 * 128 + 1,), device="cuda",
                        generator=gen, dtype=torch.int8)
    Hq = buf[1:].view(2, 64, 128)
    T = torch.randn(2, 64, 3, device="cuda", generator=gen).bfloat16()
    Hk, _ = kernel.q_kmajor(Hq, T, 64)
    torch.cuda.synchronize()
    assert torch.equal(Hk, ref.q_kmajor_ref(Hq, 64, kernel.q_layout(64, 64)[1]))


def test_gram_tri_q_entry_refuses_another_layout(gen):
    """The C entry checks the plan it is handed (a stage of 128, 64 or 32
    samples that divides the padded block, which holds a row block) and
    launches nothing where it does not hold."""
    m, N, L, D, bn, bl = 1, 100, 64, 3, 40, 32
    Hq = torch.zeros(m, N, L, dtype=torch.int8, device="cuda")
    s = torch.ones(m, 3, 2, device="cuda")
    T = torch.zeros(m, N, D, dtype=torch.bfloat16, device="cuda")
    G = torch.empty(m, L, L, device="cuda")
    R = torch.empty(m, L, D, device="cuda")
    Hk = torch.empty(m * L * 3 * 128, dtype=torch.int8, device="cuda")
    Tk = torch.empty(m * D * 3 * 128, dtype=torch.bfloat16, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call(ks, bnp):
        return kernel.library().gram_tri_q(
            Hq.data_ptr(), Hk.data_ptr(), s.data_ptr(), T.data_ptr(),
            Tk.data_ptr(), G.data_ptr(), R.data_ptr(), m, N, L, D, bn, bl, ks,
            bnp, stream)

    for ks, bnp in [(16, 64), (64, 96), (32, 32), (128, 0)]:
        assert call(ks, bnp) != 0, (ks, bnp)
    assert call(*kernel.q_layout(N, bn)) == 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("N,L,D", [(1, 1, 1), (1000, 300, 3), (64, 257, 20)])
def test_gram_dense_matches_plain(gen, N, L, D, precision):
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    H = torch.randn(N, L, device="cuda", generator=gen).to(dtype)
    T = torch.randn(N, D, device="cuda", generator=gen).to(dtype)
    before = kernel.LAUNCHES["gram_dense"]
    G, R = kernel.gram_dense(H, T)
    torch.cuda.synchronize()
    Gr, Rr = ref.gram_ref(H, T)
    assert kernel.LAUNCHES["gram_dense"] == before + 1
    assert _rel(G, Gr) <= TOL[precision] and _rel(R, Rr) <= TOL[precision]


def _gram_bf16(kind, m, N, L, D, gen):
    """bf16 H (scaled to unit rows) and T for ``kind`` (one agent for the
    dense baseline), the call and its plain version."""
    shape = (N, L) if kind == "gram_dense" else (m, N, L)
    H = (torch.randn(*shape, device="cuda", generator=gen) / L**0.5).bfloat16()
    T = torch.randn(*shape[:-1], D, device="cuda", generator=gen).bfloat16()
    return H, T, getattr(kernel, kind)


@pytest.mark.parametrize("m", [1, 3])
@pytest.mark.parametrize("N", [1, 63, 64, 65, 1000])     # 64-sample stages
@pytest.mark.parametrize("L", [8, 64, 120, 136, 256, 296])  # boxes, tiles, pairs
def test_gram_tri_bf16_wgmma_at_the_tile_edges(gen, L, N, m):
    """The tensor-core body at the edges of its 64-sample stages, 64-column
    boxes, 128-column tiles and two-tile blocks: within TOL of the plain
    version, G exactly symmetric, and the call recorded that body."""
    H, T, fn = _gram_bf16("gram_tri", m, N, L, 3, gen)
    G, R = fn(H, T)
    torch.cuda.synchronize()
    assert kernel.LAST_GRAM == {"kernel": "gram_tri", "body": "wgmma"}
    Gr, Rr = ref.gram_ref(H, T)
    assert torch.equal(G, G.mT)
    assert _rel(G, Gr) <= TOL["bf16"] and _rel(R, Rr) <= TOL["bf16"]


@pytest.mark.parametrize("N", [1, 63, 64, 65, 1000])
@pytest.mark.parametrize("L", [8, 64, 120, 136, 256, 296])
def test_gram_dense_bf16_wgmma_at_the_tile_edges(gen, L, N):
    H, T, fn = _gram_bf16("gram_dense", 1, N, L, 3, gen)
    G, R = fn(H, T)
    torch.cuda.synchronize()
    assert kernel.LAST_GRAM == {"kernel": "gram_dense", "body": "wgmma"}
    Gr, Rr = ref.gram_ref(H, T)
    assert _rel(G, Gr) <= TOL["bf16"] and _rel(R, Rr) <= TOL["bf16"]


@pytest.mark.parametrize("N", [63, 64, 65, 129, 1000])
@pytest.mark.parametrize("kind", ["gram_tri", "gram_dense"])
def test_gram_bf16_wgmma_is_exact_on_integers(gen, kind, N):
    """On small-integer inputs every product and partial sum is exact in
    fp32, so the tensor-core body must equal its plain version exactly:
    one 64-sample stage lost shows here at any N, where TOL cannot see it
    at large N."""
    m, L, D = 3, 264, 9
    shape = (N, L) if kind == "gram_dense" else (m, N, L)
    H = torch.randint(-2, 3, shape, device="cuda", generator=gen).bfloat16()
    T = torch.randint(-2, 3, (*shape[:-1], D), device="cuda", generator=gen).bfloat16()
    G, R = getattr(kernel, kind)(H, T)
    torch.cuda.synchronize()
    assert kernel.LAST_GRAM == {"kernel": kind, "body": "wgmma"}
    Gr, Rr = ref.gram_ref(H, T)
    assert torch.equal(G, Gr) and torch.equal(R, Rr)


@pytest.mark.parametrize("N", [15, 16, 17, 63, 1000])
@pytest.mark.parametrize("L", [4, 130, 264, 300])
@pytest.mark.parametrize("kind", ["gram_tri", "gram_dense"])
def test_gram_fp32_is_exact_on_integers(gen, kind, L, N):
    """The fp32 body on small-integer inputs: every product and partial sum
    is exact in fp32, so G and R must equal the plain version exactly, at
    the edges of its 16-sample stages and with 16-byte (L % 4 == 0) and
    4-byte copies; one stage lost or read before it lands shows here."""
    m, D = 3, 9
    shape = (N, L) if kind == "gram_dense" else (m, N, L)
    H = torch.randint(-2, 3, shape, device="cuda", generator=gen).float()
    T = torch.randint(-2, 3, (*shape[:-1], D), device="cuda", generator=gen).float()
    G, R = getattr(kernel, kind)(H, T)
    torch.cuda.synchronize()
    assert kernel.LAST_GRAM == {"kernel": kind, "body": "fma"}
    Gr, Rr = ref.gram_ref(H, T)
    assert torch.equal(G, Gr) and torch.equal(R, Rr)


@pytest.mark.parametrize("D", [1, 3, 16, 17, 33])   # R's 16-column passes
@pytest.mark.parametrize("kind", ["gram_tri", "gram_dense"])
def test_gram_fp32_r_over_several_passes(gen, kind, D):
    m, N, L = 2, 200, 264
    shape = (N, L) if kind == "gram_dense" else (m, N, L)
    H = torch.randn(*shape, device="cuda", generator=gen) / L**0.5
    T = torch.randn(*shape[:-1], D, device="cuda", generator=gen)
    G, R = getattr(kernel, kind)(H, T)
    torch.cuda.synchronize()
    Gr, Rr = ref.gram_ref(H, T)
    assert _rel(G, Gr) <= TOL["fp32"] and _rel(R, Rr) <= TOL["fp32"]


@pytest.mark.parametrize("kind", ["gram_tri", "gram_dense"])
def test_gram_fp32_takes_views_off_16_bytes(gen, kind):
    """fp32 H off 16 bytes with L % 4 == 0 takes the 4-byte copies and
    agrees."""
    m, N, L, D = 2, 100, 136, 3
    shape = (N, L) if kind == "gram_dense" else (m, N, L)
    H = _off16(shape, torch.float32, gen)
    T = torch.randn(*shape[:-1], D, device="cuda", generator=gen)
    G, R = getattr(kernel, kind)(H, T)
    torch.cuda.synchronize()
    Gr, Rr = ref.gram_ref(H, T)
    assert _rel(G, Gr) <= TOL["fp32"] and _rel(R, Rr) <= TOL["fp32"]


@pytest.mark.parametrize("D", [1, 8, 9, 16, 17, 33])   # R's 8-column groups, passes
@pytest.mark.parametrize("kind", ["gram_tri", "gram_dense"])
def test_gram_bf16_wgmma_r_over_several_passes(gen, kind, D):
    H, T, fn = _gram_bf16(kind, 2, 200, 264, D, gen)
    G, R = fn(H, T)
    torch.cuda.synchronize()
    assert kernel.LAST_GRAM == {"kernel": kind, "body": "wgmma"}
    Gr, Rr = ref.gram_ref(H, T)
    assert _rel(G, Gr) <= TOL["bf16"] and _rel(R, Rr) <= TOL["bf16"]


@pytest.mark.parametrize("kind", ["gram_tri", "gram_dense"])
def test_gram_bf16_takes_views_off_16_bytes(gen, kind):
    """H off 16 bytes with L % 8 == 0: TMA cannot read it in place, so the
    launch fills a padded copy (``h_buffer``) and the tensor-core body reads
    that, and agrees."""
    m, N, L, D = 2, 100, 136, 3
    shape = (N, L) if kind == "gram_dense" else (m, N, L)
    H = _off16(shape, torch.bfloat16, gen)
    T = torch.randn(*shape[:-1], D, device="cuda", generator=gen).bfloat16()
    assert kernel.gram_body(H.dtype) == "wgmma"
    assert kernel.h_buffer(H) is not H
    G, R = getattr(kernel, kind)(H, T)
    torch.cuda.synchronize()
    assert kernel.LAST_GRAM == {"kernel": kind, "body": "wgmma"}
    Gr, Rr = ref.gram_ref(H, T)
    assert _rel(G, Gr) <= TOL["bf16"] and _rel(R, Rr) <= TOL["bf16"]


@pytest.mark.parametrize("N", [1, 65, 1000])
@pytest.mark.parametrize("L", [4, 257, 300])
@pytest.mark.parametrize("kind", ["gram_tri", "gram_dense"])
def test_gram_bf16_padded_route(gen, kind, L, N):
    """L % 8 != 0: the launch pads H (and T) with zero columns and the
    tensor-core body runs; within TOL of the plain version on Gaussian
    inputs, G exactly symmetric (triangle), and exactly equal on
    small-integer inputs."""
    m, D = 3, 5
    H, T, fn = _gram_bf16(kind, m, N, L, D, gen)
    assert kernel.h_buffer(H) is not H
    G, R = fn(H, T)
    torch.cuda.synchronize()
    assert kernel.LAST_GRAM == {"kernel": kind, "body": "wgmma"}
    Gr, Rr = ref.gram_ref(H, T)
    if kind == "gram_tri":
        assert torch.equal(G, G.mT)
    assert _rel(G, Gr) <= TOL["bf16"] and _rel(R, Rr) <= TOL["bf16"]
    shape = H.shape
    Hi = torch.randint(-2, 3, shape, device="cuda", generator=gen).bfloat16()
    Ti = torch.randint(-2, 3, (*shape[:-1], D), device="cuda", generator=gen).bfloat16()
    G, R = fn(Hi, Ti)
    Gr, Rr = ref.gram_ref(Hi, Ti)
    assert torch.equal(G, Gr) and torch.equal(R, Rr)


@pytest.mark.parametrize("kind", ["gram_tri", "gram_dense"])
def test_gram_bf16_wgmma_reads_t_off_16_bytes_from_a_copy(gen, kind):
    """T off 16 bytes with D % 8 == 0: the tensor-core body fills its buffer
    with T and still agrees."""
    m, N, L, D = 2, 100, 136, 8
    shape = (N, L) if kind == "gram_dense" else (m, N, L)
    H = (torch.randn(*shape, device="cuda", generator=gen) / L**0.5).bfloat16()
    T = _off16((*shape[:-1], D), torch.bfloat16, gen)
    G, R = getattr(kernel, kind)(H, T)
    torch.cuda.synchronize()
    assert kernel.LAST_GRAM == {"kernel": kind, "body": "wgmma"}
    Gr, Rr = ref.gram_ref(H, T)
    assert _rel(G, Gr) <= TOL["bf16"] and _rel(R, Rr) <= TOL["bf16"]


def test_gram_wgmma_entries_refuse_what_tma_cannot_read(gen):
    """The C entries refuse H read in place where L % 8 != 0, an H off 16
    bytes read in place, and T read in place where its rows are not a
    multiple of 8 values, before they launch anything."""
    lib = kernel.library()
    stream = torch.cuda.current_stream().cuda_stream
    G = torch.empty(2, 16, 16, device="cuda")
    R = torch.empty(2, 16, 3, device="cuda")
    T = torch.zeros(2, 8, 3, dtype=torch.bfloat16, device="cuda")
    Tp = kernel.t_buffer(T)
    unpadded = torch.zeros(2, 8, 12, dtype=torch.bfloat16, device="cuda")
    off16 = _off16((2, 8, 16), torch.bfloat16, gen)
    aligned = torch.zeros(2, 8, 16, dtype=torch.bfloat16, device="cuda")
    cases = [(unpadded, unpadded, Tp), (off16, off16, Tp), (aligned, aligned, T)]
    for H, Hp, buf in cases:
        m, N, L = H.shape
        assert lib.gram_tri_bf16_wgmma(H.data_ptr(), Hp.data_ptr(), T.data_ptr(),
                                       buf.data_ptr(), G.data_ptr(), R.data_ptr(),
                                       m, N, L, 3, stream) != 0
        assert lib.gram_dense_bf16_wgmma(H.data_ptr(), Hp.data_ptr(), T.data_ptr(),
                                         buf.data_ptr(), G.data_ptr(), R.data_ptr(),
                                         N, L, 3, stream) != 0
    torch.cuda.synchronize()


@pytest.mark.parametrize("kind", ["gram_tri", "gram_dense"])
def test_gram_bf16_launch_failure_raises(gen, monkeypatch, kind):
    """No fallback: a launch of the tensor-core body that fails raises, and
    nothing runs the FMA body in its place."""
    class Refusing:
        def __getattr__(self, name):
            if name.endswith("_wgmma"):
                return lambda *args: 1     # cudaErrorInvalidValue
            raise AssertionError(f"{name} called after the body was chosen")

    H, T, fn = _gram_bf16(kind, 2, 64, 128, 3, gen)
    monkeypatch.setattr(kernel, "library", lambda: Refusing())
    before = kernel.LAUNCHES[kind]
    with pytest.raises(RuntimeError, match=f"{kind} launch failed"):
        fn(H, T)
    assert kernel.LAUNCHES[kind] == before


def test_cuda_ops_launch_and_never_take_the_plain_version(gen):
    """Every op on CUDA tensors counts one launch of its kernel; the int8
    op's kernel agrees with its emulation on the same draws."""
    H = torch.randn(2, 300, 200, device="cuda", generator=gen) / 300**0.5
    T = torch.randn(2, 300, 3, device="cuda", generator=gen)
    kernel.reset_launches()
    G, R = ops.gram_batched(H, T, precision="int8", quant_seed=5)
    Ge, Re = ops.gram_batched(H, T, precision="int8", quant_seed=5,
                              force_ref=True)
    ops.gram(H[0], T[0], variant="dense")
    ops.gram(H[0], T[0], variant="dense", precision="bf16")
    ops.gram(H[0], T[0], precision="int8", block_l=32, block_n=64)
    torch.cuda.synchronize()
    assert kernel.LAUNCHES == {"gram_tri": 0, "gram_fused": 0,
                               "gram_tri_q": 2, "gram_dense": 2}
    assert _rel(G, Ge) <= TOL["fp32"] and _rel(R, Re) <= TOL["fp32"]


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
    Hq = torch.zeros(2, 8, 16, dtype=torch.int8, device="cuda")
    s = torch.ones(2, 1, 1, device="cuda")
    T = torch.zeros(2, 8, 3, dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="block_n"):
        kernel.gram_tri_q(Hq, s, T, block_n=2048, block_l=16)
    with pytest.raises(ValueError, match="shapes do not agree"):
        kernel.gram_tri_q(Hq, s, T, block_n=8, block_l=8)
    with pytest.raises(ValueError, match="dtype"):
        kernel.gram_tri_q(Hq, s, T.float(), block_n=8, block_l=16)
    with pytest.raises(ValueError, match="2-D"):
        kernel.gram_dense(H, H)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("B,H,KV,S,D,W", [
    (2, 4, 2, 1000, 64, 100),    # ragged S, a window of two tiles
    (1, 4, 1, 77, 120, 5),       # MQA, D = 120, W below the kv tile
    (1, 2, 2, 33, 256, 1000),    # D = 256 (148 KB of shared memory), W > S
    (1, 1, 1, 1, 1, 1),
])
def test_swa_matches_plain(gen, B, H, KV, S, D, W, precision):
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    q = torch.randn(B, H, S, D, device="cuda", generator=gen).to(dtype)
    k = torch.randn(B, KV, S, D, device="cuda", generator=gen).to(dtype)
    v = torch.randn(B, KV, S, D, device="cuda", generator=gen).to(dtype)
    before = swa_kernel.LAUNCHES["swa"]
    o = swa_kernel.swa(q, k, v, W)
    torch.cuda.synchronize()
    assert swa_kernel.LAUNCHES["swa"] == before + 1
    assert o.dtype == dtype and torch.isfinite(o.float()).all()
    plain = swa_ref(q, k, v, W).float()
    assert _rel(o.float(), plain) <= TOL[precision]
    assert _norm_rel(o.float(), plain) <= SWA_NORM_TOL[precision]
    # the op launches the same kernel on the same inputs
    assert torch.equal(swa_ops.swa_attention(q, k, v, window=W), o)


@pytest.mark.parametrize("H,KV", [(4, 1), (8, 2)])    # MQA, H / KV = 4
@pytest.mark.parametrize("D", [1, 64, 120, 256])
# W: 1; the kv tiles (32 keys at D = 256, else 64) and one more; W > S
@pytest.mark.parametrize("W", [1, 33, 64, 65, 1000])
@pytest.mark.parametrize("S", [63, 65])               # the 64-row tiles +- 1
def test_swa_bf16_at_the_tile_edges(gen, S, W, D, H, KV):
    """The bf16 kernel (64 query rows and 64 keys a tile) at the edges of
    its tiles and of the band, against the plain version in max and in
    norm; the op launches the same kernel."""
    q = torch.randn(2, H, S, D, device="cuda", generator=gen).bfloat16()
    k = torch.randn(2, KV, S, D, device="cuda", generator=gen).bfloat16()
    v = torch.randn(2, KV, S, D, device="cuda", generator=gen).bfloat16()
    before = swa_kernel.LAUNCHES["swa"]
    o = swa_kernel.swa(q, k, v, W)
    torch.cuda.synchronize()
    assert swa_kernel.LAUNCHES["swa"] == before + 1
    assert o.dtype == torch.bfloat16 and torch.isfinite(o.float()).all()
    plain = swa_ref(q, k, v, W).float()
    assert _rel(o.float(), plain) <= TOL["bf16"]
    assert _norm_rel(o.float(), plain) <= SWA_NORM_TOL["bf16"]
    assert torch.equal(swa_ops.swa_attention(q, k, v, window=W), o)


@pytest.mark.parametrize("D", [64, 120])
def test_swa_bf16_takes_views_off_16_bytes(gen, D):
    """q, k and v off 16 bytes: the bf16 kernel stages rows with plain
    loads, not cp.async (which would fault), and still matches."""
    B, H, KV, S, W = 1, 4, 2, 130, 40
    q = _off16((B, H, S, D), torch.bfloat16, gen)
    k = _off16((B, KV, S, D), torch.bfloat16, gen)
    v = _off16((B, KV, S, D), torch.bfloat16, gen)
    o = swa_kernel.swa(q, k, v, W)
    torch.cuda.synchronize()
    plain = swa_ref(q, k, v, W).float()
    assert _rel(o.float(), plain) <= TOL["bf16"]
    assert _norm_rel(o.float(), plain) <= SWA_NORM_TOL["bf16"]


@pytest.mark.parametrize("B,S,D", [
    (3, 1000, 300), (2, 17, 130), (1, 1, 1), (2, 4096, 256),
    (2, 4099, 2560),      # the route's width; S not a multiple of a 16-step slice
    (1, 129, 100),        # D not a multiple of the 64-channel block, 16-byte copies
    (2, 40, 66),          # D % 4 != 0: 4-byte copies, a ragged last block
])
def test_rglru_matches_plain(gen, B, S, D):
    log_a = -torch.nn.functional.softplus(
        torch.randn(B, S, D, device="cuda", generator=gen))
    b = torch.randn(B, S, D, device="cuda", generator=gen)
    h0 = torch.randn(B, D, device="cuda", generator=gen)
    before = rglru_kernel.LAUNCHES["rglru"]
    h = rglru_ops.rglru_scan(log_a, b, h0)
    torch.cuda.synchronize()
    assert rglru_kernel.LAUNCHES["rglru"] == before + 1
    assert _rel(h, rglru_scan_ref(log_a, b, h0)) <= TOL["fp32"]


def test_rglru_takes_views_off_16_bytes(gen):
    """Inputs that start 4 bytes past 16 take the 4-byte copies."""
    B, S, D = 2, 100, 128
    buf = torch.randn(2, B * S * D + 1, device="cuda", generator=gen)
    buf[0] = -torch.nn.functional.softplus(buf[0])
    log_a, b = (buf[x, 1:].view(B, S, D) for x in range(2))
    h0 = torch.randn(B, D, device="cuda", generator=gen)
    assert log_a.data_ptr() % 16 != 0
    h = rglru_kernel.rglru(log_a, b, h0)
    torch.cuda.synchronize()
    assert _rel(h, rglru_scan_ref(log_a, b, h0)) <= TOL["fp32"]


def test_swa_and_rglru_refuse_grad_and_mixed_devices(gen):
    q = torch.randn(1, 2, 8, 16, device="cuda", generator=gen)
    before = (swa_kernel.LAUNCHES["swa"], rglru_kernel.LAUNCHES["rglru"])
    with pytest.raises(RuntimeError, match="forward-only"):
        swa_kernel.swa(q.clone().requires_grad_(), q, q, 4)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        swa_kernel.swa(q, q.cpu(), q, 4)
    with pytest.raises(ValueError, match="head_dim|D <= 256"):
        big = torch.zeros(1, 1, 4, 264, device="cuda")
        swa_kernel.swa(big, big, big, 4)
    a = torch.zeros(1, 8, 16, device="cuda")
    with pytest.raises(RuntimeError, match="forward-only"):
        rglru_kernel.rglru(a.clone().requires_grad_(), a, a[:, 0])
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        rglru_kernel.rglru(a, a.cpu(), a[:, 0])
    with pytest.raises(ValueError, match="dtype"):
        rglru_kernel.rglru(a.double(), a.double(), a[:, 0].double())
    assert (swa_kernel.LAUNCHES["swa"],
            rglru_kernel.LAUNCHES["rglru"]) == before


def _mlstm_inputs(gen, B, H, S, D, dtype, log_f=None, i_shift=0.0):
    q, k, v = (torch.randn(B, H, S, D, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    if log_f is None:
        f = torch.nn.functional.logsigmoid(
            torch.randn(B, H, S, device="cuda", generator=gen) + 2.0)
    else:
        f = torch.full((B, H, S), log_f, device="cuda")
    i = torch.randn(B, H, S, device="cuda", generator=gen) + i_shift
    return q, k, v, f, i


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("B,H,S,D,chunk", [
    (2, 2, 1000, 64, 256),       # ragged S: the last chunk holds 232 steps
    (1, 2, 100, 80, 40),         # D = 80 not a multiple of the 64 tile
    (1, 1, 70, 16, 8),           # chunks below the 32-step slice
    (1, 1, 1, 16, 4),            # one step
    (1, 2, 300, 1024, 64),       # the route's D
    (2, 1, 77, 32, 256),         # one chunk, shorter than the chunk size
    (1, 2, 300, 80, 40),         # D^-1/2 not a power of two, several chunks
    (1, 2, 1, 1024, 256),        # one step at the route's D
    (1, 1, 37, 32, 4),           # chunks of 4, a ragged tail
])
def test_mlstm_matches_plain(gen, B, H, S, D, chunk, precision):
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    q, k, v, f, i = _mlstm_inputs(gen, B, H, S, D, dtype)
    before = mlstm_kernel.LAUNCHES["mlstm"]
    h = mlstm_kernel.mlstm(q, k, v, f, i, chunk)
    torch.cuda.synchronize()
    assert mlstm_kernel.LAUNCHES["mlstm"] == before + 1
    # bf16 on the tensor cores, each fp32 operand in two bf16 terms or
    # more; fp32 on the CUDA cores
    ran = mlstm_kernel.LAST_MLSTM
    assert ran["dtype"] == precision
    if precision == "bf16":
        assert ran["body"] == "mma" and min(ran["terms"].values()) >= 2
    else:
        assert ran["body"] == "fma" and not any(ran["terms"].values())
    assert h.dtype == torch.float32 and torch.isfinite(h).all()
    plain = mlstm_chunkwise_ref(q, k, v, f, i, chunk)
    assert _rel(h, plain) <= TOL["fp32"]
    assert _norm_rel(h, plain) <= MLSTM_NORM_TOL
    # the op launches the same kernel on the same inputs
    assert torch.equal(mlstm_ops.mlstm_chunkwise(q, k, v, f, i, chunk=chunk),
                       h)


def test_mlstm_long_memory_and_negative_input_gates(gen):
    """Long memory against the step-by-step oracle and across chunk sizes;
    i ~ -100, where e^{-m} overflows: h is exactly 0, with no NaN."""
    q, k, v, f, i = _mlstm_inputs(gen, 1, 2, 512, 64, torch.float32,
                                  log_f=-0.01)
    h = mlstm_kernel.mlstm(q, k, v, f, i, 64)
    seq = mlstm_sequential_ref(q, k, v, f, i)
    assert _rel(h, seq) <= TOL["fp32"] and _norm_rel(h, seq) <= MLSTM_NORM_TOL
    assert _norm_rel(mlstm_kernel.mlstm(q, k, v, f, i, 512), h) <= \
        MLSTM_NORM_TOL
    q, k, v, f, i = _mlstm_inputs(gen, 1, 2, 300, 64, torch.float32,
                                  i_shift=-100.0)
    h = mlstm_kernel.mlstm(q, k, v, f, i, 64)
    assert not h.any() and not mlstm_chunkwise_ref(q, k, v, f, i, 64).any()


def test_mlstm_bf16_takes_views_off_16_bytes(gen):
    """bf16 q, k, v that start 2 bytes past 16 are copied onto 16 bytes
    before the tensor-core body stages their rows."""
    B, H, S, D = 1, 2, 200, 64
    buf = torch.randn(3, B * H * S * D + 1, device="cuda",
                      generator=gen).bfloat16()
    q, k, v = (buf[x, 1:].view(B, H, S, D) for x in range(3))
    _, _, _, f, i = _mlstm_inputs(gen, B, H, S, D, torch.bfloat16)
    assert q.data_ptr() % 16 != 0
    h = mlstm_kernel.mlstm(q, k, v, f, i, 64)
    torch.cuda.synchronize()
    assert mlstm_kernel.LAST_MLSTM["body"] == "mma"
    plain = mlstm_chunkwise_ref(q, k, v, f, i, 64)
    assert _rel(h, plain) <= TOL["fp32"]
    assert _norm_rel(h, plain) <= MLSTM_NORM_TOL


def test_mlstm_refuses_what_the_kernel_does_not_take(gen):
    q, k, v, f, i = _mlstm_inputs(gen, 1, 1, 8, 16, torch.float32)
    before = mlstm_kernel.LAUNCHES["mlstm"]
    with pytest.raises(ValueError, match="multiple of 16"):
        x = torch.zeros(1, 1, 8, 40, device="cuda")
        mlstm_kernel.mlstm(x, x, x, f, i, 4)
    with pytest.raises(ValueError, match="multiple of 16"):
        x = torch.zeros(1, 1, 8, 1040, device="cuda")
        mlstm_kernel.mlstm(x, x, x, f, i, 4)
    with pytest.raises(ValueError, match="dtype"):
        mlstm_kernel.mlstm(q, k.bfloat16(), v, f, i, 4)
    with pytest.raises(ValueError, match="dtype"):
        mlstm_kernel.mlstm(q, k, v, f.bfloat16(), i, 4)
    with pytest.raises(ValueError, match="shapes do not agree"):
        mlstm_kernel.mlstm(q, k, v, f[..., :4].contiguous(), i, 4)
    with pytest.raises(ValueError, match="CPU or all on one CUDA"):
        mlstm_kernel.mlstm(q, k, v, f.cpu(), i, 4)
    with pytest.raises(RuntimeError, match="forward-only"):
        mlstm_kernel.mlstm(q.clone().requires_grad_(), k, v, f, i, 4)
    assert mlstm_kernel.LAUNCHES["mlstm"] == before


@pytest.mark.parametrize("executor", [{}, dict(executor="colored",
                                               staleness=2)])
@pytest.mark.parametrize("graph", ["ring", "star"])
def test_checkpointed_fit_resumes_bitwise_on_the_card(gen, tmp_path, graph,
                                                      executor):
    """Stopped at 4 and resumed to 10, the fit on the card equals the
    uninterrupted one bit for bit: the Gram kernel, the PCG solves and the
    fixed-order segment sums (star(6)'s hub adds 5 terms) repeat their
    bits."""
    from repro_torch.core import dmtl_elm, engine
    from repro_torch.core import graph as graphs

    g = graphs.ring(5) if graph == "ring" else graphs.star(6)
    H = torch.randn(g.m, 300, 96, device="cuda", generator=gen) / 96**0.5
    T = torch.randn(g.m, 300, 3, device="cuda", generator=gen)
    cfg = engine.ConsensusConfig(r=2, iters=10, tau=2.0, zeta=1.0,
                                 u_solver="pcg")
    before = kernel.LAUNCHES["gram_tri"]
    st0, d0 = dmtl_elm.fit(H, T, g, cfg, **executor)
    assert kernel.LAUNCHES["gram_tri"] == before + 1
    kw = dict(executor, checkpoint_dir=tmp_path, checkpoint_every=3)
    dmtl_elm.fit(H, T, g, engine.ConsensusConfig(
        r=2, iters=4, tau=2.0, zeta=1.0, u_solver="pcg"), **kw)
    st, d = dmtl_elm.fit(H, T, g, cfg, resume=True, **kw)
    for a, b in zip(st, st0):
        assert a.is_cuda and torch.equal(a, b)
    assert set(d) == set(d0)
    for key in d0:
        assert torch.equal(d[key], d0[key]), key


def test_traced_fit_on_the_card(gen, tmp_path):
    import json

    from repro_torch import obs
    from repro_torch.core import dmtl_elm, engine
    from repro_torch.core import graph as graphs

    g = graphs.ring(6)
    H = torch.randn(6, 256, 64, device="cuda", generator=gen) / 8.0
    T = torch.randn(6, 256, 2, device="cuda", generator=gen)
    cfg = engine.ConsensusConfig(r=2, iters=9, tau=2.0, zeta=1.0)
    before = kernel.LAUNCHES["gram_tri"]
    _, d = dmtl_elm.fit(H, T, g, cfg, telemetry=True,
                        trace_dir=tmp_path / "t",
                        checkpoint_dir=tmp_path / "c", checkpoint_every=3)
    assert kernel.LAUNCHES["gram_tri"] == before + 1
    assert obs.validate_trace(tmp_path / "t" / "trace.json") == 7
    names = [e["name"] for e in json.loads(
        (tmp_path / "t" / "trace.json").read_text())["traceEvents"]]
    assert (names.count("stats"), names.count("segment"),
            names.count("snapshot")) == (1, 3, 3)
    report = json.loads((tmp_path / "t" / "report.json").read_text())
    assert report["health"]["healthy"]
    assert bool((d["msgs_delivered"] == 2 * g.n_edges).all())
    assert bool((d["comm_floats"] == obs.modeled_floats_per_iter(
        "dense", L=64, r=2, n_edges=g.n_edges)).all())


def _async_problem(gen, g, L=96, N=300):
    from repro_torch.core import engine

    H = torch.randn(g.m, N, L, device="cuda", generator=gen) / L**0.5
    T = torch.randn(g.m, N, 3, device="cuda", generator=gen)
    return H, T, engine.produce_stats(H, T)


@pytest.mark.parametrize("aged", [False, True])
@pytest.mark.parametrize("graph", ["ring", "star"])
def test_async_identities_on_the_card(gen, graph, aged):
    """On the card, bit for bit: the zero-delay tape is ``fit_dense``, and
    a zero-attack ``AdversaryTape`` its base channel tape (state and every
    diagnostics row, telemetry on)."""
    from repro_torch import netsim
    from repro_torch.core import engine
    from repro_torch.core import graph as graphs

    g = graphs.ring(5) if graph == "ring" else graphs.star(6)
    _, _, st = _async_problem(gen, g)
    cfg = engine.ConsensusConfig(r=2, iters=10, tau=2.0, zeta=1.0,
                                 telemetry=True)
    dense = engine.fit_dense(st, g, cfg)
    got = engine.fit_async(st, g, cfg, netsim.zero_delay_tape(10, g),
                           aged_duals=aged)
    for a, b in zip(got[0], dense[0]):
        assert a.is_cuda and torch.equal(a, b)
    for key in dense[1]:
        assert torch.equal(got[1][key], dense[1][key]), key
    base = netsim.ChannelModel(delay="geometric", scale=1.5, drop=0.2,
                               straggler_prob=0.2, seed=2).sample(g, 10)
    want = engine.fit_async(st, g, cfg, base, aged_duals=aged)
    got = engine.fit_async(st, g, cfg, netsim.AdversaryModel().sample(
        g, 10, L=96, r=2, base=base), aged_duals=aged)
    for a, b in zip(got[0], want[0]):
        assert torch.equal(a, b)
    for key in want[1]:
        assert torch.equal(got[1][key], want[1][key]), key


@pytest.mark.parametrize("aggregator", ["mean", "coordinate_median"])
def test_async_checkpointed_fit_resumes_bitwise_on_the_card(gen, tmp_path,
                                                            aggregator):
    """An aged-duals async fit on a sign-flip + churn tape, stopped after
    its first segment and resumed, equals the uninterrupted fit bit for
    bit on the card."""
    from repro_torch import checkpoint, netsim
    from repro_torch.core import dmtl_elm, engine
    from repro_torch.core import graph as graphs

    g = graphs.star(6)
    H, T, st = _async_problem(gen, g)
    cfg = engine.ConsensusConfig(r=2, iters=10, tau=2.0, zeta=1.0,
                                 aggregator=aggregator)
    base = netsim.ChannelModel(delay="geometric", scale=1.0, drop=0.2,
                               seed=3).sample(g, 10)
    tape = netsim.AdversaryModel(n_byzantine=1, kinds=("sign_flip",),
                                 churn=((2, 3, 7),), seed=1).sample(
        g, 10, L=96, r=2, base=base)
    kw = dict(executor="async", tape=tape, aged_duals=True)
    before = kernel.LAUNCHES["gram_tri"]
    want = dmtl_elm.fit(H, T, g, cfg, **kw)
    assert kernel.LAUNCHES["gram_tri"] == before + 1
    runner = engine.make_runner(st, g, cfg, **kw)
    state, diags = runner.run_segment(runner.init_state(), 4)
    checkpoint.save_run_checkpoint(tmp_path, state, diags,
                                   metadata={"executor": "async",
                                             "iters": 10})
    got = dmtl_elm.fit(H, T, g, cfg, checkpoint_dir=tmp_path,
                       checkpoint_every=3, resume=True, **kw)
    for a, b in zip(got[0], want[0]):
        assert a.is_cuda and torch.equal(a, b)
    for key in want[1]:
        assert torch.equal(got[1][key], want[1][key]), key


def test_async_robust_aggregators_and_counters_on_the_card(gen):
    """Every aggregator runs on the card under a sign-flip + churn tape,
    finite with every key; deliveries add up to 2E every tick; and the
    executor adds no host sync to a tick beyond those of the update body
    (the dense executor's per iteration: the r x r eigh and solve check
    their status on the host); a segment's tape upload syncs once an
    array, whatever its length."""
    import warnings

    from repro_torch import netsim
    from repro_torch.core import engine
    from repro_torch.core import graph as graphs

    g = graphs.hypercube(3)
    _, _, st = _async_problem(gen, g)
    cfg = engine.ConsensusConfig(r=2, iters=8, tau=2.0, zeta=1.0,
                                 telemetry=True)
    tape = netsim.AdversaryModel(n_byzantine=1, kinds=("sign_flip",),
                                 churn=((5, 2, 6),), seed=0).sample(
        g, 8, L=96, r=2)
    for agg in ("mean", "trimmed_mean", "coordinate_median", "krum_like"):
        state, diags = engine.fit_async(
            st, g, dataclasses.replace(cfg, aggregator=agg), tape,
            aged_duals=True)
        assert torch.isfinite(state.U).all(), agg
        assert all(torch.isfinite(v.double()).all() for v in diags.values())
        total = (diags["msgs_delivered"] + diags["msgs_stale"]
                 + diags["msgs_dropped"])
        assert bool((total == 2 * g.n_edges).all()), agg
        if agg != "mean":
            assert float(diags["agg_rejected"].sum()) > 0, agg

    def syncs(runner, n):
        state = runner.init_state()
        runner.run_segment(state, n)    # the libraries' first-call syncs
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                runner.run_segment(state, n)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return sum("synchroniz" in str(w.message) for w in caught)

    cfg = dataclasses.replace(cfg, aggregator="coordinate_median")
    dense = engine.make_runner(st, g, cfg)
    runner = engine.make_runner(st, g, cfg, executor="async", tape=tape,
                                aged_duals=True)
    syncs(dense, 2)     # takes the one sync of torch's first measurement
    per_tick = (syncs(runner, 8) - syncs(runner, 2)) / 6
    per_iteration = (syncs(dense, 8) - syncs(dense, 2)) / 6
    assert per_tick == per_iteration, (per_tick, per_iteration)


def test_sharded_world_of_two_ranks_on_the_card(gen):
    """``repro_torch.core.mesh.spawn`` puts two ranks on the card over gloo
    (NCCL refuses two ranks on one device): each reduces its own rows with
    one ``gram_tri`` launch, and ring(2) (torus path), a flipped ring(2)
    and chain(2) (compiled path) agree with ``fit_dense`` on the card."""
    import numpy as np

    import torch_sharded_worlds as worlds
    from repro_torch.core import engine, graph
    from repro_torch.core.mesh import spawn

    rng = np.random.default_rng(0)
    inp = {"H": (rng.standard_normal((2, 512, 64)) / 8).astype(np.float32),
           "T": rng.standard_normal((2, 512, 3)).astype(np.float32),
           "cfg": engine.ConsensusConfig(r=1, iters=8, tau=2.0, zeta=1.0)}
    res = spawn(worlds.cuda_pair, 2, device="cuda", timeout_s=300,
                args=(inp,))
    st = engine.sufficient_stats(torch.as_tensor(inp["H"], device="cuda"),
                                 torch.as_tensor(inp["T"], device="cuda"))
    state, diags = engine.fit_dense(st, graph.ring(2), inp["cfg"])
    for r in res:
        assert r["transport"] == "gloo via host"
        assert r["device"].startswith("cuda")
        assert r["launches"]["gram_tri"] == 1
        for name in ("ring2", "flipped", "chain2"):
            torch.testing.assert_close(r[name]["U"], state.U.cpu(),
                                       rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(r[name]["A"], state.A.cpu(),
                                       rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(r[name]["objective"],
                                       diags["objective"].cpu(),
                                       rtol=1e-4, atol=1e-5)


# --- the serving path on the card ---------------------------------------------

SERVING_SMOKE = {"recurrentgemma-2b": {"n_layers": 5}, "h2o-danube-3-4b": {},
                 "xlstm-1.3b": {}}


def _serving_model(name):
    from repro_torch import configs
    from repro_torch.models import transformer

    cfg = dataclasses.replace(configs.get_smoke_config(name),
                              **SERVING_SMOKE[name])
    return cfg, transformer.init_model(
        torch.Generator(device="cuda").manual_seed(0), cfg)


def _greedy_rows(params, cfg, prompt, max_new, max_len):
    """Batch-1 greedy decoding with fp32 caches, as ``generate`` runs it:
    (the tokens, the (1, vocab) logits each was taken from)."""
    from repro_torch.models import transformer

    lg, cache = transformer.prefill(params, cfg, prompt, max_len,
                                    cache_dtype=torch.float32)
    toks, rows = [], []
    for i in range(max_new):
        if i:
            lg, cache = transformer.decode_step(
                params, cfg, torch.tensor([[toks[-1]]], device=lg.device),
                cache)
        rows.append(lg[:, -1])
        toks.append(int(lg[0, -1].argmax()))
    return toks, rows


def _reset_serving_launches():
    for w in (swa_kernel, rglru_kernel, mlstm_kernel):
        w.reset_launches()


def _serving_launches():
    return (swa_kernel.LAUNCHES["swa"], rglru_kernel.LAUNCHES["rglru"],
            mlstm_kernel.LAUNCHES["mlstm"])


@pytest.mark.parametrize("name", list(SERVING_SMOKE))
def test_prefill_and_decode_launch_the_kernels(gen, name):
    """Prefill (S = 40, past the window of 16) and 6 decode steps with the
    kernels against ``use_kernel=False`` on the card, fp32 (1e-4 of max
    |plain|); prefill launches ``swa``, ``rglru`` and ``mlstm`` once per
    block of their kind, each decode step ``rglru`` once per RG-LRU block
    and nothing else."""
    from repro_torch.models import transformer

    cfg, params = _serving_model(name)
    kinds = cfg.layer_kinds()
    tokens = torch.randint(0, cfg.vocab_size, (2, 40), device="cuda",
                           generator=gen)
    _reset_serving_launches()
    lg, cache = transformer.prefill(params, cfg, tokens, 48,
                                    cache_dtype=torch.float32)
    assert _serving_launches() == (kinds.count("swa"), kinds.count("rglru"),
                                   kinds.count("mlstm"))
    lg_p, cache_p = transformer.prefill(params, cfg, tokens, 48,
                                        cache_dtype=torch.float32,
                                        use_kernel=False)
    assert _serving_launches() == (kinds.count("swa"), kinds.count("rglru"),
                                   kinds.count("mlstm"))
    assert _rel(lg, lg_p) <= TOL["fp32"]
    for step in range(6):
        nt = lg[:, -1].argmax(-1, keepdim=True)
        _reset_serving_launches()
        lg, cache = transformer.decode_step(params, cfg, nt, cache)
        assert _serving_launches() == (0, kinds.count("rglru"), 0)
        lg_p, cache_p = transformer.decode_step(params, cfg, nt, cache_p,
                                                use_kernel=False)
        assert _rel(lg, lg_p) <= TOL["fp32"], step
    assert cache["pos"].tolist() == [46, 46]


def test_engine_on_the_card_matches_generate(gen):
    """The continuous-batching engine (3 slots, 5 ragged requests, fp32
    caches) on the card with the kernels against ``use_kernel=False``: the
    same tokens and logits within 1e-4; and each request's tokens equal its
    batch-1 ``generate``'s, its logits within 1e-4.  The kernel run
    launched ``swa`` once per swa block a prefill and ``rglru`` once per
    RG-LRU block a prefill and a decode step; the plain run nothing."""
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request
    from repro_torch.serving.steps import generate

    cfg, params = _serving_model("recurrentgemma-2b")
    kinds = cfg.layer_kinds()
    prompts = [torch.randint(0, cfg.vocab_size, (9 + 7 * i,), device="cuda",
                             generator=gen) for i in range(5)]
    runs = {}
    for use_kernel in (True, False):
        reqs = [Request(rid=i, prompt=p, max_new=3 + i % 3, logits=[])
                for i, p in enumerate(prompts)]
        eng = ContinuousBatchingEngine(params, cfg, batch_slots=3,
                                       max_len=48, cache_dtype=torch.float32,
                                       use_kernel=use_kernel)
        for r in reqs:
            eng.submit(r)
        _reset_serving_launches()
        stats = eng.run()
        assert stats.completed == 5
        launches = (kinds.count("swa") * stats.prefills,
                    kinds.count("rglru") * (stats.prefills + stats.steps), 0)
        assert _serving_launches() == (launches if use_kernel else (0, 0, 0))
        runs[use_kernel] = reqs
    for r, r_plain, p in zip(runs[True], runs[False], prompts):
        assert r.output == r_plain.output
        for got, want in zip(r.logits, r_plain.logits):
            assert _rel(got, want) <= TOL["fp32"]
        want, rows = _greedy_rows(params, cfg, p[None], r.max_new, 48)
        assert r.output == want
        assert want == generate(params, cfg, p[None], r.max_new, 48,
                                cache_dtype=torch.float32)[0][0].tolist()
        for got, row in zip(r.logits, rows):
            assert _rel(got, row[0]) <= TOL["fp32"]


def test_rglru_block_from_a_carried_state_on_the_card(gen):
    """One RG-LRU block over 2 x 33 steps at once against 20 steps and then,
    from the carried state, 13 more and one at a time, with the kernel."""
    from repro_torch.models import rglru

    cfg, params = _serving_model("recurrentgemma-2b")
    p = params["layers"][0]["rglru"]
    x = torch.randn(2, 33, cfg.d_model, device="cuda", generator=gen)
    whole, st_whole = rglru.rglru_block(p, cfg, x)
    first, st = rglru.rglru_block(p, cfg, x[:, :20])
    outs = [first]
    for t in range(20, 33):
        o, st = rglru.rglru_block(p, cfg, x[:, t:t + 1], st)
        outs.append(o)
    assert _rel(torch.cat(outs, 1), whole) <= TOL["fp32"]
    assert _rel(st.h, st_whole.h) <= TOL["fp32"]


# --- the MoE kind, prefix embeddings and encoder-decoders on the card -------

@pytest.mark.parametrize("precision", ["fp32", "bf16"])
@pytest.mark.parametrize("cf", [4.0, 0.5])
def test_moe_ffn_matches_by_expert_on_the_card(gen, cf, precision):
    """``moe_ffn`` (scatter into (E, C) buffers, one batched product over
    experts, gather) against the per-expert loop on the same routing,
    drop-free and with drops: 1e-4 of max in fp32, 3e-2 in bf16 and 1e-2
    in norm (the two run their products at other shapes)."""
    from repro_torch import configs
    from repro_torch.models import moe

    cfg = dataclasses.replace(
        configs.get_smoke_config("qwen3-moe-30b-a3b"), d_model=256,
        moe_d_ff=128, n_experts=16, n_experts_active=4, capacity_factor=cf)
    params = moe.moe_init(gen, cfg)
    dtype = torch.float32 if precision == "fp32" else torch.bfloat16
    x = torch.randn(2, 64, cfg.d_model, device="cuda", generator=gen)
    x = x.to(dtype)
    got, aux = moe.moe_ffn(params, cfg, x)
    want, aux_e = moe.moe_ffn_by_expert(params, cfg, x)
    assert got.dtype == dtype and float(aux) == float(aux_e)
    assert _rel(got.float(), want.float()) <= TOL[precision]
    if precision == "bf16":
        assert _norm_rel(got.float(), want.float()) <= 1e-2
    keep = moe._route(params, cfg, x)[2]
    assert bool(keep.all()) == (cf == 4.0)


@pytest.mark.parametrize("name", ["granite-moe-3b-a800m", "qwen3-moe-30b-a3b",
                                  "llava-next-34b", "seamless-m4t-large-v2"])
def test_smoke_decode_matches_forward_on_the_card(gen, name):
    """Each smoke config on the card, fp32 caches: prefill (with its prefix
    or frame embeddings) and 4 greedy decode steps, each step's logits
    against the forward over the whole sequence (1e-4 of max); none of
    these paths launches a kernel."""
    from repro_torch import configs
    from repro_torch.models import transformer

    cfg = configs.get_smoke_config(name)
    params = transformer.init_model(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    tokens = torch.randint(0, cfg.vocab_size, (2, 20), device="cuda",
                           generator=gen)
    kw = {}
    if cfg.family == "vlm":
        kw["prefix_embeds"] = torch.randn(2, cfg.n_prefix_embeddings,
                                          cfg.d_model, device="cuda",
                                          generator=gen)
    if cfg.is_encdec:
        kw["enc_embeds"] = torch.randn(2, cfg.enc_seq, cfg.d_model,
                                       device="cuda", generator=gen)
    P = kw["prefix_embeds"].shape[1] if "prefix_embeds" in kw else 0
    _reset_serving_launches()
    lg, cache = transformer.prefill(params, cfg, tokens, P + 24,
                                    cache_dtype=torch.float32, **kw)
    seq = tokens
    for _ in range(4):
        nt = lg[:, -1].argmax(-1, keepdim=True)
        lg, cache = transformer.decode_step(params, cfg, nt, cache)
        seq = torch.cat([seq, nt], dim=1)
        full, _ = transformer.forward(params, cfg, seq, **kw)
        assert _rel(lg[:, 0], full[:, -1]) <= TOL["fp32"]
    assert cache["pos"].tolist() == [P + 24] * 2
    assert _serving_launches() == (0, 0, 0)
