"""ctypes wrappers of the CUDA Gram kernels in ``csrc/gram.cu``.

``gram_tri``   replaces ``repro/kernels/gram/kernel.py::gram_pallas_tri``.
``gram_fused`` replaces ``repro/kernels/gram/kernel.py::gram_pallas_fused``.
``gram_tri_q`` replaces ``repro/kernels/gram/kernel.py::gram_pallas_tri_q``.
``gram_dense`` replaces ``repro/kernels/gram/kernel.py::gram_pallas``.

A wrapper given CPU tensors returns its kernel's plain version
(``ref.py``); given CUDA tensors it launches the kernel or raises.
``LAUNCHES`` counts kernel launches per wrapper call, and only those:
``gram_fused`` counts one per call, however many chunks (two grids each)
it runs.

``gram_fused`` computes the hidden layer once per call, a chunk of whole
sample rows of all m agents at a time, into a workspace that
``FUSED_WORKSPACE_BYTES`` bounds (``fused_chunks`` is the plan), then adds
each chunk's statistics into G and R; ``LAST_FUSED`` records what its last
call on the card launched.

``gram_tri`` and ``gram_dense`` run one body per dtype (``gram_body``):
fp32 the FMA body on the CUDA cores, bf16 the tensor-core body (TMA +
wgmma), which reads H and T from ``h_buffer`` and ``t_buffer``;
``LAST_GRAM`` records which body the last call on the card ran.

``gram_tri_q`` runs the int8 tensor-core body (TMA + int8 wgmma), which
takes its operands K-major: it first writes K-major copies of Hq and T
(``q_layout``, ``q_kmajor``; ``ref.q_kmajor_ref`` is their plain version)
into buffers of its own.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._common import check, on_cpu, raise_on, raw_stream
from repro_torch.kernels.gram.ref import (
    MAX_INT8_BLOCK_N,
    gram_fused_ref,
    gram_ref,
    gram_tri_q_ref,
    q_kmajor_ref,
)

SOURCE = Path(__file__).resolve().parent / "csrc" / "gram.cu"
ACTIVATION_CODES = {"sigmoid": 0, "tanh": 1, "relu": 2, "gelu": 3}
LAUNCHES = {"gram_tri": 0, "gram_fused": 0, "gram_tri_q": 0, "gram_dense": 0}
# gram_fused's hidden-layer workspace, m x rows x L in the compute dtype: at
# most this many bytes, whatever N (m 8, N 2048, L 2048 fp32 is 128 MiB, one
# chunk; N 8192 is two chunks in fp32 and one in bf16)
FUSED_WORKSPACE_BYTES = 256 * 2**20
# what the last gram_fused call on the card launched, counted where it
# launches: chunks, sample rows its hidden-layer grids covered (N when H is
# computed once), and its workspace's bytes
LAST_FUSED = {"chunks": 0, "hidden_rows": 0, "workspace_bytes": 0}
# which body the last gram_tri, gram_dense or gram_tri_q call on the card
# ran, recorded where it launches ("wgmma" or "fma", see gram_body)
LAST_GRAM = {"kernel": None, "body": None}

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


@functools.cache
def library() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (built and
    loaded once per process)."""
    lib = _build.load(SOURCE)
    lib.gram_tri_f32.argtypes = [_P] * 4 + [_I] * 4 + [_P]
    lib.gram_dense_f32.argtypes = [_P] * 4 + [_I] * 3 + [_P]
    # the tensor-core entries also take the buffers H and T are read from
    # (h_buffer, t_buffer)
    lib.gram_tri_bf16_wgmma.argtypes = [_P] * 6 + [_I] * 4 + [_P]
    lib.gram_dense_bf16_wgmma.argtypes = [_P] * 6 + [_I] * 3 + [_P]
    for fn in (lib.gram_tri_f32, lib.gram_dense_f32, lib.gram_tri_bf16_wgmma,
               lib.gram_dense_bf16_wgmma):
        fn.restype = _I
    for name in ("gram_fused_chunk_f32", "gram_fused_chunk_bf16"):
        fn = getattr(lib, name)
        fn.argtypes = [_P] * 7 + [_I] * 9 + [_P]
        fn.restype = _I
    for fn in (lib.gram_wgmma_smem_bytes, lib.gram_f32_smem_bytes):
        fn.argtypes = []
        fn.restype = _I
    # Hq, its K-major buffer, scales, T, its K-major buffer, G, R; m, N, L,
    # D, block_n, block_l, the stage and the padded block (q_layout)
    lib.gram_tri_q.argtypes = [_P] * 7 + [_I] * 8 + [_P]
    lib.gram_tri_q.restype = _I
    # Hq, Hk, T, Tk; m, N, L, D, block_n, the stage, the padded block
    lib.gram_q_kmajor.argtypes = [_P] * 4 + [_I] * 7 + [_P]
    lib.gram_q_kmajor.restype = _I
    lib.gram_q_smem_bytes.argtypes = []
    lib.gram_q_smem_bytes.restype = _I
    return lib


def _check_sizes(m, *dims):
    """The grid's agent axis is gridDim.y (at most 65535); every other size
    crosses the C interface as a 32-bit int."""
    if not (1 <= m <= 65535 and 1 <= min(dims) and max(dims) < 2**31):
        raise ValueError(
            f"Gram kernels need 1 <= m <= 65535 and every size in "
            f"[1, 2^31), got m={m}, sizes {dims}"
        )


def fused_workspace_width(L: int, precision: str) -> int:
    """Row width of gram_fused's workspace: L in fp32; in bf16 L rounded up
    to 8, so that every row starts on 16 bytes for the kernel's copies."""
    return L if precision == "fp32" else -(-L // 8) * 8


def fused_chunks(m: int, N: int, L: int, precision: str):
    """gram_fused's plan: [(n0, rows), ...], consecutive chunks covering the
    sample axis [0, N) in order, each the most rows whose hidden layer for
    all m agents (m x rows x ``fused_workspace_width`` in the compute dtype)
    fits ``FUSED_WORKSPACE_BYTES``; at least one row a chunk."""
    row_bytes = m * fused_workspace_width(L, precision) * (
        4 if precision == "fp32" else 2)
    rows = max(1, min(N, FUSED_WORKSPACE_BYTES // row_bytes))
    return [(n0, min(rows, N - n0)) for n0 in range(0, N, rows)]


def gram_body(dtype: torch.dtype) -> str:
    """The body a Gram launch of ``dtype`` runs: ``"wgmma"`` for bf16 and
    int8 (TMA copies into swizzled shared memory, wgmma on the tensor
    cores), ``"fma"`` for fp32 (IEEE fp32 FMAs on the CUDA cores, no
    TF32)."""
    return "fma" if dtype == torch.float32 else "wgmma"


def h_buffer(H: torch.Tensor) -> torch.Tensor:
    """Where the tensor-core body reads H (..., N, L) from: rows of
    Lp = 8 ceil(L / 8) values (16-byte strides) on 16 bytes.  H itself where
    it already is so; else an empty buffer of that shape (torch.empty: on
    16 bytes), which the launch fills with H and zero columns before its
    Gram grid reads it (zero columns add exact zeros, and the kernel stores
    only below L).  T (..., N, D) is read the same way (``t_buffer``)."""
    width = H.shape[-1]
    padded = -(-width // 8) * 8
    if padded == width and H.data_ptr() % 16 == 0:
        return H
    return torch.empty((*H.shape[:-1], padded), dtype=H.dtype, device=H.device)


t_buffer = h_buffer


_GRAM_DTYPES = (torch.float32, torch.bfloat16)
_ENTRIES = {("gram_tri", torch.float32): "gram_tri_f32",
            ("gram_tri", torch.bfloat16): "gram_tri_bf16_wgmma",
            ("gram_dense", torch.float32): "gram_dense_f32",
            ("gram_dense", torch.bfloat16): "gram_dense_bf16_wgmma"}


def _launch_gram(kind: str, H: torch.Tensor, T: torch.Tensor, m: int, N: int,
                 L: int, D: int):
    """G and R of ``kind`` on checked H and T; bf16 launches read H and T
    from their 16-byte buffers (held here until the launch is on the
    stream, which orders any reuse after it)."""
    lead = (m,) if kind == "gram_tri" else ()
    G = torch.empty((*lead, L, L), dtype=torch.float32, device=H.device)
    R = torch.empty((*lead, L, D), dtype=torch.float32, device=H.device)
    sizes = (m, N, L, D) if kind == "gram_tri" else (N, L, D)
    stream = raw_stream(H)
    fn = getattr(library(), _ENTRIES[kind, H.dtype])
    if H.dtype == torch.float32:
        code = fn(H.data_ptr(), T.data_ptr(), G.data_ptr(), R.data_ptr(),
                  *sizes, stream)
    else:
        Hp, Tp = h_buffer(H), t_buffer(T)
        code = fn(H.data_ptr(), Hp.data_ptr(), T.data_ptr(), Tp.data_ptr(),
                  G.data_ptr(), R.data_ptr(), *sizes, stream)
    raise_on(code, kind)
    LAUNCHES[kind] += 1
    LAST_GRAM.update(kernel=kind, body=gram_body(H.dtype))
    return G, R


def gram_tri(H: torch.Tensor, T: torch.Tensor):
    """G = H^T H (symmetric) and R = H^T T for all m agents in one launch.

    H: (m, N, L), T: (m, N, D), both fp32 or both bf16, contiguous.
    Returns (G (m, L, L) fp32, R (m, L, D) fp32)."""
    if on_cpu("Gram", H, T):
        return gram_ref(H, T)
    check("H", H, 3, _GRAM_DTYPES)
    check("T", T, 3, (H.dtype,))
    m, N, L = H.shape
    D = T.shape[-1]
    if T.shape[:2] != (m, N):
        raise ValueError(f"T shape {tuple(T.shape)} does not match H {tuple(H.shape)}")
    _check_sizes(m, N, L, D)
    return _launch_gram("gram_tri", H, T, m, N, L, D)


def gram_fused(X: torch.Tensor, W: torch.Tensor, b: torch.Tensor,
               T: torch.Tensor, activation: str = "sigmoid",
               precision: str = "fp32"):
    """Gram statistics of ``H = act(X W + b)``, H never given by the caller.

    X: (m, N, d_in) fp32; W: (d_in, L) fp32; b: (L,) fp32; T: (m, N, D),
    fp32 for ``precision="fp32"`` and bf16 for ``"bf16"`` (which also rounds
    H to bf16).  Returns (G (m, L, L), exactly symmetric, R (m, L, D)) fp32.
    H is computed once, chunk by chunk (``fused_chunks``), into a workspace
    of at most ``FUSED_WORKSPACE_BYTES``."""
    if activation not in ACTIVATION_CODES:
        raise ValueError(
            f"unknown activation {activation!r}; expected one of "
            f"{sorted(ACTIVATION_CODES)}"
        )
    if precision not in ("fp32", "bf16"):
        raise ValueError(f"fused precision must be fp32 or bf16, got {precision!r}")
    if on_cpu("Gram", X, W, b, T):
        return gram_fused_ref(X, W, b, T, activation, precision)
    f32 = (torch.float32,)
    check("X", X, 3, f32)
    check("W", W, 2, f32)
    check("b", b, 1, f32)
    t_dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    check("T", T, 3, (t_dtype,))
    m, N, d_in = X.shape
    L = W.shape[1]
    D = T.shape[-1]
    if W.shape[0] != d_in or b.shape[0] != L or T.shape[:2] != (m, N):
        raise ValueError(
            f"shapes do not agree: X {tuple(X.shape)}, W {tuple(W.shape)}, "
            f"b {tuple(b.shape)}, T {tuple(T.shape)}"
        )
    _check_sizes(m, N, L, D, d_in)
    lib = library()
    fn = (lib.gram_fused_chunk_bf16 if precision == "bf16"
          else lib.gram_fused_chunk_f32)
    chunks = fused_chunks(m, N, L, precision)
    width = fused_workspace_width(L, precision)
    G = torch.empty((m, L, L), dtype=torch.float32, device=X.device)
    R = torch.empty((m, L, D), dtype=torch.float32, device=X.device)
    workspace = torch.empty(m * chunks[0][1] * width, dtype=t_dtype,
                            device=X.device)
    stream = torch.cuda.current_stream(X.device).cuda_stream
    # the first chunk stores G and R, each later one adds into them
    launched = hidden_rows = 0
    for n0, rows in chunks:
        raise_on(fn(X.data_ptr(), W.data_ptr(), b.data_ptr(), T.data_ptr(),
                    G.data_ptr(), R.data_ptr(), workspace.data_ptr(), m, N, L,
                    D, d_in, n0, rows, width, ACTIVATION_CODES[activation],
                    stream), "gram_fused")
        launched += 1
        hidden_rows += rows
    LAUNCHES["gram_fused"] += 1
    LAST_FUSED.update(chunks=launched, hidden_rows=hidden_rows,
                      workspace_bytes=workspace.nbytes)
    return G, R


@functools.lru_cache(maxsize=256)
def q_layout(N: int, block_n: int) -> tuple[int, int]:
    """(stage, bnp): the int8 body's stage depth in samples and the padded
    length of each row block in Hq's K-major copy.

    A stage is one row of a 128-, 64- or 32-byte TMA swizzle (int8 wgmma
    steps through 32 samples at a time), and every row block is padded
    with zero samples to ``bnp``, a whole number of stages, so that no stage
    crosses a row-block boundary.  The least padding is to a multiple of 32
    samples; the deepest stage is taken whose padding adds at most a
    quarter to that (fewer, deeper stages cost the ring less a sample):
    ``block_n`` 512 pads nothing, 104 pads to one 128-sample stage, 40 to
    one of 64, 96 to three of 32, 8 to one of 32.  The copy then holds at
    most about twice Hq's bytes from 16 rows a row block up."""
    rows = min(block_n, N)
    least = -(-rows // 32) * 32
    for stage in (128, 64, 32):
        bnp = -(-rows // stage) * stage
        if 4 * bnp <= 5 * least:
            return stage, bnp
    raise AssertionError("unreachable: 32-sample stages pad the least")


def q_kmajor(Hq: torch.Tensor, T: torch.Tensor, block_n: int):
    """The K-major copies ``gram_tri_q`` writes before its Gram grid (its
    first grid, launched alone; not counted in ``LAUNCHES``): Hq (m, N, L)
    int8 -> Hk (m, L, kp) and T (m, N, D) bf16 -> Tk (m, D, kp), kp =
    ceil(N / block_n) * bnp, each row block's samples padded with zero
    samples to ``bnp`` (``q_layout``).  Returns (Hk, Tk).  CPU tensors take
    ``ref.q_kmajor_ref``."""
    if not 1 <= block_n <= MAX_INT8_BLOCK_N:
        raise ValueError(
            f"block_n must be in [1, {MAX_INT8_BLOCK_N}], got {block_n}")
    m, N, L = Hq.shape
    stage, bnp = q_layout(N, block_n)
    if on_cpu("Gram", Hq, T):
        return q_kmajor_ref(Hq, block_n, bnp), q_kmajor_ref(T, block_n, bnp)
    check("Hq", Hq, 3, (torch.int8,))
    check("T", T, 3, (torch.bfloat16,))
    D = T.shape[-1]
    if T.shape[:2] != (m, N):
        raise ValueError(f"T shape {tuple(T.shape)} does not match Hq "
                         f"{tuple(Hq.shape)}")
    _check_sizes(m, N, L, D)
    kp = -(-N // block_n) * bnp
    Hk = torch.empty((m, L, kp), dtype=torch.int8, device=Hq.device)
    Tk = torch.empty((m, D, kp), dtype=T.dtype, device=Hq.device)
    raise_on(library().gram_q_kmajor(
        Hq.data_ptr(), Hk.data_ptr(), T.data_ptr(), Tk.data_ptr(), m, N, L,
        D, block_n, stage, bnp, raw_stream(Hq)), "gram_q_kmajor")
    return Hk, Tk


def gram_tri_q(Hq: torch.Tensor, scales: torch.Tensor, T: torch.Tensor, *,
               block_n: int, block_l: int):
    """int8 statistics for all m agents in one launch, from quantized H.

    Hq: (m, N, L) int8; scales: (m, ceil(N / block_n), ceil(L / block_l))
    fp32, one per quantization tile; T: (m, N, D) bf16.  Returns
    (G (m, L, L) fp32, exactly symmetric, R (m, L, D) fp32).  ``block_n``
    may be at most ``MAX_INT8_BLOCK_N`` (1040): above it an int32 tile sum
    can exceed 2^24 and would round on its way to fp32.  On the card the
    call first writes K-major copies of Hq and T into buffers of its own
    (``q_kmajor``), then runs its Gram grid on them."""
    if not 1 <= block_n <= MAX_INT8_BLOCK_N or block_l < 1:
        raise ValueError(
            f"int8 Gram needs 1 <= block_n <= {MAX_INT8_BLOCK_N} (exact "
            f"int32 -> fp32 tile sums) and block_l >= 1, got "
            f"block_n={block_n}, block_l={block_l}"
        )
    if on_cpu("Gram", Hq, scales, T):
        return gram_tri_q_ref(Hq, scales, T, block_n, block_l)
    check("Hq", Hq, 3, (torch.int8,))
    check("scales", scales, 3, (torch.float32,))
    check("T", T, 3, (torch.bfloat16,))
    m, N, L = Hq.shape
    D = T.shape[-1]
    want = (m, -(-N // block_n), -(-L // block_l))
    if T.shape[:2] != (m, N) or tuple(scales.shape) != want:
        raise ValueError(
            f"shapes do not agree: Hq {tuple(Hq.shape)}, scales "
            f"{tuple(scales.shape)} (want {want}), T {tuple(T.shape)}"
        )
    _check_sizes(m, N, L, D)
    stage, bnp = q_layout(N, block_n)
    kp = -(-N // block_n) * bnp
    G = torch.empty((m, L, L), dtype=torch.float32, device=Hq.device)
    R = torch.empty((m, L, D), dtype=torch.float32, device=Hq.device)
    Hk = torch.empty((m, L, kp), dtype=torch.int8, device=Hq.device)
    Tk = torch.empty((m, D, kp), dtype=T.dtype, device=Hq.device)
    raise_on(library().gram_tri_q(
        Hq.data_ptr(), Hk.data_ptr(), scales.data_ptr(), T.data_ptr(),
        Tk.data_ptr(), G.data_ptr(), R.data_ptr(), m, N, L, D, block_n,
        block_l, stage, bnp, raw_stream(Hq)), "gram_tri_q")
    LAUNCHES["gram_tri_q"] += 1
    LAST_GRAM.update(kernel="gram_tri_q", body=gram_body(Hq.dtype))
    return G, R


def gram_dense(H: torch.Tensor, T: torch.Tensor):
    """The dense-tile baseline for ONE agent: every (i, j) tile pair of
    G = H^T H computed on its own (no symmetry used), R = H^T T.

    H: (N, L), T: (N, D), both fp32 or both bf16, contiguous.  Returns
    (G (L, L) fp32, R (L, D) fp32)."""
    if on_cpu("Gram", H, T):
        return gram_ref(H, T)
    check("H", H, 2, _GRAM_DTYPES)
    check("T", T, 2, (H.dtype,))
    N, L = H.shape
    D = T.shape[-1]
    if T.shape[0] != N:
        raise ValueError(f"T shape {tuple(T.shape)} does not match H {tuple(H.shape)}")
    _check_sizes(1, N, L, D)
    return _launch_gram("gram_dense", H, T, 1, N, L, D)
