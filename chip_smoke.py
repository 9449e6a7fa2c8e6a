#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. environment: the card, torch/CUDA versions, TF32 switched off;
  2. build: nvcc compiles the Gram, sliding-window attention, RG-LRU and
     mLSTM kernels from ``src/repro_torch``, one nvcc per source, all at
     once; ptxas's registers, spill bytes and static shared memory of
     every kernel, and the Gram bodies' dynamic shared memory, on the
     build line;
  3. kernels: each CUDA kernel against its plain PyTorch version at the
     main path's shape, the full backbone shape (m=8, N=8192, L=2048, D=8,
     d_in=256) and a ragged shape (m=3, N=1000, L=300, D=3, d_in=70), in
     fp32 and bf16 (bf16 ``gram_tri`` and ``gram_dense`` also at the main
     path's shape and at L=296; each Gram case records the body it ran,
     the FMA body in fp32 and the tensor cores in bf16, and the wrapper's
     host time per call; ``gram_tri_q``: int8 from one
     Hq/scales per case, block_l 128 and 32, its quantization pass timed
     apart, its G bit-equal to the plain version's, its K-major copies of
     Hq and T (the body's first grid) byte for byte their plain layout and
     timed apart;
     ``gram_dense``: one agent); G must be exactly symmetric (all but the
     dense baseline); ``gram_tri`` and ``gram_dense`` in fp32 and bf16 must
     also equal their plain versions exactly on small-integer inputs;
     ``gram_fused`` also reports its workspace and
     chunks (two at the full shape in fp32, three at the ragged shape with
     the workspace budget cut); ``swa`` at phase 6's shape,
     recurrentgemma-2b's and
     h2o-danube's at S = 8192, and a ragged one, also held in norm
     (``SWA_NORM_TOL``); ``rglru`` at phase 6's
     shape and a ragged one with h0 != 0; ``mlstm`` at phase 8's call in
     bf16 and fp32, a ragged S, a long memory, input gates near -80 and
     -100 and a shape the step-by-step oracle can run, all held at fp32
     level (``MLSTM_NORM_TOL``), each case recording the body it ran (the
     tensor cores in bf16, the FMA body in fp32); times of the kernel, the
     plain version and one library call;
  4. main path at full width: 8 agents, 8192 samples of 256 features each,
     an L=2048 hidden layer; the fused stats stream (``gram_fused``), the
     materialized stream (``gram_tri``), DMTL-ELM by consensus ADMM on a
     ring (each PCG solve's steps recorded), FO-DMTL-ELM, MTL-ELM, and the same DMTL fit from the kernels'
     plain versions; then, each with its own launch counts, the int8
     stream (``gram_tri_q``) and a DMTL fit from it, the colored
     Gauss-Seidel fit (at r = 1 its trajectory held against the same
     sweeps in fp64 on the CPU, and its staleness-1 sweep against the
     dense fit), the dense-baseline op (``gram_dense``), and the bf16
     materialized stream (``gram_tri`` on the tensor-core body); every kernel
     of each path must have launched; then the dense, int8 and colored
     fits to 32 iterations at r = 8 and r = 1, their objective gaps read
     at 8, 16 and 32;
  5. the quickstart's small default mode on the card, Gauss-Seidel line
     included;
  5b. the checkpointed, traced fit at phase 4's width (8 agents, 8192
     samples, L = 2048 sigmoid, r = 8, ring(8), PCG, fp32 stats on
     ``gram_tri``): (a) fit to 12 iterations with a checkpoint every 4,
     stopped after 4 and resumed, the resumed state and every diagnostics
     key held bit for bit against an uninterrupted fit; (b) the same on
     star(8) at L = 512, whose hub adds 7 terms in one segment sum; (c) a
     child process that ``REPRO_CHECKPOINT_EXIT_AFTER_SAVE=8`` ends after its
     save at 8, resumed here and held against (a); (d) one fit with
     telemetry and a trace: the trace valid, one ``stats`` span and one
     ``segment`` span a segment, ``gram_tri`` launched inside it, the report
     healthy, ``msgs_delivered`` 2|E| and ``comm_floats`` the analytic model
     in every row; (e) the health monitor's early stop with ``dnf_reason``
     in the snapshot's metadata; (f) MTFL, GO-MTL, DGSP and DNSP at
     ``usps_like()``'s shape, fp64 and fp32, on the data of each of
     ``BASELINE_SEEDS``, against the same functions on the CPU
     (``BASELINE_FP64_TOL``, ``BASELINE_ROUNDOFF_FACTOR``); the stats and
     segment spans, save and restore seconds and checkpoint bytes on the
     phase's line;
  6. the backbone route at full recurrentgemma-2b width (26 layers, bf16
     compute, fp32 weights from a seeded generator): 4 agents, 2 batches of
     8 x 4096 tokens each, pooled features into fused L = 2048 statistics,
     DMTL-ELM on ring(4), held-out accuracy; every ``swa`` and ``rglru``
     block launched its kernel; the features against the kernels' plain
     versions in bf16 (3e-2 of max |plain|, 3e-3 in norm) and, on one
     sequence, in fp32 (1e-3); each PCG solve's step count recorded;
  7. the backbone example as written (``repro_torch.backbone.main``);
  8. the backbone route at full xlstm-1.3b width (48 layers: 42 mLSTM, 6
     sLSTM; bf16 compute, fp32 weights from a seeded generator), as phase 6:
     every mLSTM block launched ``mlstm``, the same checks, and one mLSTM
     and one sLSTM block timed apart at the route's (8, 4096, 2048);
  9. the ``gram_tri`` and ``gram_dense`` cases of phase 3 at the main
     path's and the full shape, and the bf16 ragged ones, split by
     ``torch.profiler`` into device time per kernel, theirs and the
     library call's, and ``mlstm`` at phase 8's call in bf16 and fp32 into
     its four grids: last, because a profiler session slows the host side
     of every later launch in the process.

The last three lines of standard output are the ``{"kernels": ...}`` JSON
line, the card's name and power limit from nvidia-smi, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32": 67e12, "bf16": 989e12, "int8": 1979e12}
# int8: the tile products are exact, only the fp32 order differs
TOL = {"fp32": 1e-4, "bf16": 3e-2, "int8": 1e-4}
# swa is held in norm too: its max |plain| comes from early rows with few
# live keys (row 0's output is v_0), whose entries are ~W^1/2 larger than
# those of rows with a full window, so the max-based limit alone is loose
# there.  bf16: 2^-9, the unit roundoff of the bf16 output.
SWA_NORM_TOL = {"fp32": 1e-5, "bf16": 2e-3}
# mlstm's output is fp32 from widened inputs in every case, so it is held
# at fp32 level in norm, bf16 inputs too: 1.7e-6 to 2.3e-6 measured on the
# H100 at D = 64 and 1024
MLSTM_NORM_TOL = 1e-5
# phases 6 and 8: bf16 pooled features, kernels against plain versions, in
# norm
FEATURE_NORM_TOL = 3e-3
# phases 6 and 8: each block's sequence mixer with a kernel against its
# plain version on the same input along the route, in norm; fp32 also
# within TOL["fp32"] of max |plain|.  bf16 is held in norm only: one bf16
# ulp flip of h before the head norm moves an element by up to 2^-8 of it,
# so the max over a route's blocks is a coarse statistic (5.1e-3 and
# 1.9e-2 on xlstm-1.3b in two runs, PERF.md §6); in norm they read
# 2.2e-4 to 5.6e-4, and a kernel whose carried state does not decay 0.35.
BLOCK_NORM_TOL = {"bf16": FEATURE_NORM_TOL, "fp32": 1e-5}
# phases 6 and 8 end to end, kernels against plain versions: bf16 pooled
# features (of max |plain|, in norm) and fp32 final hidden states (of max
# |plain|).  A random-weight xlstm-1.3b amplifies fp32 roundoff through its
# 48 layers: its plain version at chunk 128 against chunk 256, the same
# function, parts by 4.4e-2, 4.7e-2 and 2.5e-2 (PERF.md §6).  Its limits
# are about twice those, and the per-block check is what holds its kernel.
END_TO_END_TOL = {
    "recurrentgemma-2b": {"bf16_rel": TOL["bf16"],
                          "bf16_norm_rel": FEATURE_NORM_TOL, "fp32_rel": 1e-3},
    "xlstm-1.3b": {"bf16_rel": 9e-2, "bf16_norm_rel": 1e-1, "fp32_rel": 5e-2},
}
H_BYTES = {"fp32": 4, "bf16": 2, "int8": 1}
REPEATS = 7


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn) -> float:
    """Median CUDA-event time of ``fn`` over REPEATS runs after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(REPEATS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def device_split(torch, fn, calls: int = 5) -> dict:
    """Device time per call of each kernel that ``fn`` launches, in ms, from
    ``torch.profiler`` over ``calls`` calls after a warm-up: what a single
    CUDA-event time adds on the host is not in it."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key[:72]: e.device_time_total / calls / 1e3
            for e in prof.key_averages() if e.device_time_total > 0}


def rel_err(torch, got, want) -> tuple[float, float]:
    diff = float((got - want).abs().max())
    return diff, diff / max(float(want.abs().max()), 1e-30)


def integer_gram_err(torch, kernel, ref, kind, m, N, L, D, gen,
                     precision="bf16") -> float:
    """max |kernel - plain| over G and R of ``gram_tri`` (``gram_dense`` at
    one agent) in ``precision`` on inputs of small integers, -2 .. 2: every
    product and every partial sum (at most 4 N) is an integer that fp32
    holds exactly, so any order of the sums gives the same G and R, and a
    sound body reads exactly 0.  A stage whose products are lost (64
    samples in bf16, 16 in fp32) reads at least 1 on G's diagonal, and a
    stage read before its copies landed reads off wherever the stale values
    differ; against ``TOL["bf16"]``, which holds Gaussian inputs relative
    to max |plain|, a lost bf16 stage reads ~1e-2 at N = 8192 and passes
    (PERF.md §6)."""
    assert 4 * N < 2**24, "partial sums would leave fp32's exact integers"
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    shape = (N, L) if kind == "gram_dense" else (m, N, L)
    H = torch.randint(-2, 3, shape, device="cuda", generator=gen).to(dtype)
    T = torch.randint(-2, 3, (*shape[:-1], D), device="cuda",
                      generator=gen).to(dtype)
    G, R = getattr(kernel, kind)(H, T)
    Gp, Rp = ref.gram_ref(H, T)
    return max(float((G - Gp).abs().max()), float((R - Rp).abs().max()))


def host_us(torch, fn, calls: int = 20) -> float:
    """Host microseconds per call of ``fn``, from a clock around ``calls``
    calls that nothing synchronizes (the card runs behind)."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    spent = time.perf_counter() - t
    torch.cuda.synchronize()
    return spent / calls * 1e6


def norm_rel(torch, got, want) -> float:
    """||got - want|| / ||want|| over all entries, in fp32."""
    got, want = got.float(), want.float()
    return float(torch.linalg.vector_norm(got - want)
                 / max(float(torch.linalg.vector_norm(want)), 1e-30))


def counted_pcg(solvers, steps: list):
    """The engine's ``pcg`` U-solve (Jacobi-preconditioned CG, the same
    calls), appending each solve's steps per agent to ``steps``."""
    def solve(G, M, rhs, c, precomp=None):
        U, n = solvers.sum_sylvester_cg(G.unsqueeze(-3), M.unsqueeze(-3), rhs,
                                        c, precond="jacobi", return_info=True)
        steps.append(n.tolist())
        return U
    return solve


def gram_cost(kind, m, N, L, D, d_in, precision, n_scales=0):
    """(bytes, bound ms, bound_by): every
    input read once, every output written once; the useful flops of the
    lower triangle of G plus R (plus the hidden layer once, fused), which
    is all that G = HᵀH and R = HᵀT need, the dense baseline included.
    int8 reads 1-byte H, ``n_scales`` fp32 scales and bf16 T, all its
    operations at the int8 rate."""
    h_bytes = H_BYTES[precision]
    out_bytes = 4 * m * L * (L + D)
    gram_ops = m * N * L * (L + 1) + 2 * m * N * L * D
    if kind in ("gram_tri", "gram_dense"):
        nbytes = h_bytes * m * N * (L + D) + out_bytes
        op_ms = gram_ops / PEAK_OPS_PER_S[precision] * 1e3
    elif kind == "gram_tri_q":
        nbytes = m * N * L + 4 * n_scales + 2 * m * N * D + out_bytes
        op_ms = gram_ops / PEAK_OPS_PER_S[precision] * 1e3
    else:
        nbytes = (4 * (m * N * d_in + d_in * L + L) + h_bytes * m * N * D
                  + out_bytes)
        hidden_ops = 2 * m * N * d_in * L
        op_ms = (hidden_ops / PEAK_OPS_PER_S["fp32"]
                 + gram_ops / PEAK_OPS_PER_S[precision]) * 1e3
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_by = "bytes" if byte_ms > op_ms else "operations"
    return nbytes, max(byte_ms, op_ms), bound_by


def ptxas_resources(log: str) -> list[dict]:
    """Each kernel's registers, spill bytes and static shared memory from
    an ``nvcc -Xptxas -v`` log (dynamic shared memory is not in it)."""
    rows = []
    for line in log.splitlines():
        if "Compiling entry function" in line:
            rows.append({"kernel": line.split("'")[1]})
        elif rows and "spill stores" in line:
            rows[-1]["spill_stores"], rows[-1]["spill_loads"] = (
                int(x) for x in re.findall(r"(\d+) bytes spill", line))
        elif rows and "registers" in line:
            rows[-1]["registers"] = int(re.search(r"Used (\d+) registers",
                                                  line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            rows[-1]["static_smem"] = int(smem.group(1)) if smem else 0
    return rows


def swa_cost(B, H, KV, S, D, W, precision):
    """(bytes, bound ms, bound_by): q, k, v read once and o written once,
    against 4 D flops (Q K^T and P V) per live (query, key) pair, at the
    rate of the inputs' precision."""
    live = W * (W + 1) // 2 + (S - W) * W if S > W else S * (S + 1) // 2
    ops = 4 * B * H * D * live
    nbytes = H_BYTES[precision] * (2 * B * H * S * D + 2 * B * KV * S * D)
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    op_ms = ops / PEAK_OPS_PER_S[precision] * 1e3
    return nbytes, max(byte_ms, op_ms), "bytes" if byte_ms > op_ms else \
        "operations"


def rglru_cost(B, S, D):
    """(bytes, bound ms, bound_by): log_a and b read, h written, h0 read,
    all fp32; 3 flops and an exp per element are far below the byte
    time."""
    nbytes = 4 * (3 * B * S * D + B * D)
    return nbytes, nbytes / PEAK_BYTES_PER_S * 1e3, "bytes"


def mlstm_cost(B, H, S, D, precision):
    """(bytes, bound ms, bound_by): q, k, v read once, the two fp32 gates
    read once, h written once in fp32, against 4 B H S (D^2 + D) flops at
    the rate of the inputs' precision: per step the rank-one updates of C
    and n and the products C q and n . q, all that the step-by-step form
    needs.  The chunkwise form does the same plus each chunk's causal
    triangle of q k^T and S V (2 (l + 1) D more per step in a chunk of l
    steps), which only a kernel parallel over time pays."""
    ops = 4 * B * H * S * (D * D + D)
    nbytes = (H_BYTES[precision] * 3 * B * H * S * D + 4 * 2 * B * H * S
              + 4 * B * H * S * D)
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    op_ms = ops / PEAK_OPS_PER_S[precision] * 1e3
    return nbytes, max(byte_ms, op_ms), "bytes" if byte_ms > op_ms else \
        "operations"


def mlstm_case(torch, mlstm_kernel, refs, shape, precision, gen, label,
               gates="std", sequential=False):
    """The mlstm kernel against its plain version (the chunk algebra in
    PyTorch) and, with ``sequential``, the step-by-step oracle.  Gates:
    "std" log_f = log-sigmoid(N(2, 1)), i ~ N(0, 1); "long" log_f = -0.01;
    "neg80" / "neg100" i ~ N(-80, 0.5) / N(-100, 1), where the floor e^{-m}
    is ~1e35 / +inf (h ~1e-34 / exactly 0).  Errors are taken on the
    outputs divided by max |plain|, so that ~1e-34 entries do not square
    to 0 in the norm.  No single PyTorch call computes a gated recurrence
    with a matrix state: library_ms is null."""
    B, H, S, D, c = shape
    chunkwise_ref, sequential_ref = refs
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    q, k, v = (torch.randn(B, H, S, D, device="cuda", generator=gen).to(dtype)
               for _ in range(3))
    if gates == "long":
        log_f = torch.full((B, H, S), -0.01, device="cuda")
    else:
        log_f = torch.nn.functional.logsigmoid(
            torch.randn(B, H, S, device="cuda", generator=gen) + 2.0)
    i_gate = torch.randn(B, H, S, device="cuda", generator=gen)
    if gates == "neg80":
        i_gate = 0.5 * i_gate - 80.0
    elif gates == "neg100":
        i_gate = i_gate - 100.0

    def run():
        return mlstm_kernel.mlstm(q, k, v, log_f, i_gate, c)

    def plain():
        return chunkwise_ref(q, k, v, log_f, i_gate, c)

    h = run()
    torch.cuda.synchronize()
    ran = dict(mlstm_kernel.LAST_MLSTM)
    hp = plain()
    check(bool(torch.isfinite(h).all()), f"mlstm {label}: non-finite")
    if gates == "neg100":
        check(not bool(h.any()) and not bool(hp.any()),
              f"mlstm {label}: h is not exactly 0 where e^-m overflows")
    peak = float(hp.abs().max()) or 1.0
    abs_e = float((h - hp).abs().max())
    _, rel_e = rel_err(torch, h / peak, hp / peak)
    norm_e = norm_rel(torch, h / peak, hp / peak)
    check(rel_e <= TOL["fp32"], f"mlstm {label} {precision}: relative error "
          f"{rel_e:.3g} above {TOL['fp32']}")
    check(norm_e <= MLSTM_NORM_TOL, f"mlstm {label} {precision}: "
          f"norm-relative error {norm_e:.3g} above {MLSTM_NORM_TOL}")
    nbytes, bound_ms, bound_by = mlstm_cost(B, H, S, D, precision)
    case = {"case": label, "dtype": precision, "gates": gates,
            "shape": {"B": B, "H": H, "S": S, "D": D, "chunk": c},
            "body": ran["body"], "terms": ran["terms"],
            "max_abs_err": abs_e, "max_plain": peak, "rel_err": rel_e,
            "tol": TOL["fp32"], "norm_rel_err": norm_e,
            "norm_tol": MLSTM_NORM_TOL}
    if sequential:
        hs = sequential_ref(q, k, v, log_f, i_gate)
        _, seq_rel = rel_err(torch, h, hs)
        seq_norm = norm_rel(torch, h, hs)
        check(seq_rel <= TOL["fp32"] and seq_norm <= MLSTM_NORM_TOL,
              f"mlstm {label}: off the step-by-step oracle by {seq_rel:.3g} "
              f"of max, {seq_norm:.3g} in norm")
        case.update(sequential_rel_err=seq_rel, sequential_norm_rel_err=seq_norm)
        del hs
    del h, hp
    case.update(kernel_ms=time_ms(torch, run), plain_ms=time_ms(torch, plain),
                library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                bytes=nbytes)
    torch.cuda.empty_cache()
    return case


def swa_case(torch, swa_kernel, swa_ref, shape, precision, gen, label):
    """The swa kernel against its plain version (the full masked softmax),
    timed beside it and one ``scaled_dot_product_attention`` with the band
    mask (timed only; the port never calls it)."""
    B, H, KV, S, D, W = shape
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    q = torch.randn(B, H, S, D, device="cuda", generator=gen).to(dtype)
    k = torch.randn(B, KV, S, D, device="cuda", generator=gen).to(dtype)
    v = torch.randn(B, KV, S, D, device="cuda", generator=gen).to(dtype)
    i = torch.arange(S, device="cuda")
    band = (i[None, :] <= i[:, None]) & (i[:, None] - i[None, :] < W)

    def run():
        return swa_kernel.swa(q, k, v, W)

    def plain():
        return swa_ref(q, k, v, W)

    def library():
        return torch.nn.functional.scaled_dot_product_attention(
            q, k, v, attn_mask=band, scale=D ** -0.5, enable_gqa=True)

    o = run()
    torch.cuda.synchronize()
    op = plain()
    check(bool(torch.isfinite(o.float()).all()), f"swa {label}: non-finite")
    abs_e, rel_e = rel_err(torch, o.float(), op.float())
    norm_e = norm_rel(torch, o, op)
    check(rel_e <= TOL[precision], f"swa {label} {precision}: relative "
          f"error {rel_e:.3g} above {TOL[precision]}")
    check(norm_e <= SWA_NORM_TOL[precision], f"swa {label} {precision}: "
          f"norm-relative error {norm_e:.3g} above {SWA_NORM_TOL[precision]}")
    del o, op
    nbytes, bound_ms, bound_by = swa_cost(B, H, KV, S, D, W, precision)
    case = {"case": label, "dtype": precision,
            "shape": {"B": B, "H": H, "KV": KV, "S": S, "D": D, "W": W},
            "max_abs_err": abs_e, "rel_err": rel_e, "tol": TOL[precision],
            "norm_rel_err": norm_e, "norm_tol": SWA_NORM_TOL[precision],
            "kernel_ms": time_ms(torch, run), "plain_ms": time_ms(torch, plain),
            "library_ms": time_ms(torch, library), "bound_ms": bound_ms,
            "bound_by": bound_by, "bytes": nbytes}
    torch.cuda.empty_cache()
    return case


def rglru_case(torch, rglru_kernel, rglru_ref, shape, gen, label, h0_zero):
    """The rglru kernel against its plain version (a loop over time).  No
    single PyTorch call computes a linear recurrence: library_ms is null."""
    B, S, D = shape
    log_a = -torch.nn.functional.softplus(
        torch.randn(B, S, D, device="cuda", generator=gen))
    b = torch.randn(B, S, D, device="cuda", generator=gen)
    h0 = (torch.zeros(B, D, device="cuda") if h0_zero
          else torch.randn(B, D, device="cuda", generator=gen))

    def run():
        return rglru_kernel.rglru(log_a, b, h0)

    def plain():
        return rglru_ref(log_a, b, h0)

    h = run()
    torch.cuda.synchronize()
    hp = plain()
    check(bool(torch.isfinite(h).all()), f"rglru {label}: non-finite")
    abs_e, rel_e = rel_err(torch, h, hp)
    check(rel_e <= TOL["fp32"], f"rglru {label}: relative error "
          f"{rel_e:.3g} above {TOL['fp32']}")
    nbytes, bound_ms, bound_by = rglru_cost(B, S, D)
    return {"case": label, "dtype": "fp32",
            "shape": {"B": B, "S": S, "D": D}, "h0_zero": h0_zero,
            "max_abs_err": abs_e, "rel_err": rel_e, "tol": TOL["fp32"],
            "kernel_ms": time_ms(torch, run), "plain_ms": time_ms(torch, plain),
            "library_ms": None, "bound_ms": bound_ms, "bound_by": bound_by,
            "bytes": nbytes}


def kernel_case(torch, kernel, ref, kind, shape, precision, activation,
                gen, label, block_l=128):
    """One kernel against its plain version on the same inputs, timed
    beside the plain version and one library call (None where PyTorch has
    no call for the shape)."""
    m, N, L, D, d_in = shape
    dtype = torch.bfloat16 if precision != "fp32" else torch.float32
    T = torch.randn(m, N, D, device="cuda", generator=gen).to(dtype)
    extra, n_scales = {}, 0
    if kind == "gram_tri_q":
        H = torch.randn(m, N, L, device="cuda", generator=gen) / math.sqrt(L)
        from repro_torch.kernels.gram.ops import resolve_block_n

        bn = resolve_block_n(N, 512)

        def quantize():
            return ref.quantize_tiles(H, bn, block_l, gen)

        extra["quant_ms"] = time_ms(torch, quantize)
        Hq, scales = quantize()      # every timed call below uses these
        n_scales = scales.numel()
        extra.update(block_n=bn, block_l=block_l)
        del H
        # the body's first grid alone: the K-major copies of Hq and T, byte
        # for byte their plain layout, timed apart against reading Hq and T
        # and writing the copies
        stage, bnp = kernel.q_layout(N, bn)
        Hk, Tk = kernel.q_kmajor(Hq, T, bn)
        torch.cuda.synchronize()
        check(torch.equal(Hk, ref.q_kmajor_ref(Hq, bn, bnp))
              and torch.equal(Tk, ref.q_kmajor_ref(T, bn, bnp)),
              f"gram_tri_q {label}: a K-major copy differs from its plain "
              f"layout")
        copy_bytes = Hq.numel() + Hk.numel() + 2 * (T.numel() + Tk.numel())
        extra.update(
            stage=stage, padded_block_n=bnp, kmajor_bytes=Hk.numel(),
            kmajor_ms=time_ms(torch, lambda: kernel.q_kmajor(Hq, T, bn)),
            kmajor_bound_ms=copy_bytes / PEAK_BYTES_PER_S * 1e3)
        del Hk, Tk

        def run():
            return kernel.gram_tri_q(Hq, scales, T, block_n=bn,
                                     block_l=block_l)

        def plain():
            return ref.gram_tri_q_ref(Hq, scales, T, bn, block_l)

        library = None
        if N % 8 == 0 and L % 8 == 0:
            # the int8 products of G alone, per agent, without the scales
            HqT = Hq.mT.contiguous()

            def library():
                return [torch._int_mm(HqT[a], Hq[a]) for a in range(m)]
    elif kind == "gram_dense":
        H = (torch.randn(N, L, device="cuda", generator=gen)
             / math.sqrt(L)).to(dtype)
        T = T[0]

        def run():
            return kernel.gram_dense(H, T)

        def plain():
            return ref.gram_ref(H, T)

        def library():
            return torch.mm(H.T, H), torch.mm(H.T, T)
    elif kind == "gram_tri":
        H = (torch.randn(m, N, L, device="cuda", generator=gen)
             / math.sqrt(L)).to(dtype)

        def run():
            return kernel.gram_tri(H, T)

        def plain():
            return ref.gram_ref(H, T)

        def library():
            return torch.bmm(H.mT, H), torch.bmm(H.mT, T)
    else:
        X = torch.randn(m, N, d_in, device="cuda", generator=gen)
        W = torch.randn(d_in, L, device="cuda", generator=gen) / math.sqrt(d_in)
        b = torch.randn(L, device="cuda", generator=gen)
        act = ref.ACTIVATIONS[activation]
        Wb = W.expand(m, d_in, L)

        def run():
            return kernel.gram_fused(X, W, b, T, activation, precision)

        def plain():
            return ref.gram_fused_ref(X, W, b, T, activation, precision)

        def library():
            Hl = act(torch.baddbmm(b, X, Wb)).to(dtype)
            return torch.bmm(Hl.mT, Hl), torch.bmm(Hl.mT, T)

    kernel.LAST_FUSED.update(chunks=0, hidden_rows=0, workspace_bytes=0)
    kernel.LAST_GRAM.update(kernel=None, body=None)
    G, R = run()
    torch.cuda.synchronize()
    launched = dict(kernel.LAST_FUSED)   # this call's, as the wrapper counted
    body = kernel.LAST_GRAM["body"]      # the body a Gram call ran
    Gp, Rp = plain()
    check(bool(torch.isfinite(G).all() and torch.isfinite(R).all()),
          f"{kind} {label}: non-finite output")
    if kind != "gram_dense":
        check(torch.equal(G, G.mT),
              f"{kind} {label}: G is not exactly symmetric")
    abs_g, rel_g = rel_err(torch, G, Gp)
    abs_r, rel_r = rel_err(torch, R, Rp)
    check(rel_g <= TOL[precision] and rel_r <= TOL[precision],
          f"{kind} {label} {precision}: relative error G {rel_g:.3g} "
          f"R {rel_r:.3g} above {TOL[precision]}")
    if kind == "gram_tri_q":
        # G's tile products are exact and scaled into fp32 in the plain
        # version's order: G equals it bit for bit
        extra["g_abs_err"] = abs_g
        check(abs_g == 0.0, f"gram_tri_q {label}: G off its plain version "
              f"by {abs_g:.3g}, where both are exact")
    if kind == "gram_dense":
        m = 1
    nbytes, bound_ms, bound_by = gram_cost(
        kind, m, N, L, D, d_in, precision, n_scales)
    case = {
        "case": label, "dtype": precision, "activation": activation,
        "shape": {"m": m, "N": N, "L": L, "D": D, "d_in": d_in},
        "max_abs_err": max(abs_g, abs_r), "rel_err": max(rel_g, rel_r),
        "tol": TOL[precision],
        "kernel_ms": time_ms(torch, run), "plain_ms": time_ms(torch, plain),
        "library_ms": None if library is None else time_ms(torch, library),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
        **extra,
    }
    if kind == "gram_fused":
        # the hidden layer over ``hidden_rows`` sample rows of all m agents;
        # rows past N are rows computed again (the first port rebuilt H per
        # tile pair, ~L / 128 times over)
        case.update(chunks=launched["chunks"],
                    workspace_bytes=launched["workspace_bytes"],
                    recomputed_hidden_flops=2 * m * d_in * L
                    * (launched["hidden_rows"] - N))
    if kind == "gram_tri_q":
        case.update(body=body, host_us=host_us(torch, run))
    if kind in ("gram_tri", "gram_dense"):
        # the wrapper's host time per call, and the library call's, taken
        # before any profiler session (phase 9 has the device time)
        case.update(body=body, host_us=host_us(torch, run),
                    library_host_us=host_us(torch, library))
        case["integer_abs_err"] = integer_gram_err(
            torch, kernel, ref, kind, m, N, L, D, gen, precision)
        check(case["integer_abs_err"] == 0.0,
              f"{kind} {label} {precision}: off its plain version by "
              f"{case['integer_abs_err']:.3g} on integer inputs, where both "
              f"are exact")
    if kind == "gram_dense":
        # what the baseline's algorithm does: every tile pair, the full square
        case["algorithmic_ops"] = 2 * N * L * L + 2 * N * L * D
    del G, R, Gp, Rp, run, plain, library
    torch.cuda.empty_cache()
    return case


def gram_device_splits(torch, kernel, cases, gen) -> None:
    """Phase 9: each ``gram_tri``/``gram_dense`` case of phase 3 at the main
    path's or the full shape (fp32 and bf16), and each bf16 ragged one,
    gets ``device_ms`` and ``library_device_ms``, the device time per call
    of each kernel that it and its library call launch (``device_split``),
    apart from the host time a single timed call carries (``host_us``).
    It runs after every timed phase: after a profiler session the host side
    of each launch in the process is slower (phase 8's encode by 11-23% on
    an H100, PERF.md §6)."""
    for kind in ("gram_tri", "gram_dense"):
        mm = torch.mm if kind == "gram_dense" else torch.bmm
        for case in cases[kind]:
            if not (case["case"] in ("main_path", "full")
                    or case["dtype"] == "bf16"):
                continue
            dtype = torch.bfloat16 if case["dtype"] == "bf16" else torch.float32
            m, N, L, D = (case["shape"][k] for k in "mNLD")
            shape = (N, L) if kind == "gram_dense" else (m, N, L)
            H = (torch.randn(*shape, device="cuda", generator=gen)
                 / math.sqrt(L)).to(dtype)
            T = torch.randn(*shape[:-1], D, device="cuda",
                            generator=gen).to(dtype)
            case.update(
                device_ms=device_split(
                    torch, lambda: getattr(kernel, kind)(H, T)),
                library_device_ms=device_split(
                    torch, lambda: (mm(H.mT, H), mm(H.mT, T))))
            del H, T
            torch.cuda.empty_cache()


def mlstm_device_splits(torch, mlstm_kernel, cases, gen) -> None:
    """Phase 9: ``mlstm`` at phase 3's main-path cases (phase 8's call, bf16
    and fp32) gets ``device_ms``, the device time per call of each of its
    grids (gates, states, scores, outputs: the tensor-core grids in bf16,
    the FMA grids in fp32), from ``torch.profiler``."""
    for case in cases["mlstm"]:
        if case["case"] != "main_path":
            continue
        B, H, S, D, c = (case["shape"][k] for k in ("B", "H", "S", "D",
                                                    "chunk"))
        dtype = torch.bfloat16 if case["dtype"] == "bf16" else torch.float32
        q, k, v = (torch.randn(B, H, S, D, device="cuda",
                               generator=gen).to(dtype) for _ in range(3))
        log_f = torch.nn.functional.logsigmoid(
            torch.randn(B, H, S, device="cuda", generator=gen) + 2.0)
        i_gate = torch.randn(B, H, S, device="cuda", generator=gen)
        case["device_ms"] = device_split(
            torch, lambda: mlstm_kernel.mlstm(q, k, v, log_f, i_gate, c),
            calls=3)
        del q, k, v
        torch.cuda.empty_cache()


KERNEL_KINDS = ("swa", "rglru", "mlstm")   # each block of the kind launches it


def block_errors(torch, params, cfg, tokens):
    """Every block of a kind in ``KERNEL_KINDS`` against its plain version
    on the same input, layer by layer along the kernel path: the largest
    max-based and norm-relative errors of a block's sequence mixer (the part
    that runs the kernel, before the residual add), and the number of blocks
    held.  No error carries from one layer to the next."""
    from repro_torch.models import transformer
    from repro_torch.models.layers import rmsnorm

    x = transformer._embed_tokens(params, cfg, tokens)
    worst = {"rel": 0.0, "norm_rel": 0.0, "blocks": 0}
    for layer, kind in zip(params["layers"], cfg.layer_kinds()):
        if kind in KERNEL_KINDS:
            h = rmsnorm(layer["ln1"], x, cfg.norm_eps)
            o = transformer.mixer(layer, cfg, kind, h).float()
            o_p = transformer.mixer(layer, cfg, kind, h,
                                    use_kernel=False).float()
            worst["rel"] = max(worst["rel"], rel_err(torch, o, o_p)[1])
            worst["norm_rel"] = max(worst["norm_rel"], norm_rel(torch, o, o_p))
            worst["blocks"] += 1
        x, _, _ = transformer.block_apply(layer, cfg, kind, x)
    return worst


def encode_by_kind(torch, params, cfg, tokens):
    """One bf16 encode of ``tokens`` (B, S) walked layer by layer, the card
    synchronized after each block: host seconds per block kind, the rest
    (embedding, final norm) under "other", and under "mlstm_kernel" the
    device seconds of the ``mlstm`` calls inside the blocks (CUDA events
    around each call: its launches and its allocations)."""
    from repro_torch.kernels.mlstm import kernel as mlstm_kernel
    from repro_torch.models import transformer
    from repro_torch.models.layers import rmsnorm

    launch, events = mlstm_kernel.mlstm, []

    def timed_launch(*args):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = launch(*args)
        stop.record()
        events.append((start, stop))
        return out

    spent = dict.fromkeys(cfg.block_pattern, 0.0)
    mlstm_kernel.mlstm = timed_launch
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = transformer._embed_tokens(params, cfg, tokens)
        for layer, kind in zip(params["layers"], cfg.layer_kinds()):
            torch.cuda.synchronize()
            t = time.perf_counter()
            x, _, _ = transformer.block_apply(layer, cfg, kind, x)
            torch.cuda.synchronize()
            spent[kind] += time.perf_counter() - t
        rmsnorm(params["final_norm"], x, cfg.norm_eps)
        torch.cuda.synchronize()
        spent["other"] = time.perf_counter() - t0 - sum(spent.values())
    finally:
        mlstm_kernel.mlstm = launch
    spent["mlstm_kernel"] = sum(a.elapsed_time(b) for a, b in events) / 1e3
    spent["mlstm_calls"] = len(events)
    return spent


def backbone_route(torch, cfg, wrappers, n_batches):
    """Phases 6 and 8: ``cfg`` at full width through ``repro_torch.backbone``
    (4 agents, ``n_batches`` batches of 8 x 4096 tokens each, pooled features
    into fused L = 2048 statistics, DMTL-ELM on ring(4) at r = 8 with each
    PCG solve's steps recorded, held-out accuracy on 8 sequences per agent).
    Every block of a kind in ``KERNEL_KINDS`` launched its kernel once per
    encode, each batch ``gram_fused`` once, and nothing else launched;
    features, statistics and diagnostics are finite.  (c) bf16, agent 0's
    first batch, and (d) fp32, one sequence: every block with a kernel
    against its plain version on the same input along the kernel path
    (``BLOCK_NORM_TOL``), then end to end, the pooled features (bf16) and
    the final hidden states (fp32) against the plain versions
    (``END_TO_END_TOL``).  Returns (the phase's record, the weights)."""
    from repro_torch import backbone
    from repro_torch.core import elm, engine, solvers
    from repro_torch.core.heads import pooled_features
    from repro_torch.data import pipeline
    from repro_torch.models import transformer

    m, batch, seq, L = 4, 8, 4096, 2048
    times = {}

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t
        return out

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = timed("init_s", lambda: transformer.init_model(
        torch.Generator(device="cuda").manual_seed(0), cfg))
    fmap = elm.make_feature_map(7, cfg.d_model, L, dist="normal",
                                device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    train = list(backbone.token_batches(gen, n_batches, n=batch, seq=seq,
                                        m=m))
    test_tokens, test_labels = next(backbone.token_batches(
        gen, 1, n=batch, seq=seq, m=m))
    for w in wrappers.values():
        w.reset_launches()
    feats = timed("encode_s", lambda: list(
        backbone.agent_batches(params, cfg, train)))
    stats = timed("stats_s", lambda: pipeline.stream_sufficient_stats(
        feats, producer="fused", feature_map=fmap))
    cfg_admm = backbone.admm_config()
    pcg_steps = []
    engine.U_SOLVERS["pcg_counted"] = counted_pcg(solvers, pcg_steps)
    state, diag = timed("fit_s", lambda: backbone.fit(
        stats, dataclasses.replace(cfg_admm, u_solver="pcg_counted")))
    acc = timed("eval_s", lambda: backbone.evaluate(
        params, cfg, fmap, state, stats, cfg_admm, test_tokens, test_labels))
    launches = {name: n for w in wrappers.values()
                for name, n in w.LAUNCHES.items()}
    kinds = cfg.layer_kinds()
    n_encode = m * (n_batches + 1)      # training batches + evaluation
    want = dict.fromkeys(launches, 0)
    want.update({k: kinds.count(k) * n_encode for k in KERNEL_KINDS},
                gram_fused=n_batches)
    check(launches == want, f"{cfg.name} route launches {launches}, "
          f"expected {want}")
    finite = [f for f, _ in feats] + list(stats) + list(diag.values())
    check(all(bool(torch.isfinite(torch.as_tensor(x)).all())
              for x in finite), f"{cfg.name} route: a feature, statistic or "
          f"diagnostic is not finite")
    # (c) bf16 on agent 0's first batch, (d) fp32 on one sequence
    tok0, tok1 = train[0][0][:1], train[0][0][0, :1]
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    blocks = {}
    for dtype, c, tok in (("bf16", cfg, tok0[0]), ("fp32", cfg32, tok1)):
        blocks[dtype] = timed(f"block_check_{dtype}_s",
                              lambda: block_errors(torch, params, c, tok))
        check(blocks[dtype]["norm_rel"] <= BLOCK_NORM_TOL[dtype]
              and (dtype == "bf16" or blocks[dtype]["rel"] <= TOL["fp32"]),
              f"{cfg.name} {dtype}: a block off its plain version on the "
              f"same input by {blocks[dtype]}, above {BLOCK_NORM_TOL[dtype]}"
              f" in norm or {TOL['fp32']} of max |plain| (fp32)")
    plain = timed("plain_check_bf16_s", lambda: pooled_features(
        params, cfg, tok0, use_kernel=False))
    abs_c, rel_c = rel_err(torch, feats[0][0][:1], plain)
    norm_c = norm_rel(torch, feats[0][0][:1], plain)
    h_k = timed("encode_fp32_one_seq_s",
                lambda: transformer.encode(params, cfg32, tok1))
    h_p = timed("plain_check_fp32_s", lambda: transformer.encode(
        params, cfg32, tok1, use_kernel=False))
    abs_d, rel_d = rel_err(torch, h_k, h_p)
    norm_d = norm_rel(torch, h_k, h_p)
    limits = END_TO_END_TOL[cfg.name]
    check(rel_c <= limits["bf16_rel"] and norm_c <= limits["bf16_norm_rel"],
          f"{cfg.name}: bf16 pooled features off their plain versions by "
          f"{rel_c:.3g} of max |plain|, {norm_c:.3g} in norm, above {limits}")
    check(rel_d <= limits["fp32_rel"], f"{cfg.name}: fp32 hidden states "
          f"off their plain versions by {rel_d:.3g}, above {limits}")
    record = {
        "config": cfg.name, "layers": cfg.n_layers,
        "params": transformer.param_count(params), "agents": m,
        "batches": n_batches, "batch": batch, "seq": seq, "L": L,
        "times_s": times,
        "launches": {k: n for k, n in launches.items() if want[k]},
        "accuracy": acc, "pcg_steps_per_solve": pcg_steps,
        "dmtl_objective": diag["objective"].tolist(),
        "dmtl_consensus": diag["consensus"].tolist(),
        "bf16_pooled_vs_plain": {"max_abs": abs_c, "rel": rel_c,
                                 "norm_rel": norm_c},
        "fp32_hidden_vs_plain": {"max_abs": abs_d, "rel": rel_d,
                                 "norm_rel": norm_d},
        "blocks_vs_plain_same_input": blocks,
        "end_to_end_limits": limits,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30}
    return record, params


# phase 5b: the checkpointed fit runs SLICE_ITERS iterations in segments of
# SLICE_EVERY, is stopped in process after the first segment, and in a child
# process (REPRO_CHECKPOINT_EXIT_AFTER_SAVE) after PREEMPT_AT
SLICE_ITERS, SLICE_EVERY, PREEMPT_AT = 12, 4, 8
# phase 5b (f): the baselines on the card against the same functions on
# the CPU, on the data and GO-MTL start of each of BASELINE_SEEDS.  In fp64
# within BASELINE_FP64_TOL of max |CPU| (on the CPU the port and the
# reference part by at most 7.5e-9 in fp64, tests/test_torch_baselines.py);
# in fp32 (TF32 off) within BASELINE_ROUNDOFF_FACTOR times the CPU fp32
# result's own distance from the CPU fp64 result (floored at 1e-6): fp32
# holds each to the roundoff of the function on these inputs, which DNSP's
# Newton solve amplifies to ~1e-2, and the card's solvers (cuSOLVER) round
# otherwise than the CPU's (LAPACK).  The same fp32 run with TF32 on is read
# beside it (``tf32_ratio``), the fault the fp32 gate is there to catch.
# On an H100 sound runs read up to 13x (DGSP on a seed whose CPU fp32
# result sits only 2.9e-5 from fp64) and TF32 runs 118x and more on DGSP
# and GO-MTL (PERF.md §6): 40 sits ~3x from each.  On MTFL and DNSP
# TF32 moves the result no further than the roundoff; their fp64 check is
# what holds the code.
BASELINE_FP64_TOL = 1e-7
BASELINE_ROUNDOFF_FACTOR = 40.0
BASELINE_SEEDS = (0, 1, 2, 3, 4)


def slice_inputs(torch):
    """Phase 5b's fit at phase 4's full width, drawn from phase 4's seeds:
    H (8, 8192, 2048) sigmoid hidden features of 256 inputs, one-hot T
    (8, 8192, 3), ring(8), r 8, PCG; fp32 stats on ``gram_tri``.  A child
    process that calls this gets the same bits."""
    from repro_torch.core import elm, engine, graph
    from repro_torch.data import synthetic

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    data = synthetic.multitask_classification(
        0, m=8, n_train=8192, n_test=1024, n_in=256, n_cls=3, device="cuda")
    fmap = elm.make_feature_map(1, n_in=256, L=2048, dist="normal",
                                device="cuda")
    cfg = engine.ConsensusConfig(r=8, mu1=1.0, mu2=1.0, tau=2.0, zeta=1.0,
                                 iters=SLICE_ITERS, u_solver="pcg")
    return fmap(data.X_train), data.Y_train, graph.ring(8), cfg


def preempted_fit(checkpoint_dir: str) -> None:
    """Phase 5b (c)'s child: the checkpointed fit of :func:`slice_inputs`,
    which ``REPRO_CHECKPOINT_EXIT_AFTER_SAVE`` ends after a save."""
    import torch

    from repro_torch.core import dmtl_elm

    H, T, g, cfg = slice_inputs(torch)
    dmtl_elm.fit(H, T, g, cfg, checkpoint_dir=checkpoint_dir,
                 checkpoint_every=SLICE_EVERY)
    sys.exit(3)     # the hook did not fire


def same_run(torch, label, got, want) -> None:
    """Phase 5b: a resumed fit equals the uninterrupted one bit for bit,
    state and every diagnostics key."""
    (st, diags), (st0, diags0) = got, want
    for name in ("U", "A", "lam"):
        check(torch.equal(getattr(st, name), getattr(st0, name)),
              f"{label}: resumed {name} differs from the uninterrupted fit")
    check(set(diags) == set(diags0),
          f"{label}: diagnostics keys {sorted(diags)} != {sorted(diags0)}")
    for key in diags0:
        check(torch.equal(diags[key], diags0[key]),
              f"{label}: resumed diagnostics {key!r} differ")


def spans_ms(tracer, name) -> list:
    return [s["dur"] / 1e3 for s in tracer.spans if s["name"] == name]


def interrupted_and_resumed(torch, label, H, T, g, cfg, ckpt) -> tuple:
    """Phase 5b (a), (b): the uninterrupted fit; the same fit stopped after
    its first segment (a truncated ``cfg.iters``, as the quickstart's
    demo stops it); the resumed fit, traced.  Holds the resumed fit against
    the uninterrupted one bit for bit; returns the fits and the times."""
    from repro_torch import obs
    from repro_torch.core import dmtl_elm

    out = {}
    t0 = time.perf_counter()
    want = dmtl_elm.fit(H, T, g, cfg)
    torch.cuda.synchronize()
    out["uninterrupted_fit_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dmtl_elm.fit(H, T, g, dataclasses.replace(cfg, iters=SLICE_EVERY),
                 checkpoint_dir=ckpt, checkpoint_every=SLICE_EVERY)
    torch.cuda.synchronize()
    out["interrupted_fit_s"] = time.perf_counter() - t0
    tracer = obs.Tracer()
    t0 = time.perf_counter()
    with obs.use(tracer):
        got = dmtl_elm.fit(H, T, g, cfg, checkpoint_dir=ckpt,
                           checkpoint_every=SLICE_EVERY, resume=True)
    torch.cuda.synchronize()
    out["resumed_fit_s"] = time.perf_counter() - t0
    same_run(torch, label, got, want)
    check(all(bool(torch.isfinite(v).all()) for v in want[1].values()),
          "checkpointed fit: diagnostics not finite")
    step = Path(ckpt) / f"step_{SLICE_EVERY:08d}"
    out.update(
        restore_s=[x / 1e3 for x in spans_ms(tracer, "restore")],
        snapshot_s=[x / 1e3 for x in spans_ms(tracer, "snapshot")],
        segment_span_ms=spans_ms(tracer, "segment"),
        stats_span_ms=spans_ms(tracer, "stats"),
        checkpoint_bytes=sum(f.stat().st_size for f in step.iterdir()),
        objective=[float(want[1]["objective"][0]),
                   float(want[1]["objective"][-1])],
    )
    check(len(out["restore_s"]) == 1 and len(out["segment_span_ms"])
          == (SLICE_ITERS - SLICE_EVERY) // SLICE_EVERY,
          f"resumed fit's trace: {len(out['restore_s'])} restores, "
          f"{len(out['segment_span_ms'])} segments")
    return out, want


def baseline_phase(torch) -> dict:
    """Phase 5b (f): MTFL, GO-MTL, DGSP and DNSP at ``usps_like()``'s
    shape on the card in fp64 and fp32, their predictions against the same
    functions on the CPU, for each of ``BASELINE_SEEDS``
    (``BASELINE_FP64_TOL``, ``BASELINE_ROUNDOFF_FACTOR``)."""
    from repro_torch import baselines
    from repro_torch.configs import paper
    from repro_torch.data import synthetic

    setup = paper.usps_like()
    methods = {
        "mtfl": lambda X, Y, Xt, L0: baselines.mtfl_predict(
            baselines.mtfl_fit(X, Y, gamma=10.0), Xt),
        "go_mtl": lambda X, Y, Xt, L0: baselines.gomtl_predict(
            *baselines.gomtl_fit(X, Y, L0, lam_s=0.05), Xt),
        "dgsp": lambda X, Y, Xt, L0: baselines.sp_predict(
            *baselines.dgsp_fit(X, Y, r=setup.r, lam=setup.mu), Xt),
        "dnsp": lambda X, Y, Xt, L0: baselines.sp_predict(
            *baselines.dnsp_fit(X, Y, r=setup.r, lam=setup.mu), Xt),
    }

    def rel(got, want):
        return float((got.cpu().double() - want.double()).abs().max()
                     / want.double().abs().max())

    out = {name: {"fp64_rel_err_vs_cpu": [], "fp32_rel_err_vs_cpu": [],
                  "cpu_fp32_vs_fp64": [], "fp32_ratio": [], "tf32_ratio": [],
                  "card_fp32_vs_cpu_fp64": [], "finite": True}
           for name in methods}
    for seed in BASELINE_SEEDS:
        data = synthetic.multitask_classification(
            seed, m=setup.m, n_train=setup.n_train, n_test=setup.n_test,
            n_in=setup.n_in, n_cls=setup.n_cls, class_sep=setup.class_sep,
            noise=setup.noise, latent_r=setup.latent_r, device="cpu")
        # GO-MTL's start, drawn on the host
        L0 = torch.randn((setup.n_in, setup.r),
                         generator=torch.Generator().manual_seed(seed)
                         ) / math.sqrt(setup.n_in)
        args = (data.X_train, data.Y_train, data.X_test, L0)
        for name, fn in methods.items():
            o = out[name]
            cpu32 = fn(*args)
            cpu64 = fn(*(a.double() for a in args))
            t0 = time.perf_counter()
            card32 = fn(*(a.cuda() for a in args))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            card64 = fn(*(a.double().cuda() for a in args))
            torch.backends.cuda.matmul.allow_tf32 = True
            try:
                tf32 = fn(*(a.cuda() for a in args))
            finally:
                torch.backends.cuda.matmul.allow_tf32 = False
            roundoff = max(rel(cpu32, cpu64), 1e-6)
            o["fp64_rel_err_vs_cpu"].append(rel(card64, cpu64))
            o["fp32_rel_err_vs_cpu"].append(rel(card32, cpu32))
            o["cpu_fp32_vs_fp64"].append(rel(cpu32, cpu64))
            o["fp32_ratio"].append(rel(card32, cpu32) / roundoff)
            o["tf32_ratio"].append(rel(tf32, cpu32) / roundoff)
            o["card_fp32_vs_cpu_fp64"].append(rel(card32, cpu64))
            o["finite"] &= bool(torch.isfinite(card32).all()
                                and torch.isfinite(card64).all())
            if seed == BASELINE_SEEDS[0]:
                o["first_call_s"] = seconds
                o["test_error_pct"] = float(synthetic.classification_error(
                    card32.cpu(), data.Y_test))
    emit({"phase": "baselines", "seeds": list(BASELINE_SEEDS),
          "fp32_limit_ratio": BASELINE_ROUNDOFF_FACTOR, **out})
    for name, o in out.items():
        check(o["finite"], f"{name}: not finite")
        check(max(o["fp64_rel_err_vs_cpu"]) <= BASELINE_FP64_TOL,
              f"{name}: fp64 card vs CPU {o['fp64_rel_err_vs_cpu']}")
        check(max(o["fp32_ratio"]) <= BASELINE_ROUNDOFF_FACTOR,
              f"{name}: fp32 card vs CPU, over the CPU's own fp32 roundoff, "
              f"{o['fp32_ratio']} > {BASELINE_ROUNDOFF_FACTOR}")
    return out


def checkpoint_phase(torch, kernel) -> dict:
    """Phase 5b: the checkpointed, traced fit (module docstring)."""
    from repro_torch import checkpoint, obs
    from repro_torch.core import dmtl_elm, graph

    H, T, ring, cfg = slice_inputs(torch)
    out = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        tmp = Path(tmp)
        # (a) ring(8) at full width
        out["ring"], want = interrupted_and_resumed(torch, "ring(8)", H, T,
                                                    ring, cfg, tmp / "a")
        # (b) star(8): the hub adds 7 terms in one segment sum
        H_s = H[..., :512].contiguous()
        out["star_L512"], _ = interrupted_and_resumed(
            torch, "star(8)", H_s, T, graph.star(8), cfg, tmp / "b")
        del H_s
        # (c) a real preemption: a child process killed by the hook
        child = ("import sys; sys.path.insert(0, {src!r}); "
                 "sys.path.insert(0, {root!r}); import chip_smoke; "
                 "chip_smoke.preempted_fit({ckpt!r})").format(
                     src=str(Path(__file__).resolve().parent / "src"),
                     root=str(Path(__file__).resolve().parent),
                     ckpt=str(tmp / "c"))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-c", child], capture_output=True, text=True,
            timeout=600, env={**os.environ,
                              "REPRO_CHECKPOINT_EXIT_AFTER_SAVE":
                                  str(PREEMPT_AT)})
        child_s = time.perf_counter() - t0
        steps = sorted(p.name for p in (tmp / "c").glob("step_*"))
        check(proc.returncode == 0,
              f"preempted child exited {proc.returncode}: "
              f"{proc.stderr[-2000:]}")
        check(checkpoint.latest_step(tmp / "c") == PREEMPT_AT,
              f"preempted child left {steps}")
        t0 = time.perf_counter()
        got = dmtl_elm.fit(H, T, ring, cfg, checkpoint_dir=tmp / "c",
                           checkpoint_every=SLICE_EVERY, resume=True)
        torch.cuda.synchronize()
        same_run(torch, "resumed after a preemption", got, want)
        out["preempt"] = {"child_s": child_s, "steps_left": steps,
                          "resume_s": time.perf_counter() - t0}
        # (d) the traced fit with telemetry
        kernel.reset_launches()
        t0 = time.perf_counter()
        st, diags = dmtl_elm.fit(
            H, T, ring, cfg, telemetry=True, trace_dir=tmp / "d",
            checkpoint_dir=tmp / "d_ckpt", checkpoint_every=SLICE_EVERY)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
        check(kernel.LAUNCHES["gram_tri"] == 1,
              f"traced fit launched gram_tri {kernel.LAUNCHES['gram_tri']} "
              f"times, not once")
        n_events = obs.validate_trace(tmp / "d" / "trace.json")
        report = json.loads((tmp / "d" / "report.json").read_text())
        check(report["health"]["healthy"], f"traced fit: {report['health']}")
        events = json.loads((tmp / "d" / "trace.json").read_text())[
            "traceEvents"]
        names = [e["name"] for e in events]
        check(names.count("stats") == 1
              and names.count("segment") == SLICE_ITERS // SLICE_EVERY,
              f"traced fit's spans: {sorted(set(names))}, "
              f"{names.count('segment')} segments")
        floats = obs.modeled_floats_per_iter(
            "dense", L=H.shape[-1], r=cfg.r, n_edges=ring.n_edges)
        check(bool((diags["msgs_delivered"] == 2 * ring.n_edges).all()),
              f"msgs_delivered {diags['msgs_delivered'].tolist()}")
        check(bool((diags["comm_floats"] == floats).all()),
              f"comm_floats {diags['comm_floats'].tolist()} != {floats}")
        same_run(torch, "telemetry on", (st, {k: diags[k] for k in want[1]}),
                 want)
        out["trace"] = {
            "fit_s": traced_s, "events": n_events,
            "launches": dict(kernel.LAUNCHES),
            "stats_span_ms": [e["dur"] / 1e3 for e in events
                              if e["name"] == "stats"],
            "segment_span_ms": [e["dur"] / 1e3 for e in events
                                if e["name"] == "segment"],
            "snapshot_s": [e["dur"] / 1e6 for e in events
                           if e["name"] == "snapshot"],
            "comm_floats_per_iter": floats,
            "resid_max_final": float(diags["resid_max"][-1]),
        }
        # (e) the health monitor stops a run it is set to find stalled
        hc = obs.HealthConfig(stall_window=2, stall_tol=10.0,
                              consensus_floor=0.0)
        _, diags = dmtl_elm.fit(H, T, ring, cfg, checkpoint_dir=tmp / "e",
                                checkpoint_every=2, health=hc)
        n_done = int(diags["objective"].shape[0])
        meta = checkpoint.read_meta(tmp / "e")["metadata"]
        check(n_done < cfg.iters and n_done % 2 == 0,
              f"health monitor ran {n_done} of {cfg.iters} iterations")
        check(meta.get("dnf_reason") == "consensus_stall",
              f"health monitor's snapshot metadata: {meta}")
        out["health"] = {"iterations": n_done, "metadata": meta}
    del H, T
    out["baselines"] = baseline_phase(torch)
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: {src / 'repro_torch'} not found; run from a "
              f"checkout of the repository", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))

    from repro_torch import backbone, configs, quickstart
    from repro_torch.core import elm, engine, graph, mtl_elm, solvers
    from repro_torch.data import pipeline, synthetic
    from repro_torch.kernels import _build
    from repro_torch.kernels.gram import kernel, ref
    from repro_torch.kernels.gram import ops as gram_ops
    from repro_torch.kernels.mlstm import kernel as mlstm_kernel
    from repro_torch.kernels.mlstm.ref import (
        mlstm_chunkwise_ref,
        mlstm_sequential_ref,
    )
    from repro_torch.kernels.rglru import kernel as rglru_kernel
    from repro_torch.kernels.rglru.ref import rglru_scan_ref
    from repro_torch.kernels.swa import kernel as swa_kernel
    from repro_torch.kernels.swa.ref import swa_ref
    from repro_torch.models import xlstm

    # 1. environment -----------------------------------------------------
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    emit({"phase": "env", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0],
          "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32})

    # 2. build -----------------------------------------------------------
    t0 = time.perf_counter()
    wrappers = {"gram": kernel, "swa": swa_kernel, "rglru": rglru_kernel,
                "mlstm": mlstm_kernel}
    with ThreadPoolExecutor(len(wrappers)) as pool:     # one nvcc per source
        list(pool.map(lambda w: _build.build(w.SOURCE), wrappers.values()))
    ptxas = {}
    for name, w in wrappers.items():
        w.library()
        ptxas[name] = ptxas_resources(_build.library_path(
            w.SOURCE).with_suffix(".log").read_text())
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": dict(_build.build_seconds), "ptxas": ptxas,
          "gram_wgmma_dynamic_smem_bytes":
              kernel.library().gram_wgmma_smem_bytes(),
          "gram_f32_dynamic_smem_bytes":
              kernel.library().gram_f32_smem_bytes(),
          "gram_q_dynamic_smem_bytes": kernel.library().gram_q_smem_bytes(),
          "swa_dynamic_smem_bytes": {
              str(dtype).removeprefix("torch."): {
                  D: swa_kernel.smem_bytes(D, dtype) for D in (64, 120, 256)}
              for dtype in (torch.float32, torch.bfloat16)}})

    # 3. kernels against their plain versions ------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_shape = (8, 2048, 2048, 3, 256)     # one stream batch of phase 4
    full_shape = (8, 8192, 2048, 8, 256)
    ragged_shape = (3, 1000, 300, 3, 70)
    t0 = time.perf_counter()
    cases = {"gram_tri": [], "gram_fused": [], "gram_tri_q": [],
             "gram_dense": []}
    cases["gram_tri"].append(kernel_case(
        torch, kernel, ref, "gram_tri", main_shape, "fp32", None, gen,
        "main_path"))
    cases["gram_fused"].append(kernel_case(
        torch, kernel, ref, "gram_fused", main_shape, "fp32", "sigmoid",
        gen, "main_path"))
    for label, shape in (("full", full_shape), ("ragged", ragged_shape)):
        for precision in ("fp32", "bf16"):
            cases["gram_tri"].append(kernel_case(
                torch, kernel, ref, "gram_tri", shape, precision, None, gen,
                label))
            for activation in ("sigmoid", "gelu"):
                cases["gram_fused"].append(kernel_case(
                    torch, kernel, ref, "gram_fused", shape, precision,
                    activation, gen, label))
    # fp32 gram_fused in three chunks (the workspace budget cut to 350 rows
    # of the ragged shape, as its test cuts it, then restored): later chunks
    # add into G and R
    row_bytes = ragged_shape[0] * kernel.fused_workspace_width(
        ragged_shape[2], "fp32") * 4
    budget = kernel.FUSED_WORKSPACE_BYTES
    kernel.FUSED_WORKSPACE_BYTES = 350 * row_bytes
    try:
        cases["gram_fused"].append(kernel_case(
            torch, kernel, ref, "gram_fused", ragged_shape, "fp32", "sigmoid",
            gen, "ragged_3_chunks"))
    finally:
        kernel.FUSED_WORKSPACE_BYTES = budget
    check(cases["gram_fused"][-1]["chunks"] == 3,
          f"gram_fused ragged_3_chunks ran {cases['gram_fused'][-1]['chunks']} "
          f"chunks, not 3")
    # bf16 gram_tri at the main path's shape, and a ragged N with
    # L % 8 == 0 but L % 128 != 0 (L = 300 above reads a padded copy of H)
    ragged_tc_shape = (3, 1000, 296, 3, 70)
    for label, shape in (("main_path", main_shape),
                         ("ragged_l296", ragged_tc_shape)):
        cases["gram_tri"].append(kernel_case(
            torch, kernel, ref, "gram_tri", shape, "bf16", None, gen, label))
    for label, shape, block_l in (("main_path", main_shape, 128),
                                  ("main_path_bl32", main_shape, 32),
                                  ("full", full_shape, 128),
                                  ("ragged", ragged_shape, 128)):
        cases["gram_tri_q"].append(kernel_case(
            torch, kernel, ref, "gram_tri_q", shape, "int8", None, gen,
            label, block_l=block_l))
    # one agent: the dense path's own shape first, then full and ragged
    dense_path_shape = (1, 8192, 2048, 3, 256)
    for label, shape, precisions in (
            ("main_path", dense_path_shape, ("fp32", "bf16")),
            ("full", full_shape, ("fp32", "bf16")),
            ("ragged", ragged_shape, ("fp32", "bf16")),
            ("ragged_l296", (1,) + ragged_tc_shape[1:], ("bf16",))):
        for precision in precisions:
            cases["gram_dense"].append(kernel_case(
                torch, kernel, ref, "gram_dense", shape, precision, None,
                gen, label))
    # swa: phase 6's call first, then recurrentgemma-2b's and h2o-danube's
    # widths at S = 8192, then a ragged case; rglru: phase 6's call, ragged
    cases["swa"] = [
        swa_case(torch, swa_kernel, swa_ref, shape, precision, gen, label)
        for label, shape, precision in (
            ("main_path", (8, 10, 1, 4096, 256, 2048), "bf16"),
            ("recurrentgemma_s8192", (1, 10, 1, 8192, 256, 2048), "fp32"),
            ("recurrentgemma_s8192", (1, 10, 1, 8192, 256, 2048), "bf16"),
            ("h2o_danube_s8192", (1, 32, 8, 8192, 120, 4096), "bf16"),
            ("ragged", (2, 4, 2, 1000, 64, 100), "fp32"),
            ("ragged", (2, 4, 2, 1000, 64, 100), "bf16"))]
    cases["rglru"] = [
        rglru_case(torch, rglru_kernel, rglru_scan_ref, (8, 4096, 2560), gen,
                   "main_path", h0_zero=True),
        rglru_case(torch, rglru_kernel, rglru_scan_ref, (3, 1000, 300), gen,
                   "ragged", h0_zero=False)]
    # mlstm: phase 8's call first (bf16, then fp32), then a ragged S, a long
    # memory at full width, input gates where e^-m is ~1e35 and +inf, and a
    # shape that the step-by-step oracle runs too
    refs = (mlstm_chunkwise_ref, mlstm_sequential_ref)
    cases["mlstm"] = [
        mlstm_case(torch, mlstm_kernel, refs, shape, precision, gen, label,
                   gates, sequential)
        for label, shape, precision, gates, sequential in (
            ("main_path", (8, 4, 4096, 1024, 256), "bf16", "std", False),
            ("main_path", (8, 4, 4096, 1024, 256), "fp32", "std", False),
            ("ragged", (2, 2, 1000, 64, 256), "fp32", "std", False),
            ("long_memory", (1, 4, 4096, 1024, 256), "bf16", "long", False),
            ("input_gate_-80", (2, 2, 1000, 64, 256), "fp32", "neg80",
             False),
            ("input_gate_-100", (2, 2, 1000, 64, 256), "fp32", "neg100",
             False),
            ("oracle", (1, 4, 1024, 1024, 256), "fp32", "std", True))]
    # every Gram case ran its dtype's body: the FMA body in fp32, the
    # tensor cores in bf16 (L = 300 from the padded copy of H); so did
    # every mlstm case (mma.sync with split operands in bf16)
    for name, tc in (("gram_tri", "wgmma"), ("gram_dense", "wgmma"),
                     ("gram_tri_q", "wgmma"), ("mlstm", "mma")):
        for c in cases[name]:
            want = "fma" if c["dtype"] == "fp32" else tc
            check(c["body"] == want, f"{name} {c['case']} {c['dtype']} ran "
                  f"the {c['body']} body, not {want}")
    kernels_seconds = time.perf_counter() - t0
    emit({"phase": "kernels", "seconds": kernels_seconds,
          "cases": {k: len(v) for k, v in cases.items()}})

    # 4. main path at full width --------------------------------------------
    m, n_train, n_test, n_in, L, r = 8, 8192, 1024, 256, 2048, 8
    batch = 2048
    t0 = time.perf_counter()
    data = synthetic.multitask_classification(
        0, m=m, n_train=n_train, n_test=n_test, n_in=n_in, n_cls=3,
        device="cuda")
    fmap = elm.make_feature_map(1, n_in=n_in, L=L, dist="normal",
                                device="cuda")
    batches = [(data.X_train[:, k:k + batch].contiguous(),
                data.Y_train[:, k:k + batch].contiguous())
               for k in range(0, n_train, batch)]
    torch.cuda.synchronize()
    times = {"data_s": time.perf_counter() - t0}
    cfg = engine.ConsensusConfig(r=r, mu1=1.0, mu2=1.0, tau=2.0, zeta=1.0,
                                 iters=8, u_solver="pcg")
    ring = graph.ring(m)

    def timed(name, fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times[name] = time.perf_counter() - t
        return out

    pcg_steps = []      # per PCG solve of the DMTL fit, steps per agent
    engine.U_SOLVERS["pcg_counted"] = counted_pcg(solvers, pcg_steps)
    kernel.reset_launches()
    stats = timed("stats_fused_s", lambda: pipeline.stream_sufficient_stats(
        batches, producer="fused", feature_map=fmap))
    stats_mat = timed("stats_materialized_s",
                      lambda: pipeline.stream_sufficient_stats(
                          (fmap(x), y) for x, y in batches))
    state, diag = timed("dmtl_fit_s", lambda: engine.fit_dense(
        stats, ring, dataclasses.replace(cfg, u_solver="pcg_counted")))
    # FO-DMTL-ELM's step is stable only for tau_t above Theorem 2's bound
    # L_t + rho m (delta + 1/2) sigma_max, with L_t = ||G_t|| ||A_t A_t^T||
    # taken at the all-ones start (||A A^T|| = r d)
    d_out = stats.R.shape[-1]
    fo_tau = (torch.linalg.eigvalsh(stats.G)[:, -1] * r * d_out
              + cfg.rho * m * (cfg.delta + 0.5) * 2.0)
    fo_state, fo_diag = timed("fo_fit_s", lambda: engine.fit_dense(
        stats, ring, dataclasses.replace(cfg, first_order=True,
                                         tau=fo_tau)))
    mtl_state, mtl_obj = timed("mtl_fit_s", lambda: mtl_elm.mtl_elm_fit_from_stats(
        stats, mtl_elm.MTLELMConfig(r=r, mu1=1.0, mu2=1.0, iters=3,
                                    u_solver="cg")))
    launches = dict(kernel.LAUNCHES)
    for name in ("gram_tri", "gram_fused"):
        check(launches[name] > 0, f"main path never launched {name}")

    for leaf in ("G", "R"):
        a, b = getattr(stats, leaf), getattr(stats_mat, leaf)
        _, rel = rel_err(torch, a, b)
        check(rel <= TOL["fp32"],
              f"fused vs materialized stats {leaf}: {rel:.3g}")
    stats_plain = timed("stats_plain_s", lambda: pipeline.stream_sufficient_stats(
        batches, producer="fused", feature_map=fmap, use_kernel=False))
    _, plain_diag = timed("dmtl_fit_plain_s",
                          lambda: engine.fit_dense(stats_plain, ring, cfg))
    traj = {}
    for key in ("objective", "consensus"):
        a, b = diag[key], plain_diag[key]
        traj[key] = float(((a - b).abs() / b.abs()).max())
        check(traj[key] <= 1e-3,
              f"{key} trajectory off the plain path by {traj[key]:.3g}")

    H_te = fmap(data.X_test)
    eye = torch.eye(L, device="cuda")
    beta = torch.linalg.solve(stats.G + 1.0 * eye, stats.R)
    err = {
        "local_elm": float(synthetic.classification_error(H_te @ beta,
                                                          data.Y_test)),
        "dmtl_elm": float(synthetic.classification_error(
            H_te @ state.U @ state.A, data.Y_test)),
        "mtl_elm": float(synthetic.classification_error(
            H_te @ mtl_state.U @ mtl_state.A, data.Y_test)),
    }
    for name, value in err.items():
        check(math.isfinite(value) and value < 200 / 3,
              f"{name} test error {value} is not below chance")
    # FO's Theorem-2 step is tiny at this scale: 8 iterations barely move U
    err["fo_dmtl_elm"] = float(synthetic.classification_error(
        H_te @ fo_state.U @ fo_state.A, data.Y_test))
    for name, d in (("dmtl", diag), ("fo", fo_diag)):
        check(all(bool(torch.isfinite(v).all()) for v in d.values()),
              f"{name} diagnostics not finite")
    check(bool(torch.isfinite(mtl_obj).all()), "mtl objective not finite")
    check(math.isfinite(err["fo_dmtl_elm"]), "fo test error not finite")
    emit({"phase": "main_path", "times_s": times, "launches": launches,
          "test_error_pct": err,
          "dmtl_objective": diag["objective"].tolist(),
          "dmtl_consensus": diag["consensus"].tolist(),
          "max_rel_diff_vs_plain_path": traj,
          "pcg_steps_per_solve": pcg_steps,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})

    def test_error(U, A):
        return float(synthetic.classification_error(H_te @ U @ A,
                                                    data.Y_test))

    # 4b. the int8 stream (stats_precision="int8") and a DMTL fit from it
    kernel.reset_launches()
    stats_q = timed("stats_int8_s", lambda: pipeline.stream_sufficient_stats(
        ((fmap(x), y) for x, y in batches), precision="int8"))
    q_state, q_diag = timed("dmtl_fit_int8_s",
                            lambda: engine.fit_dense(stats_q, ring, cfg))
    launches["gram_tri_q"] = kernel.LAUNCHES["gram_tri_q"]
    check(launches["gram_tri_q"] == len(batches),
          f"int8 stream launched gram_tri_q {launches['gram_tri_q']} times, "
          f"not once per batch ({len(batches)})")
    check(all(bool(torch.isfinite(v).all()) for v in q_diag.values()),
          "int8 dmtl diagnostics not finite")
    # (U, A) of the int8 fit scored on the fp32 stats, beside the fp32 fit's
    obj_fp32 = float(engine.objective_from_stats(stats, state.U, state.A,
                                                 cfg.mu1, cfg.mu2))
    obj_q = float(engine.objective_from_stats(stats, q_state.U, q_state.A,
                                              cfg.mu1, cfg.mu2))
    _, g_rel = rel_err(torch, stats_q.G, stats.G)
    err["dmtl_elm_int8"] = test_error(q_state.U, q_state.A)
    check(math.isfinite(err["dmtl_elm_int8"])
          and err["dmtl_elm_int8"] < 200 / 3,
          f"int8 dmtl test error {err['dmtl_elm_int8']} is not below chance")
    check(g_rel <= 5e-2, f"int8 stats G off the fp32 stats by {g_rel:.3g}")

    # 4c. the colored Gauss-Seidel executor on the fp32 stats
    gs_state, gs_diag = timed("colored_fit_s", lambda: engine.fit_colored(
        stats, ring, cfg))
    check(all(bool(torch.isfinite(v).all()) for v in gs_diag.values()),
          "colored diagnostics not finite")
    err["dmtl_elm_colored"] = test_error(gs_state.U, gs_state.A)
    check(err["dmtl_elm_colored"] < 200 / 3,
          f"colored test error {err['dmtl_elm_colored']} is not below chance")
    # Its trajectory held at a tolerance.  The all-ones start is symmetric
    # in U's r columns, so at r >= 2 every executor's trajectory follows
    # fp32 roundoff: there the staleness-1 sweep, the dense fit's
    # arithmetic run one class at a time, parts from the dense fit (printed,
    # not checked).  At r = 1 the card's sweeps (fixed and Gauss-Southwell
    # order) are held against the same sweeps in fp64 on the CPU, and the
    # staleness-1 sweep against the dense fit: the objective at 1e-5, the
    # consensus residual at 1e-2 (fp32 alone moves it by a few 1e-3).
    _, st1_diag = timed("colored_fit_staleness1_s", lambda: engine.fit_colored(
        stats, ring, cfg, staleness=1))
    cfg1 = dataclasses.replace(cfg, r=1)
    stats64 = engine.SufficientStats(
        *(x.cpu().double() if torch.is_tensor(x) else x for x in stats))

    def traj_gap(a, b, key):
        x, y = a[key].cpu().double(), b[key].cpu().double()
        return float(((x - y).abs() / y.abs()).max())

    colored_traj = {f"r{r}_staleness1_vs_dense_objective_unchecked":
                    traj_gap(st1_diag, diag, "objective")}
    pairs = {"staleness1_vs_dense": (
        engine.fit_colored(stats, ring, cfg1, staleness=1)[1],
        engine.fit_dense(stats, ring, cfg1)[1])}
    for order in ("fixed", "gauss_southwell"):
        pairs[f"{order}_vs_cpu_fp64"] = tuple(
            engine.fit_colored(st, ring, cfg1, order=order)[1]
            for st in (stats, stats64))
    for name, (a, b) in pairs.items():
        for key, tol in (("objective", 1e-5), ("consensus", 1e-2)):
            gap = traj_gap(a, b, key)
            colored_traj[f"r1_{name}_{key}"] = gap
            check(gap <= tol, f"colored r=1 {name} {key} trajectory off by "
                  f"{gap:.3g}, above {tol}")

    # 4d. the dense-baseline op on agent 0's full-width hidden features
    H0 = fmap(data.X_train[0])
    kernel.reset_launches()
    G0, R0 = timed("gram_dense_op_s", lambda: gram_ops.gram(
        H0, data.Y_train[0], variant="dense"))
    launches["gram_dense"] = kernel.LAUNCHES["gram_dense"]
    check(launches["gram_dense"] == 1, "ops.gram(variant='dense') did not "
          "launch gram_dense once")
    for a, b, leaf in ((G0, stats_mat.G[0], "G"), (R0, stats_mat.R[0], "R")):
        _, rel = rel_err(torch, a, b)
        check(rel <= TOL["fp32"], f"dense-op {leaf} vs stream stats: {rel:.3g}")

    # 4e. the bf16 materialized stream (stats_precision="bf16"): gram_tri on
    # the tensor-core body, once per batch, against the same stream's plain
    # version
    kernel.reset_launches()
    kernel.LAST_GRAM.update(kernel=None, body=None)
    stats_bf16 = timed("stats_bf16_s", lambda: pipeline.stream_sufficient_stats(
        ((fmap(x), y) for x, y in batches), precision="bf16"))
    launches["gram_tri_bf16_stream"] = kernel.LAUNCHES["gram_tri"]
    check(launches["gram_tri_bf16_stream"] == len(batches),
          f"bf16 stream launched gram_tri {launches['gram_tri_bf16_stream']} "
          f"times, not once per batch ({len(batches)})")
    check(kernel.LAST_GRAM["body"] == "wgmma", f"bf16 stream ran the "
          f"{kernel.LAST_GRAM['body']} body, not wgmma")
    stats_bf16_plain = pipeline.stream_sufficient_stats(
        ((fmap(x), y) for x, y in batches), precision="bf16", use_kernel=False)
    bf16_stream_err = {}
    for leaf in ("G", "R"):
        _, bf16_stream_err[leaf] = rel_err(torch, getattr(stats_bf16, leaf),
                                           getattr(stats_bf16_plain, leaf))
        check(bf16_stream_err[leaf] <= TOL["bf16"], f"bf16 stream {leaf} off "
              f"its plain version by {bf16_stream_err[leaf]:.3g}")
    del stats_bf16, stats_bf16_plain
    emit({"phase": "main_path_slice2", "times_s": times,
          "launches": launches, "test_error_pct": err,
          "int8_stats_G_rel_err": g_rel,
          "bf16_stream_vs_plain_rel_err": bf16_stream_err,
          "int8_fit_objective_on_fp32_stats": obj_q,
          "fp32_fit_objective": obj_fp32,
          "int8_objective_rel_gap": (obj_q - obj_fp32) / abs(obj_fp32),
          "colored_objective": gs_diag["objective"].tolist(),
          "colored_consensus": gs_diag["consensus"].tolist(),
          "colored_max_rel_diff": colored_traj})

    # 4f. the int8 and colored objective gaps over a longer run: the dense
    # fp32, int8 and colored fits to 32 iterations, read at 8, 16 and 32,
    # at r = 8 and at r = 1
    horizon = {}
    t0 = time.perf_counter()
    for rank in (r, 1):
        long_cfg = dataclasses.replace(cfg, r=rank, iters=32)
        runners = {
            "dense": engine.make_runner(stats, ring, long_cfg),
            "int8": engine.make_runner(stats_q, ring, long_cfg),
            "colored": engine.make_runner(stats, ring, long_cfg,
                                          executor="colored"),
        }
        states = {k: run.init_state() for k, run in runners.items()}
        for stop in (8, 16, 32):
            row = {}
            for name, runner in runners.items():
                states[name], d = runner.run_segment(states[name],
                                                     stop - states[name].k)
                st = states[name]
                row[name] = {
                    # every fit's (U, A) scored on the fp32 stats
                    "objective": float(engine.objective_from_stats(
                        stats, st.U, st.A, cfg.mu1, cfg.mu2)),
                    "consensus": float(d["consensus"][-1]),
                    "test_error_pct": test_error(st.U, st.A),
                }
                check(math.isfinite(row[name]["objective"]),
                      f"r={rank} {name} objective at {stop} not finite")
            obj = row["dense"]["objective"]
            for name in ("int8", "colored"):
                row[f"{name}_objective_rel_gap"] = (
                    row[name]["objective"] - obj) / abs(obj)
            horizon[f"r{rank}_iter{stop}"] = row
    emit({"phase": "horizon", "seconds": time.perf_counter() - t0,
          "at": horizon})

    # 5. quickstart ----------------------------------------------------------
    t0 = time.perf_counter()
    qs = quickstart.main(device="cuda")
    emit({"phase": "quickstart", "seconds": time.perf_counter() - t0,
          "test_mse": {k: qs[k] for k in ("local", "mtl", "dmtl", "fo",
                                          "gs")}})

    # 5b. the checkpointed, traced fit -----------------------------------------
    t0 = time.perf_counter()
    slice_run = checkpoint_phase(torch, kernel)
    emit({"phase": "checkpointed_fit", "seconds": time.perf_counter() - t0,
          **slice_run})
    torch.cuda.empty_cache()

    # 6. the backbone route at full recurrentgemma-2b width -------------------
    route6, params = backbone_route(
        torch, configs.get_config("recurrentgemma-2b"), wrappers, n_batches=2)
    emit({"phase": "backbone_route", **route6})
    del params
    torch.cuda.empty_cache()

    # 7. the backbone example as written ----------------------------------------
    for w in wrappers.values():
        w.reset_launches()
    t0 = time.perf_counter()
    bb = backbone.main(device="cuda")
    check(kernel.LAUNCHES["gram_fused"] == backbone.N_BATCHES,
          f"backbone example launched gram_fused "
          f"{kernel.LAUNCHES['gram_fused']} times, not {backbone.N_BATCHES}")
    check(math.isfinite(float(bb["objective"][-1])),
          "backbone example objective not finite")
    emit({"phase": "backbone_example", "seconds": time.perf_counter() - t0,
          "accuracy": bb["accuracy"], "launches": dict(kernel.LAUNCHES)})

    # 8. the backbone route at full xlstm-1.3b width -----------------------------
    xl = configs.get_config("xlstm-1.3b")
    route8, params = backbone_route(torch, xl, wrappers, n_batches=2)
    # one mLSTM and one sLSTM block apart, at the route's (8, 4096, d_model)
    kinds = xl.layer_kinds()
    x = torch.randn(8, 4096, xl.d_model, device="cuda",
                    generator=gen).to(torch.bfloat16)
    with torch.no_grad():
        block_ms = {kind: time_ms(torch, lambda kind=kind: getattr(
            xlstm, f"{kind}_block")(params["layers"][kinds.index(kind)][kind],
                                    xl, x)) for kind in ("mlstm", "slstm")}
    # one encode of agent 0's first batch split by block kind, the mLSTM
    # blocks' time into the kernel's calls inside them and the rest
    tokens = next(backbone.token_batches(
        torch.Generator(device="cuda").manual_seed(1), 1, n=8, seq=4096,
        m=4))[0][0]
    with torch.no_grad():
        split = encode_by_kind(torch, params, xl, tokens)
    check(split["mlstm_calls"] == kinds.count("mlstm"),
          f"one encode called mlstm {split['mlstm_calls']} times")
    split["mlstm_outside_kernel"] = split["mlstm"] - split["mlstm_kernel"]
    emit({"phase": "backbone_route_xlstm", **route8, "block_ms": block_ms,
          "one_encode_by_kind_s": split})
    del params, x, tokens
    torch.cuda.empty_cache()

    sources = {"gram_tri": "src/repro/kernels/gram/kernel.py:224",
               "gram_fused": "src/repro/kernels/gram/kernel.py:464",
               "gram_tri_q": "src/repro/kernels/gram/kernel.py:334",
               "gram_dense": "src/repro/kernels/gram/kernel.py:138",
               "swa": "src/repro/kernels/swa/kernel.py:78",
               "rglru": "src/repro/kernels/rglru/kernel.py:42",
               "mlstm": "src/repro/kernels/mlstm/kernel.py:89"}
    ported = {name: "src/repro_torch/kernels/gram/csrc/gram.cu"
              for name in ("gram_tri", "gram_fused", "gram_tri_q",
                           "gram_dense")}
    ported["swa"] = "src/repro_torch/kernels/swa/csrc/swa.cu"
    ported["rglru"] = "src/repro_torch/kernels/rglru/csrc/rglru.cu"
    ported["mlstm"] = "src/repro_torch/kernels/mlstm/csrc/mlstm.cu"
    # 9. the profiler's device split of the Gram cases and of mlstm's
    # grids, after every timed phase
    gram_device_splits(torch, kernel, cases, gen)
    mlstm_device_splits(torch, mlstm_kernel, cases, gen)
    launches.update(swa=route6["launches"]["swa"],
                    rglru=route6["launches"]["rglru"],
                    mlstm=route8["launches"]["mlstm"])
    rows = []
    for name, cs in cases.items():
        top = cs[0]     # the main path's shape
        rows.append({
            "name": name, "route": "cuda", "source": ported[name],
            "replaces": sources[name], "launches": launches[name],
            "max_abs_err": top["max_abs_err"], "ms": top["kernel_ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
            **({"body": top["body"]} if "body" in top else {}),
            "cases": cs,
        })
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
