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
     (``SWA_NORM_TOL``), and phase 8b's prefill in fp32 and bf16;
     ``rglru`` at phase 6's shape, a ragged one with h0 != 0 and phase
     8b's decode step (B = 4, S = 1, h0 != 0); ``mlstm`` at phase 8's call in
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
  5c. the event-tape async executor (``repro_torch.netsim``) at phase 4's
     width (ring(8), star(8), r = 8, 12 ticks, the Sylvester solve),
     stats from one ``gram_tri`` launch: (a) the zero-delay tape against
     ``fit_dense``, live and aged duals, on ring(8) and star(8), and (b) a
     zero-attack ``AdversaryTape`` against its base channel tape, both bit
     for bit in the state and every diagnostics row; (c) an async fit with
     a channel and aged duals stopped after its first segment and resumed,
     bit for bit the uninterrupted fit (``interrupted_and_resumed``); (d)
     at r = 1 and L = ``ASYNC_L``, a lossy channel with stragglers and
     ``coordinate_median`` under churn held against the same runs in fp64
     on the CPU (``ASYNC_FP64_TOL``, PCG); (e) one sign-flipping agent at
     full width under every aggregator, finite with every key, the audit's
     rejections on hypercube(3) and none on the clean tape; deliveries sum
     to 2E every tick; the seconds per tick of each executor;
  5d. the sharded executors (``repro_torch.core.mesh``): 8 ranks on the
     card over gloo (each message copied through a host buffer), one agent
     each, on phase 4's inputs: (a) ``fit(executor="sharded")`` on ring(8)
     from each rank's own rows of H and T, one ``gram_tri`` launch per rank,
     its G and R against row t of the parent's 8-agent launch; (b) at
     r = 8, 12 iterations, the Sylvester solve: ``fit_sharded`` on the
     (8,) and (2, 4) tori, ``fit_sharded_graph`` on star(8) and
     hypercube(3), Jacobian and Gauss-Seidel (its chromatic schedule), and
     bit for bit a zero-delay tape (live and aged duals) against the
     no-tape run, a zero-attack tape against its base channel tape, and
     the channel run stopped at 4 and resumed from rank 0's checkpoint;
     each, also at r = 1, against ``fit_dense``/``fit_colored`` on the
     card in the objective and U·A (``SHARD_DENSE_TOL`` at r = 1, beside
     the dense run's own gap when G moves by an ulp), with seconds per
     iteration beside theirs; (c) at r = 1 and L = 512 (PCG), the ring and the
     Gauss-Seidel cube against fp64 on the CPU (``SHARD_FP64_TOL``);
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
  8b. the serving path (``prefill``, ``decode_step``, ``generate``, the
     continuous-batching engine): (a) recurrentgemma-2b at full width and
     depth in fp32, 2 prompts of 2100 tokens (the 2048-slot rings wrap in
     prefill) and 16 greedy decode steps, each step's logits against the
     last position of a train-mode forward over the sequence
     (``SERVE_FP32_TOL``); (b) the same model in bf16, 4 prompts of 2560
     and 32 steps, the kernels against their plain versions and an int8
     KV cache against the bf16 one, in norm; prefill seconds, ms per
     decode step, peak memory; (c) the engine in fp32, 8 requests of
     64-2300 prompt tokens and 4-12 new ones through 3 slots, each against
     its own batch-1 ``generate``; (d) xlstm-1.3b at full width, 8 layers
     (7 mLSTM + 1 sLSTM), 2 prompts of 1000, each mLSTM block's final
     (C, n, m) against ``mlstm_chunkwise_ref``'s, 8 decode steps against
     the forward; (e) ``python -m repro_torch.serve`` as written.  Each
     prefill launched ``swa``, ``rglru`` and ``mlstm`` once per block of
     their kind and each decode step ``rglru`` once per RG-LRU block, and
     nothing else;
  8c. the MoE kind, prefix embeddings and encoder-decoders (seeded fp32
     weights): (a) granite-moe-3b-a800m at full width and depth (32
     layers, bf16 compute) through phase 6's route, 2 ``gram_fused``
     launches and nothing else, every MoE block's FFN against
     ``moe_ffn_by_expert`` on the same input (``MOE_ORACLE_TOL``), one
     encode's MoE share, the drop share at capacity factor 1.25 per layer
     and the summed aux; (b) its serving path in fp32: 2 prompts of 1024
     and 8 decode steps against the forward at a drop-free capacity
     factor (``drop_free``), and the engine at 1.25, 8 requests of 64-1500
     prompt tokens through 3 slots, each against its batch-1 ``generate``;
     (c) qwen3-moe-30b-a3b at full width, 8 of 48 layers: a bf16 encode of
     8 x 4096 at 1.25 with its blocks against the oracle, and 2 x 512 fp32
     decode steps against the forward drop-free; (d) llava-next-34b at full
     width, 4 of 60 layers: 2 rows of 2880 prefix embeddings and 64 tokens,
     8 fp32 decode steps against the forward; (e) seamless-m4t-large-v2 at
     full width and depth (12 + 12 layers): enc_embeds (2, 1024, 1024), 2 x
     256 tokens, the prefilled ``ck``/``cv`` equal to the cross k and v of
     the encoder memory, 8 fp32 decode steps against the forward, and one
     ``pooled_features(..., enc_embeds=)`` into ``gram_fused``.  Depth is
     cut where fp32 weights would not fit the card (qwen3-moe 122 GB,
     llava 137 GB whole);
  8d. the training path: (a) recurrentgemma-2b at full width and depth
     (26 layers, seeded fp32 weights, bf16 compute, remat on: the train
     variant) through ``repro_torch.launch.train.main``, 5 AdamW steps of
     2 x 2048 tokens (train_4k's 256 x 4096 cut for memory and time): each
     step's loss, ce, grad_norm, lr and seconds, the peak memory, the
     step's analytic FLOPs and achieved TFLOP/s, and no ``gram``/``swa``/
     ``rglru``/``mlstm`` launch (the step runs their plain versions);
     (b) on the same seeded weights: the loss through the kernel forward
     (``use_kernel=True``, no grad: 8 ``swa`` and 18 ``rglru`` launches)
     against the plain forward a step differentiates (``TOL["bf16"]`` of
     |loss|); in fp32, the gradient of 2 microbatches against 1
     (``MICROBATCH_TOL`` in norm over all leaves, beside the same run
     twice); the central difference of the loss along g / |g| against |g|
     (``FD_TOL``); (c) the model axis: ``moe_ffn_shardmap`` in a world of
     4 gloo ranks on the card, mesh (data 2, model 2), one
     granite-moe-3b-a800m MoE layer at full width in fp32, drop-free, 4 x
     1024 tokens: the gathered output and the expert weights' gradients
     (summed over data, gathered over F) against ``moe_ffn_gspmd`` on the
     whole batch (``MOE_ORACLE_TOL`` fp32), the aux equal;
  8e. the pod tooling: (a) ``python -m repro_torch.launch.dryrun`` (no card:
     a fake world of 256 ranks, meta tensors) of recurrentgemma-2b at
     train_4k and decode_32k and granite-moe-3b-a800m at train_4k on the
     (16, 16) mesh, each in a process of its own, started with the script
     (they need neither the card nor a build) and read here: its JSON's
     keys, params against the meta tree, granite's experts on the
     expert-FF fallback at model 16; (b) recurrentgemma-2b's parameters
     and AdamW moments as ``param_specs(fsdp="data")``/``opt_specs`` shard
     them over 4 gloo ranks on the card as (data 2, model 2): each rank's
     allocator growth against the plan's bytes (each tensor rounded to 512
     bytes), and ``unshard`` of the embedding's and one swa, RG-LRU and MLP
     layer's parts bit-equal to the whole leaves; (c) the data-parallel
     step on 2 gloo ranks (recurrentgemma-2b cut to 2 layers, fp32, 2 x
     512 a rank, labels padded over another share on each) against one
     process on the whole batch (``MICROBATCH_TOL`` in norm: gradients,
     updated parameters, loss); no kernel launches in (a)-(c);
  9. the ``gram_tri`` and ``gram_dense`` cases of phase 3 at the main
     path's and the full shape, and the bf16 ragged ones, split by
     ``torch.profiler`` into device time per kernel, theirs and the
     library call's, and ``mlstm`` at phase 8's call in bf16 and fp32 into
     its four grids: last, because a profiler session slows the host side
     of every later launch in the process.

The last four lines of standard output are the script's seconds so far
(``{"phase": "total", ...}``), the ``{"kernels": ...}`` JSON line, the
card's name and power limit from nvidia-smi, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import atexit
import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor
import math
import os
import re
import shutil
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
    # phase 8c (a): no granite-moe block runs a kernel, so the "kernel"
    # path and its plain version are the same code and must agree exactly
    "granite-moe-3b-a800m": {"bf16_rel": 0.0, "bf16_norm_rel": 0.0,
                             "fp32_rel": 0.0},
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


def all_launches(wrappers) -> dict:
    return {name: n for w in wrappers.values() for name, n in w.LAUNCHES.items()}


def reset_all(wrappers) -> None:
    for w in wrappers.values():
        w.reset_launches()


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
            o = transformer.mixer(layer, cfg, kind, h)[0].float()
            o_p = transformer.mixer(layer, cfg, kind, h,
                                    use_kernel=False)[0].float()
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
    reset_all(wrappers)
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
    launches = all_launches(wrappers)
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


def interrupted_and_resumed(torch, label, H, T, g, cfg, ckpt, interrupt=None,
                            **fit_kw) -> tuple:
    """Phase 5b (a), (b) and 5c (c): the uninterrupted fit; the same fit
    stopped after its first segment (by default a truncated ``cfg.iters``,
    as the quickstart's demo stops it; ``interrupt(ckpt)`` stops it
    otherwise); the resumed fit, traced.  ``fit_kw`` goes to every
    ``dmtl_elm.fit``.  Holds the resumed fit against the uninterrupted one
    bit for bit; returns the fits and the times."""
    from repro_torch import obs
    from repro_torch.core import dmtl_elm

    out = {}
    t0 = time.perf_counter()
    want = dmtl_elm.fit(H, T, g, cfg, **fit_kw)
    torch.cuda.synchronize()
    out["uninterrupted_fit_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if interrupt is None:
        dmtl_elm.fit(H, T, g, dataclasses.replace(cfg, iters=SLICE_EVERY),
                     checkpoint_dir=ckpt, checkpoint_every=SLICE_EVERY,
                     **fit_kw)
    else:
        interrupt(ckpt)
    torch.cuda.synchronize()
    out["interrupted_fit_s"] = time.perf_counter() - t0
    tracer = obs.Tracer()
    t0 = time.perf_counter()
    with obs.use(tracer):
        got = dmtl_elm.fit(H, T, g, cfg, checkpoint_dir=ckpt,
                           checkpoint_every=SLICE_EVERY, resume=True,
                           **fit_kw)
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


# phase 5c: the async executor at phase 4's width.  ASYNC_L is the width
# of the runs held against fp64 on the CPU (G's and R's leading block, as
# phase 5b's star case); those run PCG, whose fp32 roundoff is within phase
# 4c's limits, where the Sylvester solve's fp32 eigh moves the consensus
# residual by ~2e-2 against fp64 at this width (on the CPU too)
ASYNC_L = 512
ASYNC_FP64_TOL = {"objective": 1e-5, "consensus": 1e-2}
ASYNC_AGGREGATORS = ("mean", "trimmed_mean", "coordinate_median",
                     "krum_like")


def timed_run(torch, runner, repeats: int = 2):
    """Drive ``runner`` to its end from its start ``repeats`` times: (state,
    diags, the least seconds of the iterations alone, the runner's set-up
    and hoisted eigh left out, the first run warming the libraries)."""
    secs = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, diags = runner.run()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return state, diags, min(secs)


def async_phase(torch, kernel) -> dict:
    """Phase 5c: the event-tape async executor (module docstring)."""
    from repro_torch import checkpoint, netsim, obs
    from repro_torch.core import engine, graph

    t_phase = time.perf_counter()
    H, T, ring, cfg = slice_inputs(torch)
    cfg = dataclasses.replace(cfg, u_solver="sylvester", iters=SLICE_ITERS,
                              telemetry=True)
    star, cube = graph.star(8), graph.hypercube(3)
    L, iters = H.shape[-1], cfg.iters
    out = {"iters": iters, "L": L, "r": cfg.r}
    kernel.reset_launches()
    stats = engine.produce_stats(H, T)
    torch.cuda.synchronize()
    out["stats_launches"] = {"gram_tri": kernel.LAUNCHES["gram_tri"]}
    check(kernel.LAUNCHES["gram_tri"] == 1,
          f"async phase's stats pass launched gram_tri "
          f"{kernel.LAUNCHES['gram_tri']} times, not once")

    def finite(diags):
        return all(bool(torch.isfinite(v.double()).all())
                   for v in diags.values())

    def deliveries(label, g, diags):
        total = (diags["msgs_delivered"] + diags["msgs_stale"]
                 + diags["msgs_dropped"])
        check(bool((total == 2 * g.n_edges).all()),
              f"{label}: deliveries per tick {total.tolist()} != 2E = "
              f"{2 * g.n_edges}")

    # (a) zero-delay tape == fit_dense, bit for bit, ring(8) and star(8),
    # live and aged duals; one dense run first warms the libraries for the
    # per-tick times
    timed_run(torch, engine.make_runner(stats, ring, cfg), repeats=1)
    per_tick = {}
    for gname, g in (("ring", ring), ("star", star)):
        dense = timed_run(torch, engine.make_runner(stats, g, cfg))
        per_tick[f"dense_{gname}"] = dense[2] / iters
        for aged in (False, True):
            st, diags, secs = timed_run(torch, engine.make_runner(
                stats, g, cfg, executor="async",
                tape=netsim.zero_delay_tape(iters, g), aged_duals=aged))
            label = f"zero-delay tape on {gname}(8), aged_duals={aged}"
            same_run(torch, label, (st, {k: diags[k] for k in dense[1]}),
                     dense[:2])
            check(bool((diags["tape_cursor"].cpu()
                        == torch.arange(iters)).all()),
                  f"{label}: tape_cursor {diags['tape_cursor'].tolist()}")
            per_tick[f"async_zero_delay_{gname}_aged{int(aged)}"] = \
                secs / iters

    # (b) a zero-attack AdversaryTape == its base channel tape
    base = netsim.ChannelModel(delay="geometric", scale=2.0, drop=0.1,
                               straggler_prob=0.2, seed=0).sample(ring, iters)
    zero_adv = netsim.AdversaryModel().sample(ring, iters, L=L, r=cfg.r,
                                              base=base)
    runs = {}
    for name, tape in (("channel", base), ("zero_attack", zero_adv)):
        runs[name] = timed_run(torch, engine.make_runner(
            stats, ring, cfg, executor="async", tape=tape, aged_duals=True))
        per_tick[f"async_{name}_ring_aged1"] = runs[name][2] / iters
        deliveries(f"{name} tape", ring, runs[name][1])
    same_run(torch, "zero-attack AdversaryTape against its base tape",
             runs["zero_attack"][:2], runs["channel"][:2])
    out["channel_tape"] = netsim.tape_summary(base)
    out["channel_counters_per_tick"] = {
        k: runs["channel"][1][k].tolist()
        for k in ("msgs_delivered", "msgs_stale", "msgs_dropped")}
    del runs

    # (c) fit(executor="async", channel=...) stopped after a segment and
    # resumed == the uninterrupted fit, through interrupted_and_resumed; the
    # interruption is the runner's first segment on the same sampled tape
    # (a shorter cfg.iters would sample another tape)
    channel = netsim.ChannelModel(delay="geometric", scale=2.0, drop=0.1,
                                  straggler_prob=0.2, seed=1)
    fit_kw = dict(executor="async", channel=channel, aged_duals=True)

    def interrupt(ckpt):
        runner = engine.make_runner(
            engine.produce_stats(H, T), ring, cfg, executor="async",
            tape=channel.sample(ring, iters), aged_duals=True)
        state, diags = runner.run_segment(runner.init_state(), SLICE_EVERY)
        checkpoint.save_run_checkpoint(
            ckpt, state, diags, metadata={"executor": "async",
                                          "iters": iters})

    with tempfile.TemporaryDirectory(prefix="chip_smoke_async_") as tmp:
        out["resume"], _ = interrupted_and_resumed(
            torch, "async fit on ring(8)", H, T, ring, cfg,
            Path(tmp) / "c", interrupt=interrupt, **fit_kw)

    # (d) at r = 1 and L = ASYNC_L, held against fp64 on the CPU: a lossy
    # channel with stragglers, and coordinate_median under churn
    small = engine.SufficientStats(
        G=stats.G[:, :ASYNC_L, :ASYNC_L].contiguous(),
        R=stats.R[:, :ASYNC_L].contiguous(), n=stats.n, t2=stats.t2)
    small64 = engine.SufficientStats(
        *(x.cpu().double() if torch.is_tensor(x) else x for x in small))
    cfg1 = dataclasses.replace(cfg, r=1, u_solver="pcg", telemetry=False)
    churn = netsim.AdversaryModel(churn=((3, 2, 7),), seed=0).sample(
        ring, iters, L=ASYNC_L, r=1)
    fp64 = {}
    for name, tape, c in (
            ("channel", base, cfg1),
            ("coordinate_median_churn", churn,
             dataclasses.replace(cfg1, aggregator="coordinate_median"))):
        card = engine.fit_async(small, ring, c, tape)[1]
        cpu = engine.fit_async(small64, ring, c, tape)[1]
        for key, tol in ASYNC_FP64_TOL.items():
            x, y = card[key].cpu().double(), cpu[key]
            gap = float(((x - y).abs() / y.abs()).max())
            fp64[f"{name}_{key}"] = gap
            check(gap <= tol, f"async {name} {key} off the CPU's fp64 run "
                  f"by {gap:.3g}, above {tol}")
    out["max_rel_diff_vs_cpu_fp64"] = fp64
    del small, small64

    # (e) one sign-flipping agent at full width, every aggregator: finite,
    # every key, deliveries 2E a tick.  The audit counts rejections under
    # attack on hypercube(3) (degree 3), none on the clean tape; on a ring
    # it cannot flag one attacker (of two neighbor candidates the median
    # distance is their mean), so ring(8)'s counts are printed beside the
    # final consensus of each aggregator
    keys = set(engine.DIAG_KEYS) | set(engine.TELEMETRY_KEYS) | {
        "tape_cursor", "comm_floats"}
    attack = {}
    for gname, g, aggs in (("ring", ring, ASYNC_AGGREGATORS),
                           ("hypercube", cube, ASYNC_AGGREGATORS[1:3])):
        tape = netsim.AdversaryModel(n_byzantine=1, kinds=("sign_flip",),
                                     seed=0).sample(g, iters, L=L, r=cfg.r)
        clean = netsim.zero_adversary_tape(netsim.zero_delay_tape(iters, g),
                                           L, cfg.r)
        for agg in aggs:
            c = dataclasses.replace(cfg, aggregator=agg)
            _, diags = engine.fit_async(stats, g, c, tape)
            label = f"sign_flip on {gname}, {agg}"
            check(finite(diags), f"{label}: not finite")
            check(set(diags) == keys, f"{label}: keys {sorted(diags)}")
            deliveries(label, g, diags)
            row = {"consensus_final": float(diags["consensus"][-1]),
                   "objective_final": float(diags["objective"][-1]),
                   "agg_rejected": float(diags["agg_rejected"].sum())}
            if agg != "mean":
                _, cdiags = engine.fit_async(stats, g, c, clean)
                row["agg_rejected_clean"] = float(
                    cdiags["agg_rejected"].sum())
                check(row["agg_rejected_clean"] == 0.0,
                      f"{label}: the clean tape's audit rejected "
                      f"{row['agg_rejected_clean']}")
                if gname == "hypercube":
                    check(row["agg_rejected"] > 0,
                          f"{label}: the audit rejected nothing")
            attack[f"{gname}_{agg}"] = row
    out["sign_flip"] = attack
    out["s_per_tick"] = per_tick
    out["comm_floats_per_tick"] = obs.modeled_floats_per_iter(
        "async", L=L, r=cfg.r, n_edges=ring.n_edges)
    del H, T, stats
    out["seconds"] = time.perf_counter() - t_phase
    return out


# phase 5d: the sharded executors, one agent per rank.  SHARD_WORLD ranks
# share the one card over gloo (NCCL refuses two ranks on one device), each
# CUDA tensor message copied through a host buffer, on phase 4's inputs
# (slice_inputs) at r = SHARD_R; the fp64 runs take H's first SHARD_L64
# columns at r = 1 with PCG, held to the limits phase 5c's fp64 runs meet
# on an H100 (readings 1.4e-7 and 4.4e-4, PERF.md §6).  SHARD_DENSE_TOL
# holds the sharded runs against fit_dense / fit_colored on the card at
# full width and r = 1, in the objective and in U·A per agent.  Beside
# each pair the script prints the dense executor's own gap when G is
# multiplied by 1 + 2^-23 (its entries moved by at most an ulp): the size
# of the roundoff that one agent's eigh and solves, rounding otherwise than
# the batched ones, can leave.  At r = 1 on an NVIDIA H100 80GB HBM3 at
# 700 W the sharded objective read 1.8e-7 to 4.4e-7 and U·A 1.6e-2 to
# 4.6e-2, the dense runs' one-ulp gaps 7.1e-7 to 2.6e-6 and 0.18 to 0.21
# (PERF.md §6): the fp32 Sylvester solve leaves U·A to roundoff at this
# width, which the objective, flat at the optimum, does not see, and the
# U·A limit sits between the sound readings and the one-ulp ones.  At
# r = SHARD_R the all-ones start is symmetric in U's columns, so both
# trajectories follow roundoff: there the gaps are printed, not checked.
SHARD_WORLD, SHARD_R, SHARD_L64 = 8, 8, 512
SHARD_FP64_TOL = {"objective": 1e-6, "consensus": 1e-3}
SHARD_DENSE_TOL = {"objective": 1e-5, "UA": 1e-1}
SHARD_TIMEOUT_S = 300.0
# each sharded run of phase 5d and the card's executor it is held against
SHARD_DENSE_PAIRS = {"torus8": "ring", "torus24": "torus24", "star8": "star8",
                     "cube": "cube", "cube_gauss_seidel": "cube_gauss_seidel"}


def shard_config():
    from repro_torch.core import engine

    return engine.ConsensusConfig(r=SHARD_R, mu1=1.0, mu2=1.0, tau=2.0,
                                  zeta=1.0, iters=SLICE_ITERS,
                                  u_solver="sylvester", telemetry=True)


def sharded_world(rank: int, t_spawn: float, tmp: str) -> dict:
    """Phase 5d's rank ``rank`` (module level: a spawned rank imports it).
    Keeps its agent's rows of H and T only, runs every sharded case, and
    returns what the parent checks, on the CPU."""
    import torch

    from repro_torch import checkpoint, netsim, obs
    from repro_torch.core import dmtl_elm, engine, graph
    from repro_torch.core.mesh import make_mesh
    from repro_torch.kernels.gram import kernel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    H, T, _, _ = slice_inputs(torch)
    H, T = H[rank:rank + 1].clone(), T[rank:rank + 1].clone()
    torch.cuda.empty_cache()
    mesh = make_mesh((SHARD_WORLD,), ("a",), device="cuda")
    mesh24 = make_mesh((2, SHARD_WORLD // 2), ("pod", "data"), device="cuda")
    ring, star, cube = (graph.ring(SHARD_WORLD), graph.star(SHARD_WORLD),
                        graph.hypercube(3))
    cfg = shard_config()
    iters = cfg.iters

    def cpu(state, diags):
        return {"U": state.U.cpu(), "A": state.A.cpu(),
                "diags": {k: v.cpu() for k, v in diags.items()}}

    out = {"rank": rank, "transport": mesh.transport,
           "ready_s": time.time() - t_spawn}
    # (a) the entry point on this agent's own rows: one gram_tri launch
    kernel.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    U, A, diags = dmtl_elm.fit(H, T, ring, cfg, executor="sharded",
                               mesh=mesh, agent_axes=("a",))
    torch.cuda.synchronize()
    out["fit_s"] = time.perf_counter() - t0
    out["fit_launches"] = dict(kernel.LAUNCHES)
    out["fit_ring"] = {"U": U.cpu(), "A": A.cpu(),
                       "diags": {k: v.cpu() for k, v in diags.items()}}
    st = engine.produce_stats(H, T)
    out["G"], out["R"] = st.G[0].cpu(), st.R[0].cpu()
    L = H.shape[-1]
    del H, T

    # (b) every executor at full width, each run twice (the least time)
    base = netsim.ChannelModel(delay="geometric", scale=2.0, drop=0.1,
                               straggler_prob=0.2, seed=0).sample(cube, iters)
    zero = netsim.zero_delay_tape(iters, cube)
    cases = {
        "torus8": dict(g=None, mesh=mesh, agent_axes=("a",)),
        "torus24": dict(g=None, mesh=mesh24, agent_axes=("pod", "data")),
        "star8": dict(g=star, executor="sharded_graph"),
        "cube": dict(g=cube, executor="sharded_graph"),
        "cube_gauss_seidel": dict(g=cube, executor="sharded_graph",
                                  schedule=cube.chromatic_schedule()),
        "cube_zero_delay_aged0": dict(g=cube, executor="sharded_graph",
                                      tape=zero),
        "cube_zero_delay_aged1": dict(g=cube, executor="sharded_graph",
                                      tape=zero, aged_duals=True),
        "cube_channel": dict(g=cube, executor="sharded_graph", tape=base,
                             aged_duals=True),
        "cube_zero_attack": dict(
            g=cube, executor="sharded_graph", aged_duals=True,
            tape=netsim.zero_adversary_tape(base, L, cfg.r)),
    }

    def runner_of(kw, c=cfg):
        kw = {"executor": "sharded", "mesh": mesh, "agent_axes": ("a",),
              **kw}
        return engine.make_runner(st, kw.pop("g"), c, **kw)

    # the untaped runs twice (the least time), the taped ones once
    runs, secs = {}, {}
    for name, kw in cases.items():
        runner = runner_of(dict(kw))
        times = []
        for _ in range(1 if "tape" in kw else 2):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, diags = runner.run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
        runs[name] = cpu(state, diags)
        secs[name] = min(times) / iters
    out["runs"], out["s_per_iter"] = runs, secs
    cfg_r1 = dataclasses.replace(cfg, r=1)
    out["r1"] = {name: cpu(*runner_of(dict(cases[name]), cfg_r1).run())
                 for name in SHARD_DENSE_PAIRS}

    # (c) the channel run stopped at SLICE_EVERY and resumed from rank 0's
    # checkpoint of the gathered state
    every = SLICE_EVERY
    ckpt = Path(tmp) / "ckpt"
    runner = runner_of(dict(cases["cube_channel"]))
    state, diags = runner.run_segment(runner.init_state(), every)
    if rank == 0:
        checkpoint.save_run_checkpoint(
            ckpt, state, diags, metadata={"executor": runner.executor,
                                          "iters": iters})
    mesh.barrier()
    out["checkpoint_bytes"] = sum(
        f.stat().st_size for f in (ckpt / f"step_{every:08d}").iterdir())
    tracer = obs.Tracer()
    with obs.use(tracer):
        state, diags = checkpoint.run_checkpointed(
            runner_of(dict(cases["cube_channel"])), checkpoint_dir=ckpt,
            checkpoint_every=every, resume=True)
    out["resumed"] = cpu(state, diags)
    out["restore_s"] = [x / 1e3 for x in spans_ms(tracer, "restore")]
    out["snapshot_s"] = [x / 1e3 for x in spans_ms(tracer, "snapshot")]

    # (d) r = 1 at SHARD_L64 with PCG, for the fp64 references on the CPU
    L64 = SHARD_L64
    small = engine.SufficientStats(
        G=st.G[:, :L64, :L64].contiguous(), R=st.R[:, :L64].contiguous(),
        n=st.n, t2=st.t2)
    cfg1 = dataclasses.replace(cfg, r=1, u_solver="pcg", telemetry=False)
    out["fp64_ring"] = engine.fit_sharded(small, mesh, ("a",), cfg1)[2]
    out["fp64_cube_gauss_seidel"] = engine.fit_sharded_graph(
        small, mesh, ("a",), cube, cfg1,
        schedule=cube.chromatic_schedule())[2]
    for key in ("fp64_ring", "fp64_cube_gauss_seidel"):
        out[key] = {k: v.cpu() for k, v in out[key].items()}
    return out


def sharded_phase(torch, kernel) -> dict:
    """Phase 5d: the sharded executors, one agent per rank (module
    docstring)."""
    from repro_torch.core import engine, graph
    from repro_torch.core.mesh import spawn

    t_phase = time.perf_counter()
    H, T, _, _ = slice_inputs(torch)
    kernel.reset_launches()
    stats = engine.produce_stats(H, T)
    L = H.shape[-1]
    del H, T
    cfg = shard_config()
    iters = cfg.iters
    ring, star, cube = (graph.ring(SHARD_WORLD), graph.star(SHARD_WORLD),
                        graph.hypercube(3))
    torus24 = graph.Graph(m=SHARD_WORLD, edges=tuple(sorted(
        engine.torus_edges([2, SHARD_WORLD // 2]))))
    gs = cube.chromatic_schedule()
    out = {"world": SHARD_WORLD, "L": L, "r": cfg.r, "iters": iters,
           "L64": SHARD_L64}

    # the fp64 references on the CPU, and fit_dense / fit_colored on the
    # card on the same stats (one warm-up run first)
    L64 = SHARD_L64
    small64 = engine.SufficientStats(
        G=stats.G[:, :L64, :L64].cpu().double(),
        R=stats.R[:, :L64].cpu().double(), n=stats.n.cpu(),
        t2=stats.t2.cpu())
    cfg1 = dataclasses.replace(cfg, r=1, u_solver="pcg", telemetry=False)
    fp64 = {"fp64_ring": engine.fit_dense(small64, ring, cfg1)[1],
            "fp64_cube_gauss_seidel": engine.fit_colored(
                small64, cube, cfg1, schedule=gs, staleness=0)[1]}
    del small64
    timed_run(torch, engine.make_runner(stats, ring, cfg), repeats=1)
    graphs = {"ring": ring, "torus24": torus24, "star8": star, "cube": cube,
              "cube_gauss_seidel": cube}
    def cpu(st, diags):
        return {"U": st.U.cpu(), "A": st.A.cpu(),
                "diags": {k: v.cpu() for k, v in diags.items()}}

    # each dense run also on G·(1 + 2^-23), the roundoff witness
    stats_ulp = stats._replace(G=stats.G * (1 + 2**-23))
    cfg_r1 = dataclasses.replace(cfg, r=1)
    dense, dense_s, dense_r1, dense_ulp, dense_r1_ulp = {}, {}, {}, {}, {}
    for name, g in graphs.items():
        kw = ({"executor": "colored", "schedule": gs}
              if name == "cube_gauss_seidel" else {})
        st, diags, secs = timed_run(torch, engine.make_runner(stats, g, cfg,
                                                              **kw))
        dense[name] = cpu(st, diags)
        dense_s[name] = secs / iters
        dense_r1[name] = cpu(*engine.make_runner(stats, g, cfg_r1,
                                                 **kw).run())
        dense_r1_ulp[name] = cpu(*engine.make_runner(stats_ulp, g, cfg_r1,
                                                     **kw).run())
    dense_ulp["ring"] = cpu(*engine.make_runner(stats_ulp, ring, cfg).run())
    del stats_ulp

    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as tmp:
        t0 = time.perf_counter()
        ranks = spawn(sharded_world, SHARD_WORLD, backend="gloo",
                      device="cuda", timeout_s=SHARD_TIMEOUT_S,
                      args=(time.time(), tmp))
        out["world_s"] = time.perf_counter() - t0
    res = ranks[0]
    out["transport"] = res["transport"]
    out["gram_tri_launches_per_rank"] = [
        r["fit_launches"].get("gram_tri", 0) for r in ranks]
    for t, r in enumerate(ranks):
        check(r["rank"] == t and r["transport"] == res["transport"],
              f"rank {t}: {r['rank']}, transport {r['transport']}")
        check(r["fit_launches"].get("gram_tri") == 1
              and sum(r["fit_launches"].values()) == 1,
              f"rank {t}'s sharded fit launched {r['fit_launches']}, not "
              f"gram_tri once")
    # each rank's statistics against row t of the parent's 8-agent launch
    stats_err, stats_equal = [], []
    for t, r in enumerate(ranks):
        for leaf in ("G", "R"):
            want = getattr(stats, leaf)[t].cpu()
            stats_equal.append(bool(torch.equal(r[leaf], want)))
            stats_err.append(rel_err(torch, r[leaf], want)[1])
    out["stats_bit_equal"] = all(stats_equal)
    out["stats_max_rel_err"] = max(stats_err)
    check(out["stats_max_rel_err"] <= TOL["fp32"],
          f"a rank's statistics off the 8-agent gram_tri by "
          f"{out['stats_max_rel_err']:.3g}")
    # every rank returns the same gathered state and diagnostics
    for r in ranks[1:]:
        for name in res["runs"]:
            check(torch.equal(r["runs"][name]["U"], res["runs"][name]["U"])
                  and all(torch.equal(v, res["runs"][name]["diags"][k])
                          for k, v in r["runs"][name]["diags"].items()),
                  f"rank {r['rank']}'s {name} differs from rank 0's")

    def same(got, want):
        return (torch.equal(got["U"], want["U"])
                and torch.equal(got["A"], want["A"])
                and all(torch.equal(got["diags"][k], v)
                        for k, v in want["diags"].items()))

    runs = res["runs"]
    out["bitwise"] = {
        "zero_delay_tape_live_duals": same(runs["cube_zero_delay_aged0"],
                                           runs["cube"]),
        "zero_delay_tape_aged_duals": same(runs["cube_zero_delay_aged1"],
                                           runs["cube"]),
        "zero_attack_tape": same(runs["cube_zero_attack"],
                                 runs["cube_channel"]),
        "resumed_at_%d" % SLICE_EVERY: same(res["resumed"],
                                              runs["cube_channel"]),
    }
    for name, ok in out["bitwise"].items():
        check(ok, f"sharded identity {name} is not bit for bit")
    keys = set(engine.DIAG_KEYS) | set(engine.TELEMETRY_KEYS) | {
        "comm_floats"}
    for name, run in runs.items():
        check(keys <= set(run["diags"]) and all(
            bool(torch.isfinite(v.double()).all())
            for v in run["diags"].values()),
            f"sharded {name}: keys {sorted(run['diags'])} or not finite")
    # against fp64 on the CPU, r = 1
    gaps = {}
    for name, want in fp64.items():
        for key, tol in SHARD_FP64_TOL.items():
            x, y = res[name][key].double(), want[key].double()
            gap = float(((x - y).abs() / y.abs()).max())
            gaps[f"{name}_{key}"] = gap
            check(gap <= tol, f"sharded {name} {key} off the CPU's fp64 run "
                  f"by {gap:.3g}, above {tol}")
    out["max_rel_diff_vs_cpu_fp64"] = gaps
    # against fit_dense / fit_colored on the card: checked at r = 1, read at
    # r = 8 beside the dense executor's gap to its reversed edge list
    def gap(got, want):
        x = got["diags"]["objective"].double()
        y = want["diags"]["objective"].double()
        ua, ua_d = got["U"] @ got["A"], want["U"] @ want["A"]
        return {"objective": float(((x - y).abs() / y.abs()).max()),
                "UA": float(((ua - ua_d).flatten(1).norm(dim=1)
                             / ua_d.flatten(1).norm(dim=1)).max())}

    r1_gaps, r1_ulp = {}, {}
    for name, dname in SHARD_DENSE_PAIRS.items():
        r1_gaps[name] = gap(res["r1"][name], dense_r1[dname])
        r1_ulp[dname] = gap(dense_r1_ulp[dname], dense_r1[dname])
        for key, tol in SHARD_DENSE_TOL.items():
            check(r1_gaps[name][key] <= tol,
                  f"sharded {name} at r = 1 {key} off the card's dense run "
                  f"by {r1_gaps[name][key]:.3g}, above {tol}")
    r8_gaps = {name: gap(runs[name], dense[dname])
               for name, dname in SHARD_DENSE_PAIRS.items()}
    r8_gaps["fit_ring"] = gap(res["fit_ring"], dense["ring"])
    r8_gaps["dense_ring_G_times_1_plus_2^-23"] = gap(dense_ulp["ring"],
                                                     dense["ring"])
    out["r1_rel_diff_vs_card_dense"] = r1_gaps
    out["r1_dense_G_times_1_plus_2^-23"] = r1_ulp
    out[f"r{cfg.r}_rel_diff_vs_card_dense_unchecked"] = r8_gaps
    out["s_per_iter"] = res["s_per_iter"]
    out["dense_s_per_iter"] = dense_s
    out["fit_s"] = [r["fit_s"] for r in ranks]
    out["ranks_ready_s"] = [r["ready_s"] for r in ranks]
    out.update(checkpoint_bytes=res["checkpoint_bytes"],
               snapshot_s=res["snapshot_s"], restore_s=res["restore_s"])
    out["seconds"] = time.perf_counter() - t_phase
    return out


# phase 8b: the serving path.  SERVE_FP32_TOL bounds, as a share of max
# |logit|, fp32 decode logits against the last position of a train-mode
# forward over the same sequence, and an engine request's logits against its
# batch-1 generate (both with fp32 caches).  It sits between the sound
# readings and those of two broken copies of the decode path
# (tools/serving_mutant_check.py; PERF.md section 6): sound 1.7e-6
# (recurrentgemma-2b, 26 layers), 5.2e-5 (xlstm-1.3b, 8 layers: its
# mLSTM decode step sums C in another order than the kernel); a ring slot
# off by one 7.0e-4 to 1.6e-3 a step; a conv state not carried 9.6e-2.
SERVE_FP32_TOL = 2e-4
# bf16 logits in norm: the kernels against their plain versions on the same
# tokens, and int8 KV caches against bf16 ones.  A random 26-layer
# recurrentgemma-2b amplifies a perturbation of ~2^-9 of an element about
# tenfold into its logits at one position, so both sit on a noise floor
# (tools/serving_mutant_check.py --part bf16; PERF.md section 6): the bf16
# path against itself with k and v rounded once more reads 2.22e-2; kernels
# against plain 2.01e-2, int8 against bf16 2.31e-2.  Subtle faults hide in
# that floor: int8 truncation 2.36e-2 and an int8 scale one ulp up 2.30e-2
# (INT8_ROW_TOL catches both), the swa kernel called with a window one
# short 2.22e-2 (not caught here).  Each limit sits below a gross fault:
# the rglru kernel from a zero state 3.26e-2, int8 scales written one slot
# on 6.21e-2.
SERVE_BF16_NORM_TOL = 2.7e-2
SERVE_INT8_NORM_TOL = 3.5e-2
# an int8 KV element as read back against the bf16 value it was written
# from, as a share of the bound that round-half-even quantization with a
# bf16 scale meets (int8_row_err): 1, and 1e-3 for the fp32 rounding of
# x / s.  A bound, not a reading: sound 1.0000033; int8 truncation 2.00, a
# scale one ulp up 2.97, scales written one slot on 221.
INT8_ROW_TOL = 1.001
# the mLSTM's final (C, n) after a prefill against mlstm_chunkwise_ref's,
# of max |ref|, and m in absolute terms: the same fp32 sums in two orders
SERVE_STATE_TOL = TOL["fp32"]
# (c): prompts and new tokens of the engine's 8 requests, 3 slots
ENGINE_PROMPTS = (64, 2300, 700, 1800, 128, 2100, 1024, 333)
ENGINE_MAX_NEW = (4, 12, 7, 9, 5, 11, 6, 8)
ENGINE_SLOTS = 3


def last_logits(torch, params, cfg, seq, use_kernel: bool = True,
                **frontend):
    """The train-mode forward over ``seq`` (B, S) (after ``prefix_embeds``,
    or over the memory of ``enc_embeds``, in ``frontend``), unembedding only
    the last position: (B, vocab) fp32 (full logits at S = 2116 would be
    4.3 GB)."""
    from repro_torch.models import transformer

    with torch.no_grad():
        x, _ = transformer.forward_features(params, cfg, seq,
                                            use_kernel=use_kernel, **frontend)
        return transformer.head_logits(params, cfg, x[:, -1])


def expected_launches(cfg, wrappers, prefills: int = 0, steps: int = 0):
    """What the serving path must launch: each prefill ``swa``, ``rglru`` and
    ``mlstm`` once per block of their kind, each decode step ``rglru`` once
    per RG-LRU block, and nothing else."""
    kinds = cfg.layer_kinds()
    want = dict.fromkeys(all_launches(wrappers), 0)
    want.update(swa=prefills * kinds.count("swa"),
                mlstm=prefills * kinds.count("mlstm"),
                rglru=(prefills + steps) * kinds.count("rglru"))
    return want


def serve_vs_forward(torch, params, cfg, wrappers, prompt, steps: int,
                     **frontend):
    """Phases 8b (a), (d) and 8c: ``prefill`` (fp32 caches), then ``steps``
    greedy ``decode_step`` calls, each call's logits against the last
    position of a train-mode forward over the whole sequence so far
    (``frontend``: ``prefix_embeds`` or ``enc_embeds``, to both).  The
    launches of the prefill and of each decode step are read apart (the
    forward's own launches are not counted).  No limit is checked here:
    returns the record, with the prefill's cache entries under
    "prefill_layers"."""
    from repro_torch.models import transformer

    B, S = prompt.shape
    P = frontend["prefix_embeds"].shape[1] if "prefix_embeds" in frontend \
        else 0
    reset_all(wrappers)
    torch.cuda.synchronize()
    t = time.perf_counter()
    lg, cache = transformer.prefill(params, cfg, prompt, P + S + steps,
                                    cache_dtype=torch.float32, **frontend)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    prefill_launches = all_launches(wrappers)
    # the prefill's entries (a decode step writes KV lines in place, and
    # returns new recurrent states)
    prefill_layers = list(cache["layers"])
    errs = [rel_err(torch, lg[:, -1], last_logits(torch, params, cfg,
                                                  prompt, **frontend))[1]]
    seq, step_launches, step_ms = prompt, [], []
    for _ in range(steps):
        nt = lg[:, -1].argmax(-1, keepdim=True)
        seq = torch.cat([seq, nt], dim=1)
        reset_all(wrappers)
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, cache = transformer.decode_step(params, cfg, nt, cache)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        step_launches.append(all_launches(wrappers))
        errs.append(rel_err(torch, lg[:, -1], last_logits(
            torch, params, cfg, seq, **frontend))[1])
    finite = bool(torch.isfinite(lg).all())
    return {"B": B, "P": P, "S": S, "steps": steps, "prefill_s": prefill_s,
            "decode_ms_median": statistics.median(step_ms),
            "logits_vs_forward_rel": errs, "max_rel": max(errs),
            "finite": finite, "prefill_launches": prefill_launches,
            "step_launches": step_launches, "prefill_layers": prefill_layers}


def check_serve_launches(cfg, wrappers, rec, label) -> None:
    want = expected_launches(cfg, wrappers, prefills=1)
    check(rec["prefill_launches"] == want, f"{label}: prefill launched "
          f"{rec['prefill_launches']}, expected {want}")
    want = expected_launches(cfg, wrappers, steps=1)
    for i, got in enumerate(rec["step_launches"]):
        check(got == want, f"{label}: decode step {i} launched {got}, "
              f"expected {want}")


def greedy_logits(torch, params, cfg, prompt, steps: int, max_len: int,
                  **kw):
    """``prefill`` and ``steps`` greedy ``decode_step`` calls, as
    ``generate`` runs them: (the (B, 1) tokens decoded, the (B, vocab)
    logits of the prefill and of each step).  ``kw`` goes to both (the
    prefill also takes ``cache_dtype``)."""
    from repro_torch.models import transformer

    step_kw = {k: v for k, v in kw.items() if k != "cache_dtype"}
    lg, cache = transformer.prefill(params, cfg, prompt, max_len, **kw)
    tokens, logits = [], [lg[:, -1]]
    for _ in range(steps):
        tokens.append(lg[:, -1].argmax(-1, keepdim=True))
        lg, cache = transformer.decode_step(params, cfg, tokens[-1], cache,
                                            **step_kw)
        logits.append(lg[:, -1])
    return tokens, logits


def kv_lines(torch, cfg, cache, first_only: bool = False):
    """The (k, v) lines of a cache's attention entries (of the first one
    only, with ``first_only``), read into fp32: ``kvquant.read_all`` for
    int8 lines."""
    from repro_torch.models.kvquant import QuantizedKV, read_all

    out = []
    for kind, entry in zip(cfg.layer_kinds(), cache["layers"]):
        if kind in ("attn", "swa"):
            out += [read_all(x, torch.float32) if isinstance(x, QuantizedKV)
                    else x.float() for x in (entry["k"], entry["v"])]
            if first_only:
                break
    return out


def replay_logits(torch, params, cfg, prompt, tokens, max_len: int, **kw):
    """``prefill`` and one ``decode_step`` for each of ``tokens``, whatever
    the logits say: (the (B, vocab) logits of the prefill and of each step,
    ``kv_lines`` right after the prefill, and of the first attention entry
    after the first step)."""
    from repro_torch.models import transformer

    lg, cache = transformer.prefill(params, cfg, prompt, max_len, **kw)
    after_prefill = kv_lines(torch, cfg, cache)
    logits, first_step = [lg[:, -1]], None
    for nt in tokens:
        lg, cache = transformer.decode_step(params, cfg, nt, cache, **kw)
        logits.append(lg[:, -1])
        if first_step is None:
            first_step = kv_lines(torch, cfg, cache, first_only=True)
    return logits, after_prefill, first_step


def int8_row_err(torch, int8_lines, lines, slot=None) -> float:
    """The largest error of an int8 KV element as read back (``read_all``
    into fp32) against the bf16 value x it was written from, as a share of
    the bound that sound quantization meets: with s = max|x| / 127 in fp32
    and s_b = bf16(s), q = round(x / s) errs by s/2 at most and the stored
    scale by |q| |s_b - s|, so |q s_b - x| <= s/2 + (|x|/s + 1/2) |s_b - s|
    (INT8_ROW_TOL).  ``slot``: that slot of each line only."""
    worst = 0.0
    for got, want in zip(int8_lines, lines):
        if slot is not None:
            got, want = got[:, slot], want[:, slot]
        s = torch.clamp(want.abs().amax(-1, keepdim=True), min=1e-6) / 127.0
        ds = (s.to(torch.bfloat16).float() - s).abs()
        bound = 0.5 * s + (want.abs() / s + 0.5) * ds
        worst = max(worst, float(((got - want).abs() / bound).max()))
    return worst


def serve_bf16(torch, params, cfg, wrappers, prompt, steps: int) -> dict:
    """Phase 8b (b): bf16 compute.  ``generate``-style greedy decoding with
    the kernels, then on the same tokens the kernels' plain versions
    (``use_kernel=False``) and an int8 KV cache (``kv_quant=True``), each
    step's logits held in norm against the kernel run's.  The int8 run's
    KV rows as read back are held against the bf16 rows they were written
    from (``int8_row_err``): every row of the prefill (no prefill reads its
    cache, so both runs write the same k and v), and the first attention
    block's row of the first decode step (no block before it reads a
    cache)."""
    from repro_torch.models import transformer

    B, S = prompt.shape
    max_len = S + steps
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_all(wrappers)
    torch.cuda.synchronize()
    t = time.perf_counter()
    lg, cache = transformer.prefill(params, cfg, prompt, max_len)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t
    prefill_launches = all_launches(wrappers)
    after_prefill, first_step = kv_lines(torch, cfg, cache), None
    logits, tokens, step_ms, step_launches = [lg[:, -1]], [], [], []
    for _ in range(steps):
        nt = lg[:, -1].argmax(-1, keepdim=True)
        tokens.append(nt)
        reset_all(wrappers)
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, cache = transformer.decode_step(params, cfg, nt, cache)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        step_launches.append(all_launches(wrappers))
        logits.append(lg[:, -1])
        if first_step is None:
            first_step = kv_lines(torch, cfg, cache, first_only=True)
    peak_gb = torch.cuda.max_memory_allocated() / 2**30
    del cache
    out = {"B": B, "S": S, "steps": steps, "prefill_s": prefill_s,
           "decode_ms_median": statistics.median(step_ms),
           "decode_ms": step_ms, "peak_mem_gb": peak_gb,
           "prefill_launches": prefill_launches,
           "step_launches": step_launches}
    for label, c, kw in (("plain", cfg, {"use_kernel": False}),
                         ("int8_kv", dataclasses.replace(cfg, kv_quant=True),
                          {})):
        rows, q_prefill, q_step = replay_logits(torch, params, c, prompt,
                                                tokens, max_len, **kw)
        norms = [norm_rel(torch, a, b) for a, b in zip(rows, logits)]
        agree = [float((a.argmax(-1) == b.argmax(-1)).float().mean())
                 for a, b in zip(rows, logits)]
        out[label] = {"norm_rel": norms, "max_norm_rel": max(norms),
                      "greedy_agreement": statistics.mean(agree)}
    # q_*: the int8 run's lines; the decode step wrote position S
    slot = S % first_step[0].shape[1]
    out["int8_kv"]["row_err"] = max(
        int8_row_err(torch, q_prefill, after_prefill),
        int8_row_err(torch, q_step, first_step, slot))
    out["finite"] = bool(all(torch.isfinite(x).all() for x in logits))
    return out


def top2_margin(torch, row) -> float:
    top = torch.topk(row.float(), 2).values
    return float(top[0] - top[1])


def serve_engine(torch, params, cfg, wrappers, gen, lengths=ENGINE_PROMPTS,
                 max_new=ENGINE_MAX_NEW) -> dict:
    """Phases 8b (c) and 8c (b): the continuous-batching engine, fp32
    caches, ragged requests (prompts of ``lengths``, ``max_new`` tokens
    each) through ENGINE_SLOTS slots, each request against its own batch-1
    ``generate``: its logits within SERVE_FP32_TOL of max |logit| up to the
    first token where the two runs part, and its tokens equal wherever the
    sequential run's top-2 margin exceeds twice that limit (past a parting,
    the two runs decode different tokens)."""
    from repro_torch.serving.scheduler import ContinuousBatchingEngine, Request

    max_len = max(lengths) + max(max_new)
    prompts = [torch.randint(0, cfg.vocab_size, (n,), device="cuda",
                             generator=gen) for n in lengths]
    reqs = [Request(rid=i, prompt=p, max_new=k, logits=[])
            for i, (p, k) in enumerate(zip(prompts, max_new))]
    eng = ContinuousBatchingEngine(params, cfg, ENGINE_SLOTS, max_len,
                                   cache_dtype=torch.float32)
    for r in reqs:
        eng.submit(r)
    reset_all(wrappers)
    torch.cuda.synchronize()
    t = time.perf_counter()
    stats = eng.run()
    torch.cuda.synchronize()
    engine_s = time.perf_counter() - t
    launches = all_launches(wrappers)
    per_req = []
    for r, p in zip(reqs, prompts):
        _, rows = greedy_logits(torch, params, cfg, p[None], r.max_new - 1,
                                max_len, cache_dtype=torch.float32)
        want = [int(row[0].argmax()) for row in rows]
        errs, parted, margin_at_parting = [], None, None
        for j, (got_row, want_row) in enumerate(zip(r.logits, rows)):
            errs.append(rel_err(torch, got_row, want_row[0])[1])
            if r.output[j] != want[j]:
                parted = j
                margin_at_parting = top2_margin(torch, want_row[0]) / float(
                    want_row[0].abs().max())
                break
        per_req.append({"rid": r.rid, "prompt": len(p), "max_new": r.max_new,
                        "tokens_equal": r.output == want,
                        "first_parting": parted,
                        "rel_margin_at_parting": margin_at_parting,
                        "max_rel": max(errs)})
    del eng
    return {"requests": len(reqs), "slots": ENGINE_SLOTS,
            "max_len": max_len, "seconds": engine_s,
            "stats": dataclasses.asdict(stats), "launches": launches,
            "per_request": per_req,
            "max_rel": max(q["max_rel"] for q in per_req)}


def check_engine(cfg, wrappers, rec, max_new, label) -> None:
    """A ``serve_engine`` record: every request completed with its tokens,
    the launches a prefill and a step must make, and each request against
    its batch-1 ``generate`` (``serve_engine``'s rule)."""
    st = rec["stats"]
    check(st["completed"] == len(max_new)
          and st["decoded_tokens"] == sum(max_new),
          f"{label}: engine stats {st}")
    want = expected_launches(cfg, wrappers, prefills=st["prefills"],
                             steps=st["steps"])
    check(rec["launches"] == want, f"{label}: the engine launched "
          f"{rec['launches']}, expected {want}")
    for q in rec["per_request"]:
        check(q["max_rel"] <= SERVE_FP32_TOL, f"{label}: request "
              f"{q['rid']}'s logits off its batch-1 generate by "
              f"{q['max_rel']:.3g}, above {SERVE_FP32_TOL}")
        if q["first_parting"] is not None:
            check(q["rel_margin_at_parting"] <= 2 * SERVE_FP32_TOL,
                  f"{label}: request {q['rid']} parted from its batch-1 "
                  f"generate at token {q['first_parting']} with a top-2 "
                  f"margin of {q['rel_margin_at_parting']:.3g} of max "
                  f"|logit|")


def serve_xlstm_states(torch, params, cfg, layers, prompt) -> dict:
    """Phase 8b (d): each mLSTM block's final (C, n, m) in ``prefill``'s
    cache entries ``layers`` against ``mlstm_chunkwise_ref``'s final state
    on the same block inputs (the layers walked again in train mode), in
    fp32."""
    from repro_torch.kernels.mlstm.ref import mlstm_chunkwise_ref
    from repro_torch.models import transformer, xlstm
    from repro_torch.models.layers import rmsnorm

    worst = {"C_rel": 0.0, "n_rel": 0.0, "m_abs": 0.0, "blocks": 0}
    with torch.no_grad():
        x = transformer._embed_tokens(params, cfg, prompt)
        for layer, kind, entry in zip(params["layers"], cfg.layer_kinds(),
                                      layers):
            if kind == "mlstm":
                h = rmsnorm(layer["ln1"], x, cfg.norm_eps)
                q, k, v, log_f, i_gate, _ = xlstm.mlstm_inputs(
                    layer["mlstm"], cfg, h)
                _, (C, n, m) = mlstm_chunkwise_ref(
                    q, k, v, log_f, i_gate, cfg.chunk_size, final_state=True)
                worst["C_rel"] = max(worst["C_rel"],
                                     rel_err(torch, entry.C, C)[1])
                worst["n_rel"] = max(worst["n_rel"],
                                     rel_err(torch, entry.n, n)[1])
                worst["m_abs"] = max(worst["m_abs"],
                                     float((entry.m - m).abs().max()))
                worst["blocks"] += 1
                del q, k, v, C, n
            x, _, _ = transformer.block_apply(layer, cfg, kind, x)
    return worst


def serving_phase(torch, wrappers) -> dict:
    """Phase 8b: the serving path on the card.  (a) recurrentgemma-2b at full
    width and depth, fp32 compute: 2 prompts of 2100 tokens (past the 2048
    window: the rings wrap in prefill), 16 greedy decode steps, each step's
    logits against the forward (SERVE_FP32_TOL); (b) the same model in bf16,
    4 prompts of 2560, 32 steps, the kernels against their plain versions
    and the int8 cache against bf16 in norm; (c) the engine at fp32; (d)
    xlstm-1.3b at full width, 8 layers (7 mLSTM + 1 sLSTM), 2 prompts of
    1000 (ragged last chunk of 256), the final mLSTM states and 8 decode
    steps; (e) ``python -m repro_torch.serve`` as written.  Every part
    checks its kernel launches: each prefill ``swa``, ``rglru`` and
    ``mlstm`` once per block of the kind, each decode step ``rglru`` once
    per RG-LRU block.  Each part's line is printed before its checks."""
    from repro_torch import configs, serve
    from repro_torch.models import transformer

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(24)
    rg = configs.get_config("recurrentgemma-2b")
    rg32 = dataclasses.replace(rg, dtype="float32")
    params = transformer.init_model(
        torch.Generator(device="cuda").manual_seed(0), rg)
    out = {"launches": {}}

    # (a) fp32, decode against the forward
    t = time.perf_counter()
    prompt = torch.randint(0, rg.vocab_size, (2, 2100), device="cuda",
                           generator=gen)
    rec = serve_vs_forward(torch, params, rg32, wrappers, prompt, 16)
    del rec["prefill_layers"]
    rec["seconds"] = time.perf_counter() - t
    emit({"phase": "serving_a_fp32", **{k: v for k, v in rec.items()
                                        if k != "step_launches"},
          "step_launches": rec["step_launches"][0], "tol": SERVE_FP32_TOL})
    check(rec["finite"], "serving (a): non-finite logits")
    check_serve_launches(rg32, wrappers, rec, "serving (a)")
    check(rec["max_rel"] <= SERVE_FP32_TOL, f"serving (a): decode logits off "
          f"the forward by {rec['max_rel']:.3g} of max |logit|, above "
          f"{SERVE_FP32_TOL}")
    out["a_fp32"] = {k: rec[k] for k in ("max_rel", "prefill_s",
                                         "decode_ms_median", "seconds")}
    out["launches"]["a"] = {"prefill": rec["prefill_launches"],
                            "decode_step": rec["step_launches"][0]}

    # (b) bf16: kernels against plain versions, int8 against bf16 caches
    t = time.perf_counter()
    prompt = torch.randint(0, rg.vocab_size, (4, 2560), device="cuda",
                           generator=gen)
    rec = serve_bf16(torch, params, rg, wrappers, prompt, 32)
    rec["seconds"] = time.perf_counter() - t
    emit({"phase": "serving_b_bf16", **{k: v for k, v in rec.items()
                                        if k != "step_launches"},
          "step_launches": rec["step_launches"][0],
          "tol": {"plain_norm": SERVE_BF16_NORM_TOL,
                  "int8_norm": SERVE_INT8_NORM_TOL,
                  "int8_row": INT8_ROW_TOL}})
    check(rec["finite"], "serving (b): non-finite logits")
    check_serve_launches(rg, wrappers, rec, "serving (b)")
    check(rec["plain"]["max_norm_rel"] <= SERVE_BF16_NORM_TOL,
          f"serving (b): bf16 logits off their plain versions by "
          f"{rec['plain']['max_norm_rel']:.3g} in norm, above "
          f"{SERVE_BF16_NORM_TOL}")
    check(rec["int8_kv"]["max_norm_rel"] <= SERVE_INT8_NORM_TOL,
          f"serving (b): int8-cache logits off the bf16 cache's by "
          f"{rec['int8_kv']['max_norm_rel']:.3g} in norm, above "
          f"{SERVE_INT8_NORM_TOL}")
    check(rec["int8_kv"]["row_err"] <= INT8_ROW_TOL,
          f"serving (b): an int8 KV element read back off the bf16 value it "
          f"was written from by {rec['int8_kv']['row_err']:.4g} of its "
          f"bound, above {INT8_ROW_TOL:.4g}")
    out["b_bf16"] = {k: rec[k] for k in ("prefill_s", "decode_ms_median",
                                         "peak_mem_gb", "seconds")}
    out["b_bf16"].update(plain_max_norm_rel=rec["plain"]["max_norm_rel"],
                         int8_max_norm_rel=rec["int8_kv"]["max_norm_rel"],
                         int8_row_err=rec["int8_kv"]["row_err"])
    out["launches"]["b"] = {"prefill": rec["prefill_launches"],
                            "decode_step": rec["step_launches"][0]}
    torch.cuda.empty_cache()

    # (c) the continuous-batching engine, fp32
    t = time.perf_counter()
    rec = serve_engine(torch, params, rg32, wrappers, gen)
    rec["seconds_with_checks"] = time.perf_counter() - t
    emit({"phase": "serving_c_engine", **rec, "tol": SERVE_FP32_TOL})
    check_engine(rg32, wrappers, rec, ENGINE_MAX_NEW, "serving (c)")
    st = rec["stats"]
    out["c_engine"] = {k: rec[k] for k in ("max_rel", "seconds")}
    out["c_engine"]["steps"] = st["steps"]
    out["launches"]["c"] = rec["launches"]
    del params
    torch.cuda.empty_cache()

    # (d) xlstm-1.3b at full width, one cycle of 8 layers, fp32
    t = time.perf_counter()
    xl = dataclasses.replace(configs.get_config("xlstm-1.3b"), n_layers=8,
                             dtype="float32")
    params = transformer.init_model(
        torch.Generator(device="cuda").manual_seed(0), xl)
    prompt = torch.randint(0, xl.vocab_size, (2, 1000), device="cuda",
                           generator=gen)
    rec = serve_vs_forward(torch, params, xl, wrappers, prompt, 8)
    states = serve_xlstm_states(torch, params, xl, rec.pop("prefill_layers"),
                                prompt)
    rec["seconds"] = time.perf_counter() - t
    emit({"phase": "serving_d_xlstm", **{k: v for k, v in rec.items()
                                         if k != "step_launches"},
          "step_launches": rec["step_launches"][0], "final_state": states,
          "tol": {"decode": SERVE_FP32_TOL, "state": SERVE_STATE_TOL}})
    check(rec["finite"], "serving (d): non-finite logits")
    check_serve_launches(xl, wrappers, rec, "serving (d)")
    check(states["blocks"] == xl.layer_kinds().count("mlstm")
          and max(states["C_rel"], states["n_rel"]) <= SERVE_STATE_TOL
          and states["m_abs"] <= SERVE_STATE_TOL,
          f"serving (d): final mLSTM states off mlstm_chunkwise_ref's by "
          f"{states}, above {SERVE_STATE_TOL}")
    check(rec["max_rel"] <= SERVE_FP32_TOL, f"serving (d): decode logits off "
          f"the forward by {rec['max_rel']:.3g}, above {SERVE_FP32_TOL}")
    out["d_xlstm"] = {k: rec[k] for k in ("max_rel", "prefill_s",
                                          "decode_ms_median", "seconds")}
    out["d_xlstm"]["final_state"] = states
    out["launches"]["d"] = {"prefill": rec["prefill_launches"],
                            "decode_step": rec["step_launches"][0]}
    del params
    torch.cuda.empty_cache()

    # (e) the serving example as written
    reset_all(wrappers)
    t = time.perf_counter()
    ex = serve.main(device="cuda")
    example = all_launches(wrappers)
    check(ex["engine"]["completed"] == 8, f"serve example: {ex['engine']}")
    check(all(example[k] > 0 for k in ("swa", "rglru", "mlstm")),
          f"serve example launched {example}")
    out["e_example"] = {"seconds": time.perf_counter() - t, **ex,
                        "launches": example}
    out["seconds"] = time.perf_counter() - t_phase
    return out


# phase 8c: the MoE kind, prefix embeddings and encoder-decoders.  No block
# of these models runs a kernel, so a kernel-against-plain check compares
# identical code (phase (a)'s END_TO_END_TOL entry is 0).  MOE_ORACLE_TOL
# bounds each MoE block's FFN (moe_ffn: scatter, batched expert products,
# gather) against moe_ffn_by_expert (a per-expert loop on the same routing)
# on the same input along the route, as a share of max |by_expert| and in
# norm.  On an H100 the sound bf16 readings are exactly 0 (granite-moe's 32
# blocks, qwen3-moe's 8: cuBLAS sums each product in the same order at
# both shapes) and fp32 reads 1.7e-6 of max, 1.2e-6 in norm; the bf16 norm
# limit allows a product off by about two bf16 ulps (2^-8) in every
# element, and tools/moe_mutant_check.py's two broken copies read 0.81 and
# 0.87 in norm (PERF.md section 6).
MOE_ORACLE_TOL = {"bf16": {"rel": TOL["bf16"], "norm_rel": 1e-2},
                  "fp32": {"rel": TOL["fp32"], "norm_rel": 1e-5}}
# (b): the engine's requests at the published capacity factor
MOE_ENGINE_PROMPTS = (64, 1500, 700, 1200, 128, 1000, 512, 333)
MOE_ENGINE_MAX_NEW = (4, 12, 7, 9, 5, 11, 6, 8)
MOE_LAUNCH_PARTS = ("a", "b", "c", "d", "e")


def drop_free(cfg):
    """``cfg`` at capacity factor 2 E / K: C = int(2 S) slots an expert for
    S tokens, twice what the K S assignments of a row can fill in the
    worst case, with a margin against the int truncation (E itself would
    also be drop-free, but C = S K makes qwen3-moe's fp32 buffers ~20 GB)."""
    return dataclasses.replace(
        cfg, capacity_factor=2 * cfg.n_experts / cfg.n_experts_active)


def moe_block_errors(torch, params, cfg, tokens) -> dict:
    """Every MoE block's FFN against ``moe_ffn_by_expert`` on the same input,
    layer by layer along the main path (no error carries from one layer to
    the next): the largest max-based and norm-relative errors, the share of
    (token, k) assignments dropped at ``cfg.capacity_factor`` in each
    layer, and the blocks' summed aux (forward's aux on these tokens)."""
    from repro_torch.models import moe, transformer

    worst = {"rel": 0.0, "norm_rel": 0.0, "blocks": 0}
    drops, aux = [], 0.0
    with torch.no_grad():
        x = transformer._embed_tokens(params, cfg, tokens)
        for layer, kind in zip(params["layers"], cfg.layer_kinds()):
            if kind != "moe":
                x, _, _ = transformer.block_apply(layer, cfg, kind, x)
                continue
            h = transformer._norm(cfg, layer["ln1"], x)
            x = x + transformer.mixer(layer, cfg, kind, h)[0]
            h = transformer._norm(cfg, layer["ln2"], x)
            out, a = moe.moe_ffn(layer["moe"], cfg, h)
            want = moe.moe_ffn_by_expert(layer["moe"], cfg, h)[0].float()
            worst["rel"] = max(worst["rel"],
                               rel_err(torch, out.float(), want)[1])
            worst["norm_rel"] = max(worst["norm_rel"],
                                    norm_rel(torch, out.float(), want))
            worst["blocks"] += 1
            keep = moe._route(layer["moe"], cfg, h)[2]
            drops.append(1.0 - float(keep.float().mean()))
            aux += float(a)
            x = x + out
            del h, want, keep
    worst["drop_share_max"] = max(drops)
    worst["drop_share_mean"] = statistics.mean(drops)
    worst["drop_share_by_layer"] = drops
    worst["aux"] = aux
    return worst


def check_moe_blocks(rec, dtype, label) -> None:
    limit = MOE_ORACLE_TOL[dtype]
    check(rec["blocks"] > 0 and rec["rel"] <= limit["rel"]
          and rec["norm_rel"] <= limit["norm_rel"],
          f"{label} {dtype}: a MoE block off moe_ffn_by_expert on the same "
          f"input by {rec['rel']:.3g} of max, {rec['norm_rel']:.3g} in norm "
          f"({rec['blocks']} blocks), above {limit}")


def moe_encode_split(torch, params, cfg, tokens) -> dict:
    """One encode of ``tokens`` and the share of it inside ``moe_ffn`` (CUDA
    events around each call, from its first launch to its last)."""
    from repro_torch.models import transformer

    call, events = transformer.moe_ffn, []

    def timed(*args):
        start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = call(*args)
        stop.record()
        events.append((start, stop))
        return out

    transformer.moe_ffn = timed
    try:
        torch.cuda.synchronize()
        t = time.perf_counter()
        transformer.encode(params, cfg, tokens)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t
    finally:
        transformer.moe_ffn = call
    moe_s = sum(a.elapsed_time(b) for a, b in events) / 1e3
    return {"encode_s": encode_s, "moe_ffn_s": moe_s,
            "moe_share": moe_s / encode_s, "moe_calls": len(events)}


def check_decode(rec, label) -> None:
    """A ``serve_vs_forward`` record of a model whose blocks run no kernel:
    finite, no launch in the prefill or a step, decode within
    SERVE_FP32_TOL of the forward."""
    check(rec["finite"], f"{label}: non-finite logits")
    for part, got in (("prefill", rec["prefill_launches"]),
                      *(("decode step", s) for s in rec["step_launches"])):
        check(not any(got.values()), f"{label} {part} launched {got}, "
              f"expected no kernel")
    check(rec["max_rel"] <= SERVE_FP32_TOL, f"{label}: decode logits off the "
          f"forward by {rec['max_rel']:.3g} of max |logit|, above "
          f"{SERVE_FP32_TOL}")


def serve_record(rec) -> dict:
    return {k: rec[k] for k in ("B", "P", "S", "steps", "prefill_s",
                                "decode_ms_median", "logits_vs_forward_rel",
                                "max_rel")}


def moe_encdec_phase(torch, wrappers) -> dict:
    """Phase 8c: (a) granite-moe-3b-a800m at full width and depth through the
    backbone route (``backbone_route``: 2 ``gram_fused`` launches and no
    other), every MoE block against ``moe_ffn_by_expert`` on agent 0's
    first batch (bf16) and one sequence (fp32), one encode's MoE share,
    the drop share at capacity factor 1.25 and the summed aux; (b) granite
    serving in fp32 at full depth: decode against the forward drop-free,
    and the engine at 1.25 against batch-1 ``generate``; (c) qwen3-moe-
    30b-a3b at full width, 8 of 48 layers: a bf16 encode of 8 x 4096 at
    1.25 with its blocks against the oracle, and fp32 decode against the
    forward drop-free; (d) llava-next-34b at full width, 4 of 60 layers:
    2880 prefix embeddings and 64 tokens, fp32 decode against the forward;
    (e) seamless-m4t-large-v2 at full width and depth: the prefilled
    ``ck``/``cv`` against the cross k and v of the encoder memory
    (exact), fp32 decode against the forward, and one
    ``pooled_features(..., enc_embeds=)`` into ``gram_fused``.  Each
    part's launches are read apart: ``gram_fused`` 2 in (a) and 1 in (e),
    nothing else anywhere.  Depth cuts: the card's 80 GB at fp32 weights
    (qwen3-moe 122 GB whole, llava 137 GB)."""
    from repro_torch import backbone, configs
    from repro_torch.configs.llava_next_34b import N_PATCHES
    from repro_torch.core import elm
    from repro_torch.core.heads import pooled_features
    from repro_torch.data import pipeline
    from repro_torch.models import attention, transformer

    t_phase = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(25)
    out = {"launches": {}}

    def seed(n):
        return torch.Generator(device="cuda").manual_seed(n)

    # (a) the granite-moe route at full width and depth
    t = time.perf_counter()
    gm = configs.get_config("granite-moe-3b-a800m")
    route, params = backbone_route(torch, gm, wrappers, n_batches=2)
    tokens = next(backbone.token_batches(seed(1), 1, n=8, seq=4096,
                                         m=4))[0][0]
    split = moe_encode_split(torch, params, gm, tokens)
    check(split["moe_calls"] == gm.n_layers, f"8c (a): one encode called "
          f"moe_ffn {split['moe_calls']} times")
    blocks = {"bf16": moe_block_errors(torch, params, gm, tokens),
              "fp32": moe_block_errors(
                  torch, params, dataclasses.replace(gm, dtype="float32"),
                  tokens[:1])}
    out["launches"]["a"] = all_launches(wrappers)
    rec = {**route, "one_encode": split, "moe_blocks_vs_by_expert": blocks,
           "oracle_tol": MOE_ORACLE_TOL, "seconds": time.perf_counter() - t}
    emit({"phase": "moe_a_granite_route", **rec})
    for dtype, r in blocks.items():
        check_moe_blocks(r, dtype, "8c (a) granite-moe")
    want = dict.fromkeys(out["launches"]["a"], 0)
    want["gram_fused"] = 2
    check(out["launches"]["a"] == want, f"8c (a): launched "
          f"{out['launches']['a']}, expected {want}")
    out["a_route"] = {k: rec[k] for k in ("times_s", "params", "accuracy",
                                          "peak_mem_gb", "seconds")}
    out["a_route"].update(
        encode_s=split["encode_s"], moe_share=split["moe_share"],
        drop_share_max=blocks["bf16"]["drop_share_max"],
        drop_share_mean=blocks["bf16"]["drop_share_mean"],
        aux=blocks["bf16"]["aux"],
        oracle={d: {k: r[k] for k in ("rel", "norm_rel")}
                for d, r in blocks.items()})
    del tokens

    # (b) granite serving, fp32, full depth
    t = time.perf_counter()
    gm32 = dataclasses.replace(gm, dtype="float32")
    prompt = torch.randint(0, gm.vocab_size, (2, 1024), device="cuda",
                           generator=gen)
    dec = serve_vs_forward(torch, params, drop_free(gm32), wrappers, prompt, 8)
    del dec["prefill_layers"]
    eng = serve_engine(torch, params, gm32, wrappers, gen,
                       MOE_ENGINE_PROMPTS, MOE_ENGINE_MAX_NEW)
    out["launches"]["b"] = {k: dec["prefill_launches"][k]
                            + sum(s[k] for s in dec["step_launches"])
                            + eng["launches"][k] for k in eng["launches"]}
    rec = {"decode": serve_record(dec),
           "capacity_factor": drop_free(gm32).capacity_factor,
           "engine": {k: eng[k] for k in ("seconds", "stats", "per_request",
                                          "max_rel")},
           "engine_capacity_factor": gm32.capacity_factor,
           "seconds": time.perf_counter() - t, "tol": SERVE_FP32_TOL}
    emit({"phase": "moe_b_granite_serving", **rec})
    check_decode(dec, "8c (b) granite-moe")
    check_engine(gm32, wrappers, eng, MOE_ENGINE_MAX_NEW, "8c (b) engine")
    out["b_serving"] = {"prefill_s": dec["prefill_s"],
                        "decode_ms_median": dec["decode_ms_median"],
                        "max_rel": dec["max_rel"],
                        "engine_max_rel": eng["max_rel"],
                        "seconds": rec["seconds"]}
    del params
    torch.cuda.empty_cache()

    # (c) qwen3-moe-30b-a3b at full width, 8 of 48 layers
    t = time.perf_counter()
    qm = dataclasses.replace(configs.get_config("qwen3-moe-30b-a3b"),
                             n_layers=8)
    params = transformer.init_model(seed(0), qm)
    tokens = torch.randint(0, qm.vocab_size, (8, 4096), device="cuda",
                           generator=gen)
    torch.cuda.reset_peak_memory_stats()
    split = moe_encode_split(torch, params, qm, tokens)
    peak = torch.cuda.max_memory_allocated() / 2**30
    blocks = moe_block_errors(torch, params, qm, tokens)
    del tokens
    q32 = drop_free(dataclasses.replace(qm, dtype="float32"))
    prompt = torch.randint(0, qm.vocab_size, (2, 512), device="cuda",
                           generator=gen)
    dec = serve_vs_forward(torch, params, q32, wrappers, prompt, 8)
    del dec["prefill_layers"]
    out["launches"]["c"] = {k: dec["prefill_launches"][k]
                            + sum(s[k] for s in dec["step_launches"])
                            for k in dec["prefill_launches"]}
    rec = {"layers": qm.n_layers, "params": transformer.param_count(params),
           "one_encode": split, "peak_mem_gb": peak,
           "moe_blocks_vs_by_expert": blocks, "decode": serve_record(dec),
           "decode_capacity_factor": q32.capacity_factor,
           "seconds": time.perf_counter() - t}
    emit({"phase": "moe_c_qwen3_moe", **rec})
    check_moe_blocks(blocks, "bf16", "8c (c) qwen3-moe")
    check_decode(dec, "8c (c) qwen3-moe")
    out["c_qwen3_moe"] = {"encode_s": split["encode_s"],
                          "moe_share": split["moe_share"],
                          "peak_mem_gb": peak,
                          "drop_share_max": blocks["drop_share_max"],
                          "oracle": {k: blocks[k] for k in ("rel",
                                                            "norm_rel")},
                          "max_rel": dec["max_rel"],
                          "seconds": rec["seconds"]}
    del params
    torch.cuda.empty_cache()

    # (d) llava-next-34b at full width, 4 of 60 layers, 2880 prefix
    # embeddings at the token embeddings' scale
    t = time.perf_counter()
    lv = dataclasses.replace(configs.get_config("llava-next-34b"),
                             n_layers=4, dtype="float32")
    params = transformer.init_model(seed(0), lv)
    prefix = torch.randn(2, N_PATCHES, lv.d_model, device="cuda",
                         generator=gen) * lv.d_model ** -0.5
    prompt = torch.randint(0, lv.vocab_size, (2, 64), device="cuda",
                           generator=gen)
    dec = serve_vs_forward(torch, params, lv, wrappers, prompt, 8,
                           prefix_embeds=prefix)
    out["launches"]["d"] = {k: dec["prefill_launches"][k]
                            + sum(s[k] for s in dec["step_launches"])
                            for k in dec["prefill_launches"]}
    del dec["prefill_layers"]
    rec = {"layers": lv.n_layers, "params": transformer.param_count(params),
           "decode": serve_record(dec), "seconds": time.perf_counter() - t}
    emit({"phase": "moe_d_llava", **rec})
    check_decode(dec, "8c (d) llava")
    out["d_llava"] = {"prefill_s": dec["prefill_s"],
                      "decode_ms_median": dec["decode_ms_median"],
                      "max_rel": dec["max_rel"], "seconds": rec["seconds"]}
    del params, prefix
    torch.cuda.empty_cache()

    # (e) seamless-m4t-large-v2 at full width and depth
    t = time.perf_counter()
    sm = dataclasses.replace(configs.get_config("seamless-m4t-large-v2"),
                             dtype="float32")
    params = transformer.init_model(seed(0), sm)
    enc = torch.randn(2, sm.enc_seq, sm.d_model, device="cuda",
                      generator=gen) * sm.d_model ** -0.5
    prompt = torch.randint(0, sm.vocab_size, (2, 256), device="cuda",
                           generator=gen)
    dec = serve_vs_forward(torch, params, sm, wrappers, prompt, 8,
                           enc_embeds=enc)
    launches = {k: dec["prefill_launches"][k]
                + sum(s[k] for s in dec["step_launches"])
                for k in dec["prefill_launches"]}
    with torch.no_grad():
        memory = transformer.run_encoder(params, sm, enc)
        cross_exact = all(
            torch.equal(entry[c], kv.to(entry[c].dtype))
            for layer, entry in zip(params["layers"], dec["prefill_layers"])
            for c, kv in zip(("ck", "cv"), attention.cross_kv(
                layer["cross"], sm, memory)))
    del dec["prefill_layers"], memory
    # the route's head: pooled features of 4 agents into fused statistics
    reset_all(wrappers)
    fmap = elm.make_feature_map(7, sm.d_model, 2048, dist="normal",
                                device="cuda")
    agent_tokens = torch.randint(0, sm.vocab_size, (4, 2, 256), device="cuda",
                                 generator=gen)
    labels = torch.eye(3, device="cuda")[torch.randint(
        0, 3, (4, 2), device="cuda", generator=gen)]
    feats = pooled_features(params, sm, agent_tokens, enc_embeds=enc)
    stats = pipeline.stream_sufficient_stats(
        [(feats, labels)], producer="fused", feature_map=fmap)
    fused = all_launches(wrappers)
    plain = pipeline.stream_sufficient_stats(
        [(feats, labels)], producer="fused", feature_map=fmap,
        use_kernel=False)
    stats_err = {leaf: rel_err(torch, getattr(stats, leaf),
                               getattr(plain, leaf))[1] for leaf in ("G", "R")}
    out["launches"]["e"] = {k: launches[k] + fused[k] for k in launches}
    rec = {"layers": [sm.n_enc_layers, sm.n_layers],
           "params": transformer.param_count(params),
           "decode": serve_record(dec), "cross_kv_exact": cross_exact,
           "pooled_stats_vs_plain": stats_err,
           "seconds": time.perf_counter() - t}
    emit({"phase": "moe_e_seamless", **rec})
    check_decode(dec, "8c (e) seamless")
    check(cross_exact, "8c (e): a prefilled ck/cv differs from the cross k "
          "and v of the encoder memory")
    check(fused["gram_fused"] == 1 and sum(fused.values()) == 1,
          f"8c (e): the pooled features' statistics launched {fused}")
    check(all(bool(torch.isfinite(x).all()) for x in stats)
          and max(stats_err.values()) <= TOL["fp32"],
          f"8c (e): fused statistics off their plain version by {stats_err}")
    out["e_seamless"] = {"prefill_s": dec["prefill_s"],
                         "decode_ms_median": dec["decode_ms_median"],
                         "max_rel": dec["max_rel"],
                         "seconds": rec["seconds"]}
    del params, enc, feats
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    return out


# phase 8d: the training path.  TRAIN_* is (a)'s run; (b)'s gates run on
# the same seeded weights.  MICROBATCH_TOL bounds the accumulated gradient
# of 2 microbatches against 1 in norm over all leaves (fp32; only the
# order of the sums differs).  The directional derivative: the loss's fp32
# roundoff is taken as FD_LOSS_ULPS ulps of the loss, eps is chosen so
# that eps |g| is FD_STEP_OVER_ROUNDOFF times it, which puts roundoff's
# share of |central difference - |g|| / |g| near 1 / FD_STEP_OVER_ROUNDOFF;
# FD_TOL is ten times that (PERF.md section 6, PR 26, chosen before the
# first card run).
TRAIN_ARCH = "recurrentgemma-2b"
TRAIN_STEPS, TRAIN_BATCH, TRAIN_SEQ = 5, 2, 2048
MICROBATCH_TOL = 1e-5
FD_BATCH, FD_SEQ = 1, 512
FD_LOSS_ULPS = 64
FD_STEP_OVER_ROUNDOFF = 1000.0
FD_TOL = 1e-2
MODEL_AXIS_MESH = (2, 2)
MODEL_AXIS_B, MODEL_AXIS_S = 4, 1024
MODEL_AXIS_TIMEOUT_S = 300.0


def tree_rel_norm(torch, got, want) -> float:
    """|got - want| / |want| in norm over every leaf of two trees."""
    from repro_torch.optim import tree_leaves

    num = den = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want), strict=True):
        num += float(torch.sum((a.double() - b.double()) ** 2))
        den += float(torch.sum(b.double() ** 2))
    return math.sqrt(num / den)


def train_batch(params, cfg, batch: int, seq: int, step: int = 0):
    """The pipeline's batch of ``step`` on the parameters' device."""
    from repro_torch.data import pipeline

    return pipeline.make_batch(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch), step,
        params["embed"]["table"].device)


def kernel_vs_plain_loss(torch, params, cfg, wrappers) -> dict:
    """(b)1: ``loss_fn`` through the kernel forward and through the plain
    forward a training step differentiates, on one batch, no grad; the
    kernels each side launched."""
    from repro_torch.training import steps

    batch = train_batch(params, cfg, TRAIN_BATCH, TRAIN_SEQ)
    out = {}
    with torch.no_grad():
        for name, use_kernel in (("kernel", True), ("plain", False)):
            reset_all(wrappers)
            out[f"{name}_loss"] = float(steps.loss_fn(
                params, cfg, batch, use_kernel=use_kernel)[0])
            out[f"{name}_launches"] = all_launches(wrappers)
    out["rel"] = abs(out["kernel_loss"] - out["plain_loss"]) / abs(
        out["plain_loss"])
    return out


def microbatch_gate(torch, params, cfg) -> dict:
    """(b)2: the loss and accumulated gradient of 2 microbatches against 1
    in ``cfg``'s (fp32) compute, beside the 1-microbatch run repeated."""
    from repro_torch.training import steps

    batch = train_batch(params, cfg, TRAIN_BATCH, FD_SEQ)
    l1, _, g1 = steps.loss_and_grads(params, cfg, batch, 1)
    l1b, _, g1b = steps.loss_and_grads(params, cfg, batch, 1)
    control = tree_rel_norm(torch, g1b, g1)
    del g1b
    l2, _, g2 = steps.loss_and_grads(params, cfg, batch, 2)
    rel = tree_rel_norm(torch, g2, g1)
    return {"grad_rel_norm": rel, "control_grad_rel_norm": control,
            "loss_rel": abs(float(l2) - float(l1)) / abs(float(l1)),
            "control_loss_rel": abs(float(l1b) - float(l1)) / abs(float(l1))}


def directional_gate(torch, params, cfg) -> dict:
    """(b)3: the central difference of the plain fp32 loss along v = g /
    |g| against |g|, eps chosen from the loss's fp32 roundoff."""
    from repro_torch.optim import global_norm, tree_map
    from repro_torch.training import steps

    batch = train_batch(params, cfg, FD_BATCH, FD_SEQ)
    loss, _, grads = steps.loss_and_grads(params, cfg, batch, 1)
    gnorm = float(global_norm(grads))
    ulp = 2.0 ** (math.frexp(abs(float(loss)))[1] - 24)    # fp32's
    eps = FD_STEP_OVER_ROUNDOFF * FD_LOSS_ULPS * ulp / gnorm
    side = {}
    with torch.no_grad():
        for sign in (1, -1):
            shifted = tree_map(lambda p, g: p + (sign * eps / gnorm) * g,
                               params, grads)
            side[sign] = float(steps.loss_fn(shifted, cfg, batch)[0])
            del shifted
    fd = (side[1] - side[-1]) / (2 * eps)
    return {"loss": float(loss), "grad_norm": gnorm, "eps": eps,
            "loss_ulp": ulp, "central_difference": fd,
            "rel": abs(fd - gnorm) / gnorm}


def model_axis_inputs(torch):
    """(c)'s layer, weights and tokens, drawn on the card from one seed (so
    every rank draws the same ones)."""
    from repro_torch import configs
    from repro_torch.models import moe

    cfg = dataclasses.replace(drop_free(configs.get_config(
        "granite-moe-3b-a800m")), dtype="float32", moe_impl="shardmap")
    gen = torch.Generator(device="cuda").manual_seed(26)
    params = moe.moe_init(gen, cfg)
    x = torch.randn((MODEL_AXIS_B, MODEL_AXIS_S, cfg.d_model),
                    generator=gen, device="cuda")
    return cfg, params, x


def model_axis_world(rank: int, t_spawn: float) -> dict:
    """(c)'s rank ``rank`` (module level: a spawned rank imports it):
    ``moe_ffn`` under ``use_mesh`` (the shardmap schedule), a timed call,
    then its gradients of sum(out ** 2) + aux / world, summed over the
    data axis (and the router's over both axes) with ``Mesh.all_reduce``;
    returns its output block, aux, and its F slice of each expert weight's
    gradient (data coordinate 0 only)."""
    import torch

    from repro_torch.core.mesh import make_mesh
    from repro_torch.models import moe
    from repro_torch.models.sharding import use_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(MODEL_AXIS_MESH, ("data", "model"), device="cuda")
    ready_s = time.time() - t_spawn
    cfg, params, x = model_axis_inputs(torch)
    for leaf in params.values():
        leaf["w"].requires_grad_()
    with use_mesh(mesh):
        with torch.no_grad():
            moe.moe_ffn(params, cfg, x)             # warm-up
            torch.cuda.synchronize()
            t = time.perf_counter()
            moe.moe_ffn(params, cfg, x)
            torch.cuda.synchronize()
            call_s = time.perf_counter() - t
        out, aux = moe.moe_ffn(params, cfg, x)
        loss = out.square().sum() + aux / mesh.size
        grads = dict(zip(params, torch.autograd.grad(
            loss, [v["w"] for v in params.values()])))
    i, j = mesh.coords(rank)
    with torch.no_grad():
        grads = {k: mesh.all_reduce(g, "data") for k, g in grads.items()}
        grads["router"] = mesh.all_reduce(grads["router"], "model")
    n, F_ = MODEL_AXIS_MESH[1], cfg.moe_d_ff
    fs = slice(j * (F_ // n), (j + 1) * (F_ // n))
    res = {"coords": (i, j), "ready_s": ready_s, "call_s": call_s,
           "out": out.detach().cpu(), "aux": float(aux.detach())}
    if i == 0:
        res["grads"] = {"w_gate": grads["w_gate"][:, :, fs].cpu(),
                        "w_up": grads["w_up"][:, :, fs].cpu(),
                        "w_down": grads["w_down"][:, fs].cpu()}
        if j == 0:
            res["grads"]["router"] = grads["router"].cpu()
    return res


def model_axis_gate(torch) -> dict:
    """(c): the world against ``moe_ffn_gspmd`` on the whole batch, on the
    card: output, expert and router gradients (max-relative and in norm),
    aux; the world's start-up and a call's seconds."""
    from repro_torch.core.mesh import spawn
    from repro_torch.models import moe

    t0 = time.perf_counter()
    ranks = spawn(model_axis_world, math.prod(MODEL_AXIS_MESH),
                  backend="gloo", device="cuda",
                  timeout_s=MODEL_AXIS_TIMEOUT_S, args=(time.time(),))
    world_s = time.perf_counter() - t0
    cfg, params, x = model_axis_inputs(torch)
    leaves = {k: v["w"].requires_grad_() for k, v in params.items()}
    t = time.perf_counter()
    want, aux = moe.moe_ffn_gspmd(params, cfg, x)
    torch.cuda.synchronize()
    gspmd_s = time.perf_counter() - t
    g_want = dict(zip(leaves, torch.autograd.grad(
        want.square().sum() + aux, list(leaves.values()))))
    want, aux = want.detach(), aux.detach()
    B, S, d = x.shape
    n_data, n_model = MODEL_AXIS_MESH
    bl, dl = B // n_data, d // n_model
    got = torch.full_like(want, float("nan"))
    g_got = {"router": None, "w_gate": [None] * n_model,
             "w_up": [None] * n_model, "w_down": [None] * n_model}
    for r in ranks:
        i, j = r["coords"]
        got[i * bl:(i + 1) * bl, :, j * dl:(j + 1) * dl] = r["out"].cuda()
        for k, g in r.get("grads", {}).items():
            if k == "router":
                g_got[k] = g.cuda()
            else:
                g_got[k][j] = g.cuda()
    g_got = {k: (v if k == "router" else
                 torch.cat(v, dim=1 if k == "w_down" else 2))
             for k, v in g_got.items()}
    rec = {"mesh": MODEL_AXIS_MESH, "B": B, "S": S, "d": d,
           "E": cfg.n_experts, "K": cfg.n_experts_active, "F": cfg.moe_d_ff,
           "capacity_factor": cfg.capacity_factor,
           "out": {"rel": rel_err(torch, got, want)[1],
                   "norm_rel": norm_rel(torch, got, want)},
           "grads": {k: {"rel": rel_err(torch, g_got[k], g_want[k])[1],
                         "norm_rel": norm_rel(torch, g_got[k], g_want[k])}
                     for k in g_want},
           "aux": [r["aux"] for r in ranks], "gspmd_aux": float(aux),
           "world_s": world_s, "ranks_ready_s": max(r["ready_s"]
                                                    for r in ranks),
           "call_s": [r["call_s"] for r in ranks], "gspmd_call_s": gspmd_s,
           "tol": MOE_ORACLE_TOL["fp32"]}
    return rec


def model_axis_failures(rec) -> list:
    """What of (c)'s record breaks ``MOE_ORACLE_TOL`` fp32 or the aux."""
    limit = MOE_ORACLE_TOL["fp32"]
    bad = [f"8d (c): moe_ffn_shardmap {part} off moe_ffn_gspmd by "
           f"{r['rel']:.3g} of max, {r['norm_rel']:.3g} in norm, above "
           f"{limit}"
           for part, r in [("output", rec["out"])] + [
               (f"grad {k}", v) for k, v in rec["grads"].items()]
           if not (r["rel"] <= limit["rel"]
                   and r["norm_rel"] <= limit["norm_rel"])]
    if not all(a == rec["gspmd_aux"] for a in rec["aux"]):
        bad.append(f"8d (c): the world's aux {rec['aux']} is not the "
                   f"unsharded {rec['gspmd_aux']}")
    return bad


def check_model_axis(rec) -> None:
    bad = model_axis_failures(rec)
    check(not bad, "; ".join(bad))


def training_phase(torch, wrappers) -> dict:
    """Phase 8d (module docstring): (a) the training run through the entry
    point, (b) the three gates on the same seeded weights, (c) the model
    axis."""
    from repro_torch import analysis, configs
    from repro_torch.launch import shapes, train
    from repro_torch.models import transformer

    t_phase = time.perf_counter()
    out = {}
    # (a) launch.train.main at full width and depth
    reset_all(wrappers)
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    log = train.main(["--arch", TRAIN_ARCH, "--steps", str(TRAIN_STEPS),
                      "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                      "--device", "cuda"])
    torch.cuda.synchronize()
    launches = all_launches(wrappers)
    cfg = shapes.variant_for_shape(configs.get_config(TRAIN_ARCH),
                                   shapes.SHAPES["train_4k"])
    flops = analysis.analytic_cost(cfg, shapes.InputShape(
        "step", "train", TRAIN_SEQ, TRAIN_BATCH))["flops"]
    step_s = [row["step_seconds"] for row in log]
    steady = statistics.median(step_s[1:])
    out["a_run"] = {
        "arch": TRAIN_ARCH, "layers": cfg.n_layers, "remat": cfg.remat,
        "batch": TRAIN_BATCH, "seq": TRAIN_SEQ, "steps": TRAIN_STEPS,
        "log": [{k: row[k] for k in ("step", "loss", "ce", "grad_norm",
                                     "lr", "step_seconds")} for row in log],
        "seconds": time.perf_counter() - t,
        "step_s_median_after_first": steady,
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "analytic_flops": flops, "achieved_tflops": flops / steady / 1e12,
        "card": nvidia_smi(), "launches": launches,
        "last_loss_below_first": log[-1]["loss"] < log[0]["loss"]}
    emit({"phase": "training_a_run", **out["a_run"]})
    check(all(math.isfinite(row["loss"]) and math.isfinite(row["grad_norm"])
              for row in log), f"8d (a): non-finite loss or grad_norm {log}")
    check(not any(launches.values()), f"8d (a): the training steps launched "
          f"{launches}, expected no kernel")
    torch.cuda.empty_cache()

    # (b) the gates on the same seeded weights
    t = time.perf_counter()
    params = transformer.init_model(0, cfg, device="cuda")
    kp = kernel_vs_plain_loss(torch, params, cfg, wrappers)
    emit({"phase": "training_b1_kernel_vs_plain", **kp,
          "tol": TOL["bf16"]})
    want = dict.fromkeys(kp["kernel_launches"], 0)
    kinds = cfg.layer_kinds()
    want.update(swa=kinds.count("swa"), rglru=kinds.count("rglru"))
    check(kp["kernel_launches"] == want, f"8d (b)1: the kernel forward "
          f"launched {kp['kernel_launches']}, expected {want}")
    check(not any(kp["plain_launches"].values()), f"8d (b)1: the plain "
          f"forward launched {kp['plain_launches']}")
    check(kp["rel"] <= TOL["bf16"], f"8d (b)1: the kernel forward's loss "
          f"{kp['kernel_loss']} off the plain forward's {kp['plain_loss']} "
          f"by {kp['rel']:.3g} of |loss|, above {TOL['bf16']}")
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    mb = microbatch_gate(torch, params, cfg32)
    emit({"phase": "training_b2_microbatches", **mb, "tol": MICROBATCH_TOL})
    check(mb["grad_rel_norm"] <= MICROBATCH_TOL
          and mb["loss_rel"] <= MICROBATCH_TOL,
          f"8d (b)2: 2 microbatches off 1 by {mb['grad_rel_norm']:.3g} in "
          f"norm (loss {mb['loss_rel']:.3g}), above {MICROBATCH_TOL}")
    torch.cuda.empty_cache()
    fd = directional_gate(torch, params, cfg32)
    emit({"phase": "training_b3_directional", **fd, "tol": FD_TOL})
    check(fd["rel"] <= FD_TOL, f"8d (b)3: the central difference "
          f"{fd['central_difference']:.6g} off |g| {fd['grad_norm']:.6g} by "
          f"{fd['rel']:.3g}, above {FD_TOL}")
    out["b_gates"] = {"kernel_vs_plain": kp, "microbatches": mb,
                      "directional": fd, "seconds": time.perf_counter() - t}
    del params
    torch.cuda.empty_cache()

    # (c) the model axis
    t = time.perf_counter()
    rec = model_axis_gate(torch)
    rec["seconds"] = time.perf_counter() - t
    emit({"phase": "training_c_model_axis", **rec})
    check_model_axis(rec)
    out["c_model_axis"] = rec
    out["launches"] = {"training": launches,
                       "kernel_vs_plain": kp["kernel_launches"]}
    out["seconds"] = time.perf_counter() - t_phase
    return out


# phase 8e: the pod tooling.  (a) the dry run (``python -m
# repro_torch.launch.dryrun``, no card: a fake world of 256 ranks, meta
# tensors) of POD_DRYRUN_COMBOS, each in a process of its own, started
# with the script and read after (b) and (c): recurrentgemma-2b's train_4k
# pass alone takes 80 s of the host (its plain RG-LRU loop, one Python
# meta op at a time; PERF.md section 6).  (b) the plan of
# recurrentgemma-2b's parameters and AdamW moments made real: each of the
# POD_PLAN_MESH ranks allocates its shards on the card, and the growth of
# ``memory_allocated`` is held against the plan's bytes, each tensor
# rounded up to the allocator's 512-byte block (the ranks run with
# expandable segments, under which the allocator splits every block down to
# that rounding; requested bytes are printed beside it).  Beside them each
# rank places POD_DROP_ARCH's POD_DROP_LEAF, whose first dimension (the
# vocabulary, 49155) is odd: ``_filter`` must drop ``model`` from it, as no
# leaf of recurrentgemma-2b asks at (data 2, model 2).  (c) the
# data-parallel step on POD_DP_WORLD ranks, recurrentgemma-2b at full width
# cut to POD_DP_LAYERS layers, fp32, POD_DP_B x POD_DP_S a rank, labels
# padded with -1 over POD_DP_PAD[rank] positions, against one process on
# the concatenated batch within MICROBATCH_TOL (the same reassociation of
# fp32 sums as (b)2 of phase 8d).
POD_DRYRUN_COMBOS = (("recurrentgemma-2b", "train_4k"),
                     ("recurrentgemma-2b", "decode_32k"),
                     ("granite-moe-3b-a800m", "train_4k"))
POD_DRYRUN_KEYS = {
    "": ("arch", "shape", "mesh", "chips", "params", "params_active",
         "memory", "collectives", "roofline", "cost_source", "pass_seconds"),
    "memory": ("argument_bytes_per_device", "output_bytes_per_device",
               "temp_bytes_per_device", "peak_estimate_bytes",
               "peak_ok_80gb"),
    "collectives": ("all-reduce", "all-gather", "collective-permute",
                    "total", "counts"),
    "roofline": ("compute_s", "compute_s_analytic", "memory_s",
                 "collective_s", "model_flops_total", "analytic_flops_total",
                 "useful_flops_ratio", "dominant")}
POD_PLAN_MESH = (2, 2)
POD_SEED = 27
POD_ALLOC_BLOCK = 512
POD_UNSHARD_LEAVES = (("embed", "table"),
                      ("layers", 2, "attn", "wq", "w"),
                      ("layers", 2, "attn", "wo", "w"),
                      ("layers", 0, "rglru", "w_rnn", "w"),
                      ("layers", 0, "rglru", "conv", "w"),
                      ("layers", 0, "rglru", "lam", "lam"),
                      ("layers", 0, "mlp", "w_gate", "w"),
                      ("layers", 0, "mlp", "w_down", "w"))
POD_DROP_ARCH, POD_DROP_LEAF = "granite-moe-3b-a800m", ("embed", "table")
POD_DP_WORLD, POD_DP_LAYERS, POD_DP_B, POD_DP_S = 2, 2, 2, 512
POD_DP_PAD = (37, 300)
POD_TIMEOUT_S = 300.0


def kernel_launches() -> dict:
    """Every kernel's launch count in this process."""
    from repro_torch.kernels.gram import kernel
    from repro_torch.kernels.mlstm import kernel as mlstm_kernel
    from repro_torch.kernels.rglru import kernel as rglru_kernel
    from repro_torch.kernels.swa import kernel as swa_kernel

    return all_launches({"gram": kernel, "swa": swa_kernel,
                         "rglru": rglru_kernel, "mlstm": mlstm_kernel})


def start_dryruns() -> dict:
    """(a): one ``launch.dryrun`` process a combo, all started at once, on
    the ``repro_torch`` this process imported (so a copy under test runs
    its own), writing into a temporary directory; ``stop_dryruns`` ends
    them and removes it."""
    import repro_torch

    env = dict(os.environ,
               PYTHONPATH=str(Path(repro_torch.__file__).parents[1]))
    out_dir = tempfile.mkdtemp(prefix="pod_dryrun_")
    procs = {}
    for arch, shape in POD_DRYRUN_COMBOS:
        procs[arch, shape] = (time.time(), subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--mesh", "single", "--out", out_dir],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    return {"out_dir": out_dir, "procs": procs}


def stop_dryruns(dryruns: dict) -> None:
    for _, proc in dryruns["procs"].values():
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    shutil.rmtree(dryruns["out_dir"], ignore_errors=True)


def finish_dryruns(dryruns: dict) -> list:
    """(a)'s records, each process waited for; its JSON's keys, params
    against the meta tree's size, and granite's expert leaves on the
    expert-FF fallback at model 16 (its 40 experts do not divide 16).  A
    process's seconds run from its start to its JSON's writing."""
    from repro_torch import configs
    from repro_torch.launch import dryrun, shapes
    from repro_torch.launch import shardings as sh
    from repro_torch.models.transformer import param_count

    recs = []
    out_dir = Path(dryruns["out_dir"])
    for (arch, shape), (t0, proc) in dryruns["procs"].items():
        log, _ = proc.communicate(timeout=POD_TIMEOUT_S)
        check(proc.returncode == 0, f"8e (a): the dry run of {arch} {shape} "
              f"exited {proc.returncode}:\n{log[-3000:]}")
        path = out_dir / f"{arch}__{shape}__single.json"
        wall = path.stat().st_mtime - t0
        d = json.loads(path.read_text())
        missing = [f"{part}.{k}" if part else k
                   for part, keys in POD_DRYRUN_KEYS.items()
                   for k in keys if k not in (d[part] if part else d)]
        check(not missing, f"8e (a): {arch} {shape}'s JSON lacks {missing}")
        cfg = shapes.variant_for_shape(configs.get_config(arch),
                                       shapes.SHAPES[shape])
        params = dryrun.meta_model(cfg)
        n = param_count(params)
        check(d["params"] == n, f"8e (a): {arch} params {d['params']}, the "
              f"meta tree holds {n}")
        rec = {"arch": arch, "shape": shape, "mesh": d["mesh"],
               "params": d["params"], "params_active": d["params_active"],
               "memory": d["memory"], "roofline": d["roofline"],
               "collective_counts": d["collectives"]["counts"],
               "collective_bytes": d["collectives"]["total"],
               "pass_s": d["pass_seconds"], "process_s": wall}
        if cfg.n_experts:
            mesh = sh.MeshShape(("data", "model"), (16, 16))
            specs = sh.filter_specs(sh.param_specs(params, "data", mesh),
                                    mesh, params)
            moe = [layer["moe"] for layer in specs["layers"]
                   if "moe" in layer]
            rec["expert_specs"] = {k: list(moe[0][k]["w"])
                                   for k in ("w_gate", "w_up", "w_down")}
            want = {"w_gate": [None, "data", "model"],
                    "w_up": [None, "data", "model"],
                    "w_down": [None, "model", "data"]}
            bad = [m for m in moe
                   if {k: list(m[k]["w"]) for k in want} != want]
            check(not bad, f"8e (a): {arch}'s expert leaves at model 16 are "
                  f"{rec['expert_specs']}, not the expert-FF fallback {want}")
        emit({"phase": "pod_a_dryrun", **rec})
        recs.append(rec)
    return recs


def pod_plan_world(rank: int, t_spawn: float) -> dict:
    """(b)'s rank ``rank`` (module level: a spawned rank imports it): the
    whole recurrentgemma-2b parameters drawn from POD_SEED on the card, one
    rank at a time (peak memory), its shards of them and of the AdamW
    moments allocated, and its shard of POD_DROP_ARCH's POD_DROP_LEAF
    (drawn from POD_SEED); returns the allocator's growth, the plan's
    bytes, and whether ``unshard`` of every rank's parts of
    POD_UNSHARD_LEAVES and of POD_DROP_LEAF is the whole leaf, bit for
    bit."""
    import torch

    from repro_torch import configs
    from repro_torch.core.mesh import make_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch import shardings as sh
    from repro_torch.models import transformer
    from repro_torch.optim.adamw import adamw_init

    mesh = make_mesh(POD_PLAN_MESH, ("data", "model"), device="cuda")
    ready_s = time.time() - t_spawn
    t = time.perf_counter()
    cfg = configs.get_config(TRAIN_ARCH)
    meta = dryrun.meta_model(cfg)
    raw = sh.param_specs(meta, "data", mesh)
    pspecs = sh.filter_specs(raw, mesh, meta)
    opt_meta = adamw_init(meta)
    ospecs = sh.filter_specs(sh.opt_specs(opt_meta, raw), mesh, opt_meta)
    g_meta = dryrun.meta_model(configs.get_config(POD_DROP_ARCH))
    g_spec = sh.filter_specs(sh.param_specs(g_meta, "data", mesh), mesh,
                             g_meta)
    for k in POD_DROP_LEAF:
        g_meta, g_spec = g_meta[k], g_spec[k]
    # a one-leaf tree of its own, keyed by the leaf's name
    drop_key = "/".join((POD_DROP_ARCH,) + POD_DROP_LEAF)
    drop_meta, drop_specs = {drop_key: g_meta}, {drop_key: g_spec}

    def stats():
        torch.cuda.synchronize()
        s = torch.cuda.memory_stats()
        return s["allocated_bytes.all.current"], s["requested_bytes.all.current"]

    kept = {}
    for turn in range(mesh.size):
        if turn == rank:
            whole = transformer.init_model(POD_SEED, cfg, device="cuda")
            gen = torch.Generator(device="cuda").manual_seed(POD_SEED)
            drop_whole = sh.map_specs(
                lambda s, x: torch.randn(x.shape, generator=gen,
                                         dtype=x.dtype, device="cuda"),
                drop_specs, drop_meta)
            a0, r0 = stats()

            def placed(specs, tree):
                return sh.map_specs(lambda s, x: sh.shard(x, s, mesh).clone(
                    memory_format=torch.contiguous_format), specs, tree)
            shards = placed(pspecs, whole)
            drop_shards = placed(drop_specs, drop_whole)
            a1, r1 = stats()
            for path in POD_UNSHARD_LEAVES:
                leaf, spec, part = whole, pspecs, shards
                for k in path:
                    leaf, spec, part = leaf[k], spec[k], part[k]
                kept["/".join(map(str, path))] = (leaf, spec, part)
            kept[drop_key] = (drop_whole[drop_key], g_spec,
                              drop_shards[drop_key])
            del whole, drop_whole
            torch.cuda.empty_cache()
        mesh.barrier()
    a2, r2 = stats()
    moments = sh.map_specs(
        lambda s, x: torch.zeros(sh.local_shape(x.shape, s, mesh),
                                 dtype=x.dtype, device="cuda"),
        ospecs, opt_meta)
    a3, r3 = stats()
    unshard_equal = {}
    for key, (leaf, spec, part) in kept.items():
        parts = list(mesh.all_gather(part).unbind(0))
        unshard_equal[key] = bool(torch.equal(sh.unshard(parts, spec, mesh),
                                              leaf))
    plans = ((pspecs, meta), (ospecs, opt_meta), (drop_specs, drop_meta))
    out = {"coords": mesh.coords(rank), "ready_s": ready_s,
           "allocated_growth": (a1 - a0) + (a3 - a2),
           "requested_growth": (r1 - r0) + (r3 - r2),
           "plan_bytes_rounded": sum(
               sh.plan_bytes(s, x, mesh, POD_ALLOC_BLOCK) for s, x in plans),
           "plan_bytes": sum(sh.plan_bytes(s, x, mesh) for s, x in plans),
           "tensors": sum(len(sh.spec_leaves(s, x)) for s, x in plans),
           "drop_spec": str(g_spec),
           "unshard_equal": unshard_equal,
           "launches": kernel_launches(),
           "seconds": time.perf_counter() - t}
    del shards, drop_shards, moments, kept
    return out


def pod_dp_batch(torch, cfg):
    """(c)'s whole batch (POD_DP_WORLD x POD_DP_B rows of POD_DP_S), the
    pipeline's step 0, rank t's rows' labels padded with -1 over their last
    POD_DP_PAD[t] positions."""
    from repro_torch.data import pipeline

    batch = pipeline.make_batch(pipeline.DataConfig(
        vocab_size=cfg.vocab_size, seq_len=POD_DP_S,
        global_batch=POD_DP_WORLD * POD_DP_B), 0, "cuda")
    labels = batch["labels"].clone()
    for t, pad in enumerate(POD_DP_PAD):
        labels[t * POD_DP_B:(t + 1) * POD_DP_B, POD_DP_S - pad:] = -1
    return {**batch, "labels": labels}


def pod_dp_config():
    from repro_torch import configs
    from repro_torch.launch import shapes

    cfg = shapes.variant_for_shape(configs.get_config(TRAIN_ARCH),
                                   shapes.SHAPES["train_4k"])
    return dataclasses.replace(cfg, n_layers=POD_DP_LAYERS, dtype="float32")


def pod_dp_world(rank: int, t_spawn: float) -> dict:
    """(c)'s rank ``rank``: its rows through ``loss_and_grads`` under
    ``use_mesh`` and the AdamW update (``train_step``'s two halves, the
    gradients kept); rank 0 then runs one process's step on the whole batch
    from the same weights and returns the gaps, in norm."""
    import torch

    from repro_torch.core.mesh import make_mesh
    from repro_torch.models import transformer
    from repro_torch.models.sharding import use_mesh
    from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
    from repro_torch.training import steps

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh((POD_DP_WORLD,), ("data",), device="cuda")
    ready_s = time.time() - t_spawn
    cfg = pod_dp_config()
    whole = pod_dp_batch(torch, cfg)
    mine = {k: v[rank * POD_DP_B:(rank + 1) * POD_DP_B]
            for k, v in whole.items()}
    params = transformer.init_model(POD_SEED, cfg, device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter()
    with use_mesh(mesh):
        loss, metrics, grads = steps.loss_and_grads(params, cfg, mine)
    params, _, om = adamw_update(grads, adamw_init(params), params,
                                 AdamWConfig())
    torch.cuda.synchronize()
    out = {"coords": mesh.coords(rank), "ready_s": ready_s,
           "step_s": time.perf_counter() - t, "loss": float(loss),
           "ce": float(metrics["ce"]), "tokens": int(metrics["tokens"]),
           "grad_norm": float(om["grad_norm"]),
           "labels": int((mine["labels"] >= 0).sum()),
           "launches": kernel_launches()}
    if rank == 0:
        ref = transformer.init_model(POD_SEED, cfg, device="cuda")
        l1, m1, g1 = steps.loss_and_grads(ref, cfg, whole)
        out["grad_rel_norm"] = tree_rel_norm(torch, grads, g1)
        del grads
        ref, _, om1 = adamw_update(g1, adamw_init(ref), ref, AdamWConfig())
        out["param_rel_norm"] = tree_rel_norm(torch, params, ref)
        out["one_process"] = {"loss": float(l1), "ce": float(m1["ce"]),
                              "tokens": int(m1["tokens"]),
                              "grad_norm": float(om1["grad_norm"])}
        out["loss_rel"] = abs(float(loss) - float(l1)) / abs(float(l1))
        out["launches_after_reference"] = kernel_launches()
    return out


def pod_plan_part(torch) -> dict:
    """(b): the world's records and its gates."""
    from repro_torch.core.mesh import spawn

    t0 = time.perf_counter()
    conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = spawn(pod_plan_world, math.prod(POD_PLAN_MESH),
                      backend="gloo", device="cuda",
                      timeout_s=POD_TIMEOUT_S, args=(time.time(),))
    finally:
        if conf is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = conf
    rec = {"arch": TRAIN_ARCH, "mesh": POD_PLAN_MESH, "fsdp": "data",
           "ranks": [{k: r[k] for k in ("coords", "allocated_growth",
                                        "requested_growth",
                                        "plan_bytes_rounded", "plan_bytes",
                                        "tensors", "drop_spec", "seconds")}
                     for r in ranks],
           "unshard_equal": [r["unshard_equal"] for r in ranks],
           "ranks_ready_s": max(r["ready_s"] for r in ranks),
           "launches": [r["launches"] for r in ranks],
           "card": nvidia_smi(), "world_s": time.perf_counter() - t0}
    emit({"phase": "pod_b_plan", **rec})
    for r in ranks:
        check(r["allocated_growth"] == r["plan_bytes_rounded"],
              f"8e (b): rank {r['coords']} allocated {r['allocated_growth']} "
              f"bytes for its shards, the plan holds "
              f"{r['plan_bytes_rounded']} (each tensor to "
              f"{POD_ALLOC_BLOCK} bytes)")
        check(all(r["unshard_equal"].values()), f"8e (b): rank "
              f"{r['coords']}: unshard of the parts is not the whole leaf "
              f"{r['unshard_equal']}")
        check(not any(r["launches"].values()), f"8e (b): rank "
              f"{r['coords']} launched {r['launches']}")
    return rec


def pod_dp_part(torch) -> dict:
    """(c): the world's records and its gates."""
    from repro_torch.core.mesh import spawn

    t0 = time.perf_counter()
    ranks = spawn(pod_dp_world, POD_DP_WORLD, backend="gloo", device="cuda",
                  timeout_s=POD_TIMEOUT_S, args=(time.time(),))
    r0 = ranks[0]
    rec = {"arch": TRAIN_ARCH, "layers": POD_DP_LAYERS, "world": POD_DP_WORLD,
           "batch_per_rank": POD_DP_B, "seq": POD_DP_S, "pad": POD_DP_PAD,
           "labels_per_rank": [r["labels"] for r in ranks],
           "loss": [r["loss"] for r in ranks],
           "grad_norm": [r["grad_norm"] for r in ranks],
           "tokens": [r["tokens"] for r in ranks],
           "one_process": r0["one_process"],
           "grad_rel_norm": r0["grad_rel_norm"],
           "param_rel_norm": r0["param_rel_norm"],
           "loss_rel": r0["loss_rel"], "tol": MICROBATCH_TOL,
           "step_s": [r["step_s"] for r in ranks],
           "ranks_ready_s": max(r["ready_s"] for r in ranks),
           "launches": [r["launches"] for r in ranks]
           + [r0["launches_after_reference"]],
           "world_s": time.perf_counter() - t0}
    emit({"phase": "pod_c_data_parallel", **rec})
    check(max(rec["grad_rel_norm"], rec["param_rel_norm"],
              rec["loss_rel"]) <= MICROBATCH_TOL,
          f"8e (c): the data-parallel step off one process's by "
          f"{rec['grad_rel_norm']:.3g} (gradients), "
          f"{rec['param_rel_norm']:.3g} (parameters), {rec['loss_rel']:.3g} "
          f"(loss) in norm, above {MICROBATCH_TOL}")
    check(len(set(rec["grad_norm"])) == 1 and len(set(rec["loss"])) == 1,
          f"8e (c): the ranks' reduced loss {rec['loss']} or gradient norm "
          f"{rec['grad_norm']} differ")
    check(not any(v for r in rec["launches"] for v in r.values()),
          f"8e (c): the ranks launched {rec['launches']}")
    return rec


def pod_phase(torch, wrappers, dryruns=None) -> dict:
    """Phase 8e (module docstring and the comment above): (b) and (c) on
    the card, then (a)'s processes read (``dryruns``, started with the
    script: they need neither the card nor a build; started here when
    None)."""
    t_phase = time.perf_counter()
    reset_all(wrappers)
    own = dryruns is None
    if own:
        dryruns = start_dryruns()
    try:
        plan = pod_plan_part(torch)
        dp = pod_dp_part(torch)
        dry = finish_dryruns(dryruns)
    finally:
        if own:
            stop_dryruns(dryruns)
    launches = all_launches(wrappers)
    check(not any(launches.values()), f"8e: launched {launches}")
    return {"a_dryrun": dry, "b_plan": plan, "c_data_parallel": dp,
            "launches": launches, "seconds": time.perf_counter() - t_phase}

def main() -> int:
    t_start = time.perf_counter()
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
    # 8e (a)'s dry runs need neither the card nor a build: they start now,
    # on the host's other cores, and phase 8e reads them
    pod_dryruns = start_dryruns()
    atexit.register(stop_dryruns, pod_dryruns)

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
    # widths at S = 8192, a ragged case and phase 8b's prefill (a); rglru:
    # phase 6's call, ragged, and phase 8b's decode step (S = 1, h0 != 0)
    cases["swa"] = [
        swa_case(torch, swa_kernel, swa_ref, shape, precision, gen, label)
        for label, shape, precision in (
            ("main_path", (8, 10, 1, 4096, 256, 2048), "bf16"),
            ("recurrentgemma_s8192", (1, 10, 1, 8192, 256, 2048), "fp32"),
            ("recurrentgemma_s8192", (1, 10, 1, 8192, 256, 2048), "bf16"),
            ("h2o_danube_s8192", (1, 32, 8, 8192, 120, 4096), "bf16"),
            ("ragged", (2, 4, 2, 1000, 64, 100), "fp32"),
            ("ragged", (2, 4, 2, 1000, 64, 100), "bf16"),
            ("serving_prefill", (2, 10, 1, 2100, 256, 2048), "fp32"),
            ("serving_prefill", (2, 10, 1, 2100, 256, 2048), "bf16"))]
    cases["rglru"] = [
        rglru_case(torch, rglru_kernel, rglru_scan_ref, (8, 4096, 2560), gen,
                   "main_path", h0_zero=True),
        rglru_case(torch, rglru_kernel, rglru_scan_ref, (3, 1000, 300), gen,
                   "ragged", h0_zero=False),
        rglru_case(torch, rglru_kernel, rglru_scan_ref, (4, 1, 2560), gen,
                   "serving_decode", h0_zero=False)]
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

    # 5c. the event-tape async executor -----------------------------------------
    emit({"phase": "async", **async_phase(torch, kernel)})
    torch.cuda.empty_cache()

    # 5d. the sharded executors, one agent per rank -----------------------------
    emit({"phase": "sharded", **sharded_phase(torch, kernel)})
    torch.cuda.empty_cache()

    # 6. the backbone route at full recurrentgemma-2b width -------------------
    route6, params = backbone_route(
        torch, configs.get_config("recurrentgemma-2b"), wrappers, n_batches=2)
    emit({"phase": "backbone_route", **route6})
    del params
    torch.cuda.empty_cache()

    # 7. the backbone example as written ----------------------------------------
    reset_all(wrappers)
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

    # 8b. the serving path ----------------------------------------------------
    serving = serving_phase(torch, wrappers)
    emit({"phase": "serving", **serving})
    torch.cuda.empty_cache()

    # 8c. the MoE kind, prefix embeddings and encoder-decoders ----------------
    moe_encdec = moe_encdec_phase(torch, wrappers)
    emit({"phase": "moe_encdec", **moe_encdec})
    torch.cuda.empty_cache()

    # 8d. the training path -----------------------------------------------------
    training = training_phase(torch, wrappers)
    emit({"phase": "training", "seconds": training["seconds"],
          "a_run": training["a_run"], "b_gates": training["b_gates"],
          "c_model_axis": {k: v for k, v in training["c_model_axis"].items()
                           if k != "tol"}})
    torch.cuda.empty_cache()

    # 8e. the pod tooling -------------------------------------------------------
    pod = pod_phase(torch, wrappers, pod_dryruns)
    emit({"phase": "pod", "seconds": pod["seconds"],
          "a_pass_s": [r["pass_s"] for r in pod["a_dryrun"]],
          "a_process_s": [r["process_s"] for r in pod["a_dryrun"]],
          "b_world_s": pod["b_plan"]["world_s"],
          "c_world_s": pod["c_data_parallel"]["world_s"]})
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
    # the serving path's launches of each kernel, by part of phase 8b
    serving_launches = {
        name: {part: ({k: v[name] for k, v in rec.items()} if "prefill" in rec
                      else rec[name])
               for part, rec in serving["launches"].items()}
        for name in ("swa", "rglru", "mlstm")}
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
            **({"serving_launches": serving_launches[name]}
               if name in serving_launches else {}),
            "moe_encdec_launches": {part: moe_encdec["launches"][part][name]
                                    for part in MOE_LAUNCH_PARTS},
            "training_launches": training["launches"]["training"][name],
            "training_kernel_vs_plain_launches":
                training["launches"]["kernel_vs_plain"][name],
            "pod_launches": pod["launches"][name],
            "cases": cs,
        })
    emit({"phase": "total", "seconds": time.perf_counter() - t_start})
    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
