#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root:  python3 chip_smoke.py

Phases (any failure raises and the script exits non-zero):
  1. environment: the card, torch/CUDA versions, TF32 switched off;
  2. build: nvcc compiles the Gram kernels from ``src/repro_torch``;
  3. kernels: each CUDA kernel against its plain PyTorch version at the
     main path's shape, the full backbone shape (m=8, N=8192, L=2048, D=8,
     d_in=256) and a ragged shape (m=3, N=1000, L=300, D=3, d_in=70), in
     fp32 and bf16; G must be exactly symmetric; times of the kernel, the
     plain version and one library call;
  4. main path at full width: 8 agents, 8192 samples of 256 features each,
     an L=2048 hidden layer; the fused stats stream (``gram_fused``), the
     materialized stream (``gram_tri``), DMTL-ELM by consensus ADMM on a
     ring, FO-DMTL-ELM, MTL-ELM, and the same DMTL fit from the kernels'
     plain versions; every kernel of the path must have launched;
  5. the quickstart's small default mode on the card.

The last three lines of standard output are the ``{"kernels": ...}`` JSON
line, the card's name and power limit from nvidia-smi, and
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32": 67e12, "bf16": 989e12}
TOL = {"fp32": 1e-4, "bf16": 3e-2}
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


def rel_err(torch, got, want) -> tuple[float, float]:
    diff = float((got - want).abs().max())
    return diff, diff / max(float(want.abs().max()), 1e-30)


def gram_cost(kind, m, N, L, D, d_in, precision):
    """(bytes, bound ms, bound_by, recomputed hidden-layer flops): every
    input read once, every output written once; the useful flops of the
    lower triangle of G plus R (plus the hidden layer once, fused)."""
    h_bytes = 2 if precision == "bf16" else 4
    out_bytes = 4 * m * L * (L + D)
    gram_ops = m * N * L * (L + 1) + 2 * m * N * L * D
    if kind == "gram_tri":
        nbytes = h_bytes * m * N * (L + D) + out_bytes
        op_ms = gram_ops / PEAK_OPS_PER_S[precision] * 1e3
        recompute = 0
    else:
        nbytes = (4 * (m * N * d_in + d_in * L + L) + h_bytes * m * N * D
                  + out_bytes)
        hidden_ops = 2 * m * N * d_in * L
        op_ms = (hidden_ops / PEAK_OPS_PER_S["fp32"]
                 + gram_ops / PEAK_OPS_PER_S[precision]) * 1e3
        nl = -(-L // 128)
        recompute = 2 * m * N * d_in * 128 * nl * nl - hidden_ops
    byte_ms = nbytes / PEAK_BYTES_PER_S * 1e3
    bound_by = "bytes" if byte_ms > op_ms else "operations"
    return nbytes, max(byte_ms, op_ms), bound_by, recompute


def kernel_case(torch, kernel, ref, kind, shape, precision, activation,
                gen, label):
    """One kernel against its plain version on the same inputs, timed
    beside the plain version and one library call."""
    m, N, L, D, d_in = shape
    dtype = torch.bfloat16 if precision == "bf16" else torch.float32
    T = torch.randn(m, N, D, device="cuda", generator=gen).to(dtype)
    if kind == "gram_tri":
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

    G, R = run()
    torch.cuda.synchronize()
    Gp, Rp = plain()
    check(bool(torch.isfinite(G).all() and torch.isfinite(R).all()),
          f"{kind} {label}: non-finite output")
    check(torch.equal(G, G.mT), f"{kind} {label}: G is not exactly symmetric")
    abs_g, rel_g = rel_err(torch, G, Gp)
    abs_r, rel_r = rel_err(torch, R, Rp)
    check(rel_g <= TOL[precision] and rel_r <= TOL[precision],
          f"{kind} {label} {precision}: relative error G {rel_g:.3g} "
          f"R {rel_r:.3g} above {TOL[precision]}")
    nbytes, bound_ms, bound_by, recompute = gram_cost(kind, m, N, L, D, d_in,
                                                      precision)
    case = {
        "case": label, "dtype": precision, "activation": activation,
        "shape": {"m": m, "N": N, "L": L, "D": D, "d_in": d_in},
        "max_abs_err": max(abs_g, abs_r), "rel_err": max(rel_g, rel_r),
        "tol": TOL[precision],
        "kernel_ms": time_ms(torch, run), "plain_ms": time_ms(torch, plain),
        "library_ms": time_ms(torch, library),
        "bound_ms": bound_ms, "bound_by": bound_by, "bytes": nbytes,
    }
    if kind == "gram_fused":
        case["recomputed_hidden_flops"] = recompute
    del G, R, Gp, Rp
    torch.cuda.empty_cache()
    return case


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

    from repro_torch import quickstart
    from repro_torch.core import elm, engine, graph, mtl_elm
    from repro_torch.data import pipeline, synthetic
    from repro_torch.kernels import _build
    from repro_torch.kernels.gram import kernel, ref

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
    kernel.library()
    log = _build.library_path(kernel.SOURCE).with_suffix(".log").read_text()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.build_seconds.get("gram"),
          "ptxas": [ln.strip() for ln in log.splitlines()
                    if "registers" in ln or "spill" in ln]})

    # 3. kernels against their plain versions ------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_shape = (8, 2048, 2048, 3, 256)     # one stream batch of phase 4
    full_shape = (8, 8192, 2048, 8, 256)
    ragged_shape = (3, 1000, 300, 3, 70)
    t0 = time.perf_counter()
    cases = {"gram_tri": [], "gram_fused": []}
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

    kernel.reset_launches()
    stats = timed("stats_fused_s", lambda: pipeline.stream_sufficient_stats(
        batches, producer="fused", feature_map=fmap))
    stats_mat = timed("stats_materialized_s",
                      lambda: pipeline.stream_sufficient_stats(
                          (fmap(x), y) for x, y in batches))
    state, diag = timed("dmtl_fit_s",
                        lambda: engine.fit_dense(stats, ring, cfg))
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
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2**30})

    # 5. quickstart ----------------------------------------------------------
    t0 = time.perf_counter()
    qs = quickstart.main(device="cuda")
    emit({"phase": "quickstart", "seconds": time.perf_counter() - t0,
          "test_mse": {k: qs[k] for k in ("local", "mtl", "dmtl", "fo")}})

    sources = {"gram_tri": "src/repro/kernels/gram/kernel.py:224",
               "gram_fused": "src/repro/kernels/gram/kernel.py:464"}
    rows = []
    for name, cs in cases.items():
        top = cs[0]     # the main path's shape
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/gram/csrc/gram.cu",
            "replaces": sources[name], "launches": launches[name],
            "max_abs_err": top["max_abs_err"], "ms": top["kernel_ms"],
            "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
            "bound_by": top["bound_by"], "library_ms": top["library_ms"],
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
