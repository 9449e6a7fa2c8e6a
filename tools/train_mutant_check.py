#!/usr/bin/env python3
"""Read ``chip_smoke.py``'s phase 8d gates on one CUDA card for the port as
it is and for three broken copies of it, written into a temporary
directory outside the repository:

  detached_block    the training forward detaches one block's output (layer
                    13 of 26): no gradient reaches the blocks below it or
                    the embedding's input side;
  microbatch_count  the microbatch accumulation divides each gradient by
                    microbatches + 1;
  no_all_reduce     ``moe_ffn_shardmap`` skips its all-reduce over
                    ``model``: each rank keeps its own F slice's partial sum.

Each run is a process of its own (the copy first on its import path, so the
spawned ranks of (c) import it too): recurrentgemma-2b at full width and
depth, seeded fp32 weights, the train variant (remat); gate (b)1 (kernel
forward against plain forward, bf16), (b)2 (2 microbatches against 1,
fp32), (b)3 (the central difference along g / |g|, fp32) and (c) (the
(2, 2) world against ``moe_ffn_gspmd``), each with the script's unchanged
limits.  Prints one line "MUTANT {...}" per run with every reading, its
limit, whether it passes, and the card's name and power limit; then a
summary line.  Exits 0 when the sound copy passes every gate and each
broken copy fails one.

  python3 tools/train_mutant_check.py        (from the repository root)
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DETACH_LAYER = 13
MUTANTS = {
    "detached_block": (
        "models/transformer.py",
        "            aux = aux + a\n        return x, aux\n",
        f"            if first + j == {DETACH_LAYER}:\n"
        "                x = x.detach()\n"
        "            aux = aux + a\n        return x, aux\n"),
    "microbatch_count": (
        "training/steps.py",
        "acc.add_(g.float() / microbatches)",
        "acc.add_(g.float() / (microbatches + 1))"),
    "no_all_reduce": (
        "models/moe.py",
        "summed = mesh.all_reduce(partial, MODEL_AXIS)",
        "summed = partial"),
}


def run_one(label: str) -> dict:
    """In this process: every phase 8d gate's reading on the port found
    first on the import path."""
    import dataclasses

    import torch

    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.kernels.rglru import kernel as rglru_kernel
    from repro_torch.kernels.swa import kernel as swa_kernel
    from repro_torch.launch import shapes
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = shapes.variant_for_shape(configs.get_config(cs.TRAIN_ARCH),
                                   shapes.SHAPES["train_4k"])
    params = transformer.init_model(0, cfg, device="cuda")
    wrappers = {"swa": swa_kernel, "rglru": rglru_kernel}
    out = {"mutant": label,
           "source": transformer._train_stack.__code__.co_filename}
    kp = cs.kernel_vs_plain_loss(torch, params, cfg, wrappers)
    out["b1_kernel_vs_plain"] = {"rel": kp["rel"], "limit": cs.TOL["bf16"],
                                 "passes": kp["rel"] <= cs.TOL["bf16"]}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    mb = cs.microbatch_gate(torch, params, cfg32)
    out["b2_microbatches"] = {
        **mb, "limit": cs.MICROBATCH_TOL,
        "passes": mb["grad_rel_norm"] <= cs.MICROBATCH_TOL
        and mb["loss_rel"] <= cs.MICROBATCH_TOL}
    torch.cuda.empty_cache()
    fd = cs.directional_gate(torch, params, cfg32)
    out["b3_directional"] = {**fd, "limit": cs.FD_TOL,
                             "passes": fd["rel"] <= cs.FD_TOL}
    del params
    torch.cuda.empty_cache()
    rec = cs.model_axis_gate(torch)
    bad = cs.model_axis_failures(rec)
    out["c_model_axis"] = {"out": rec["out"], "grads": rec["grads"],
                           "aux": rec["aux"], "gspmd_aux": rec["gspmd_aux"],
                           "limit": cs.MOE_ORACLE_TOL["fp32"],
                           "passes": not bad}
    out["passes"] = all(out[k]["passes"] for k in (
        "b1_kernel_vs_plain", "b2_microbatches", "b3_directional",
        "c_model_axis"))
    out["card"] = cs.nvidia_smi()
    return out


def build_kernels() -> None:
    """Build ``swa`` and ``rglru`` once in the repository; each copy takes
    the built libraries with it (their names hash the sources)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.rglru import kernel as rglru_kernel
    from repro_torch.kernels.swa import kernel as swa_kernel

    for k in (swa_kernel, rglru_kernel):
        _build.build(k.SOURCE)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--run":
        print("MUTANT " + json.dumps(run_one(sys.argv[2])), flush=True)
        return 0
    build_kernels()
    tmp = Path(tempfile.mkdtemp(prefix="train_mutants_"))
    results = {}
    try:
        for label in ("sound", *MUTANTS):
            src = ROOT / "src"
            if label != "sound":
                src = tmp / label / "src"
                shutil.copytree(ROOT / "src" / "repro_torch",
                                src / "repro_torch",
                                ignore=shutil.ignore_patterns("__pycache__"))
                rel, old, new = MUTANTS[label]
                path = src / "repro_torch" / rel
                text = path.read_text()
                if text.count(old) != 1:
                    raise RuntimeError(f"{label}: {old!r} is not in {rel} "
                                       f"once")
                path.write_text(text.replace(old, new))
            env = dict(os.environ, PYTHONPATH=f"{src}{os.pathsep}{ROOT}")
            proc = subprocess.run(
                [sys.executable, __file__, "--run", label], env=env,
                cwd=ROOT, capture_output=True, text=True, timeout=900)
            sys.stderr.write(proc.stderr[-4000:])
            lines = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith("MUTANT ")]
            if proc.returncode != 0 or not lines:
                print("MUTANT " + json.dumps({"mutant": label,
                                              "error": proc.returncode}))
                return 1
            print(lines[-1], flush=True)
            results[label] = json.loads(lines[-1][len("MUTANT "):])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ok = results["sound"]["passes"] and not any(
        results[m]["passes"] for m in MUTANTS)
    print(json.dumps({"sound_passes": results["sound"]["passes"],
                      "mutants_fail": {m: not results[m]["passes"]
                                       for m in MUTANTS}, "ok": ok}))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
