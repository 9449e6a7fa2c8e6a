#!/usr/bin/env python3
"""Read the limit of ``chip_smoke.py``'s phase 8c MoE oracle
(``MOE_ORACLE_TOL``: each MoE block's ``moe_ffn`` against
``moe_ffn_by_expert`` on the same input along the route) on one CUDA card,
for the port as it is and for two broken copies of its ``models/moe.py``,
written into a temporary directory outside the repository:

  repeat              the dispatch copies each token's row with ``repeat``
                      (whole sequence K times) where ``repeat_interleave``
                      (each token K times in a row) belongs;
  gather_slot_plus_1  the gather reads each assignment's output from the
                      next slot of the expert buffers.

Each run is a process of its own (the broken copy first on its import
path): granite-moe-3b-a800m at full width, 4 of its 32 layers (the oracle
holds block by block), fp32 weights from the route's seed, bf16 on the
route's agent 0 first batch (8 x 4096 tokens) and fp32 on its first
sequence, at the published capacity factor 1.25.  Prints one line
"MUTANT {...}" per run, with its errors, the limit, whether it passes it,
and the card's name and power limit.  Exits 0 when the sound copy passes
and both broken ones fail.

  python3 tools/moe_mutant_check.py        (from the repository root)
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
MUTANTS = {
    "repeat": ("buf[bidx, flat_slot] = x.repeat_interleave(K, dim=1)",
               "buf[bidx, flat_slot] = x.repeat(1, K, 1)"),
    "gather_slot_plus_1": (
        "gathered = out_flat[bidx, flat_slot].reshape(B, S, K, d)",
        "gathered = out_flat[bidx, (flat_slot + 1) % (E * C + 1)]"
        ".reshape(B, S, K, d)"),
}
LAYERS = 4


def run_one(label: str) -> dict:
    """In this process: the oracle's readings on the port found first on
    the import path."""
    import dataclasses

    import torch

    import chip_smoke
    from repro_torch import backbone, configs
    from repro_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(configs.get_config("granite-moe-3b-a800m"),
                              n_layers=LAYERS)
    params = transformer.init_model(
        torch.Generator(device="cuda").manual_seed(0), cfg)
    tokens = next(backbone.token_batches(
        torch.Generator(device="cuda").manual_seed(1), 1, n=8, seq=4096,
        m=4))[0][0]
    out = {"mutant": label, "layers": LAYERS,
           "source": transformer.moe_ffn.__code__.co_filename}
    for dtype, c, tok in (
            ("bf16", cfg, tokens),
            ("fp32", dataclasses.replace(cfg, dtype="float32"), tokens[:1])):
        rec = chip_smoke.moe_block_errors(torch, params, c, tok)
        limit = chip_smoke.MOE_ORACLE_TOL[dtype]
        out[dtype] = {"rel": rec["rel"], "norm_rel": rec["norm_rel"],
                      "blocks": rec["blocks"], "limit": limit,
                      "passes": rec["rel"] <= limit["rel"]
                      and rec["norm_rel"] <= limit["norm_rel"]}
    out["passes"] = all(out[d]["passes"] for d in ("bf16", "fp32"))
    out["card"] = chip_smoke.nvidia_smi()
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--run":
        print("MUTANT " + json.dumps(run_one(sys.argv[2])), flush=True)
        return 0
    tmp = Path(tempfile.mkdtemp(prefix="moe_mutants_"))
    results = {}
    try:
        for label in ("sound", *MUTANTS):
            src = ROOT / "src"
            if label != "sound":
                src = tmp / label / "src"
                shutil.copytree(ROOT / "src" / "repro_torch",
                                src / "repro_torch",
                                ignore=shutil.ignore_patterns("_build",
                                                              "__pycache__"))
                path = src / "repro_torch" / "models" / "moe.py"
                old, new = MUTANTS[label]
                text = path.read_text()
                if text.count(old) != 1:
                    raise RuntimeError(f"{label}: {old!r} is not in moe.py "
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
                print(f"MUTANT {json.dumps({'mutant': label, 'error': proc.returncode})}")
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
