#!/bin/bash
# Mutation check of the gram_fused gates in chip_smoke.py, on one CUDA card.
#
# Copies src/ into WORKDIR (default: a fresh temporary directory), breaks
# the copy's gram_fused so that every chunk after the first stores its G
# and R instead of adding them (accumulate forced to false), builds it, and
# prints one JSON line "MUTANT {...}": the broken kernel against its plain
# version as max |x - plain| / max |plain| over G and R beside TOL, at
# phase 3's full shape in fp32 (two chunks of the 256 MiB workspace) and in
# bf16 (one chunk: the mutant is not reached there), and at the ragged
# shape with a workspace of 350 rows (chunks of 350, 350 and 300) in both
# precisions.  The repository itself is not touched.
#
# Run from the repository root:  bash tools/gram_fused_mutant_check.sh [WORKDIR]
set -euo pipefail
MUT=${1:-$(mktemp -d)}
mkdir -p "$MUT"
rm -rf "$MUT/src"
cp -r src "$MUT/src"
rm -rf "$MUT/src/repro_torch/kernels/_build"
CU="$MUT/src/repro_torch/kernels/gram/csrc/gram.cu"
sed -i 's|const bool accumulate = n0 > 0;|const bool accumulate = false;|' "$CU"
grep -q "const bool accumulate = false;" "$CU"
MUT_SRC="$MUT/src" python3 - <<'PY'
import json
import os
import sys

sys.path.insert(0, os.environ["MUT_SRC"])
sys.path.insert(1, ".")
import torch

import chip_smoke
from repro_torch.kernels.gram import kernel, ref

assert kernel.__file__.startswith(os.environ["MUT_SRC"]), kernel.__file__
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)
budget = kernel.FUSED_WORKSPACE_BYTES
out = {"tol": chip_smoke.TOL}
for label, (m, N, L, D, d_in), rows in (
        ("full", (8, 8192, 2048, 8, 256), None),
        ("ragged_350_rows", (3, 1000, 300, 3, 70), 350)):
    for precision in ("fp32", "bf16"):
        width = kernel.fused_workspace_width(L, precision)
        kernel.FUSED_WORKSPACE_BYTES = budget if rows is None else (
            rows * m * width * chip_smoke.H_BYTES[precision])
        X = torch.randn(m, N, d_in, device="cuda", generator=gen)
        W = torch.randn(d_in, L, device="cuda", generator=gen) / d_in**0.5
        b = torch.randn(L, device="cuda", generator=gen)
        T = torch.randn(m, N, D, device="cuda", generator=gen)
        T = T.bfloat16() if precision == "bf16" else T
        G, R = kernel.gram_fused(X, W, b, T, "sigmoid", precision)
        Gp, Rp = ref.gram_fused_ref(X, W, b, T, "sigmoid", precision)
        rel = max(chip_smoke.rel_err(torch, G, Gp)[1],
                  chip_smoke.rel_err(torch, R, Rp)[1])
        out[f"{label}_{precision}"] = {
            "chunks": kernel.LAST_FUSED["chunks"],
            "rel_err": rel,
            "rel_err_over_tol": rel / chip_smoke.TOL[precision]}
        del X, W, b, T, G, R, Gp, Rp
        torch.cuda.empty_cache()
print("MUTANT", json.dumps(out))
PY
