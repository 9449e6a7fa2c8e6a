#!/bin/bash
# Mutation check of the fp32 gram_tri and gram_dense gates in chip_smoke.py,
# on one CUDA card.
#
# Copies src/ twice into WORKDIR (default: a fresh temporary directory) and
# breaks each copy's fp32 body (gram_f32_kernel) in its pipeline:
#   one_stage   the G products of one stage, the second, are skipped (16
#               sample rows of G lost, R whole; the stage is still waited
#               for and its slot refilled): a fault the size of a ring's
#               off-by-one;
#   early_wait  cp.async.wait_group waits for one group fewer, so each
#               stage is read while its own copies may still be in flight
#               (the first stage right after its copies started): a ring hazard.
# Each copy is built and prints one JSON line "MUTANT {...}": the broken
# kernels against their plain versions as max |x - plain| / max |plain| over
# G and R beside TOL["fp32"], and max |x - plain| on small-integer inputs
# (chip_smoke.integer_gram_err, where a sound body reads exactly 0; five
# calls, each a run of the gate, since a hazard fires only when a copy is
# still in flight), at phase 3's main-path and full shapes, with the body
# each call ran.  The repository itself is not touched.
#
# Run from the repository root:  bash tools/gram_fp32_mutant_check.sh [WORKDIR]
set -euo pipefail
WORK=${1:-$(mktemp -d)}

# mutant NAME OLD NEW: a copy of src/ in WORK/NAME with OLD (found once in
# gram.cu) replaced by NEW
mutant() {
  local dir="$WORK/$1" cu
  mkdir -p "$dir"
  rm -rf "$dir/src"
  cp -r src "$dir/src"
  rm -rf "$dir/src/repro_torch/kernels/_build"
  cu="$dir/src/repro_torch/kernels/gram/csrc/gram.cu"
  test "$(grep -cF "$2" "$cu")" = 1
  OLD="$2" NEW="$3" python3 - "$cu" <<'PY'
import os
import sys

path = sys.argv[1]
text = open(path).read()
open(path, "w").write(text.replace(os.environ["OLD"], os.environ["NEW"]))
PY
  grep -qF "$3" "$cu"
}

mutant one_stage "if (do_g) g_update<FK>(" "if (do_g && s != 1) g_update<FK>("
mutant early_wait "cp_async_wait<FSTAGES - 2>();" "cp_async_wait<FSTAGES - 1>();"

for name in one_stage early_wait; do
MUT_SRC="$WORK/$name/src" MUT_NAME="$name" python3 - <<'PY'
import json
import math
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
tol = chip_smoke.TOL["fp32"]
out = {"mutant": os.environ["MUT_NAME"], "tol": tol}
for kind, label, (m, N, L, D) in (
        ("gram_tri", "full", (8, 8192, 2048, 8)),
        ("gram_tri", "main_path", (8, 2048, 2048, 3)),
        ("gram_dense", "full", (1, 8192, 2048, 8)),
        ("gram_dense", "main_path", (1, 8192, 2048, 3))):
    shape = (N, L) if kind == "gram_dense" else (m, N, L)
    H = torch.randn(*shape, device="cuda", generator=gen) / math.sqrt(L)
    T = torch.randn(*shape[:-1], D, device="cuda", generator=gen)
    G, R = getattr(kernel, kind)(H, T)
    Gp, Rp = ref.gram_ref(H, T)
    finite = bool(torch.isfinite(G).all() and torch.isfinite(R).all())
    rel = max(chip_smoke.rel_err(torch, G, Gp)[1],
              chip_smoke.rel_err(torch, R, Rp)[1])
    out[f"{kind}_{label}"] = {
        "body": kernel.LAST_GRAM["body"], "finite": finite, "rel_err": rel,
        "rel_err_over_tol": rel / tol,
        "integer_abs_err": [chip_smoke.integer_gram_err(
            torch, kernel, ref, kind, m, N, L, D, gen, "fp32") for _ in range(5)]}
    del H, T, G, R, Gp, Rp
    torch.cuda.empty_cache()
print("MUTANT", json.dumps(out))
PY
done
