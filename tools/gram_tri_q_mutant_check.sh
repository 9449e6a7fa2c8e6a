#!/bin/bash
# Mutation check of the int8 gram_tri_q gates in chip_smoke.py, on one CUDA
# card.
#
# Copies src/ three times into WORKDIR (default: a fresh temporary
# directory) and breaks each copy's int8 tensor-core body (gram_q_kernel):
#   merged_blocks  the int32 sums are not flushed at the row blocks' ends:
#                  they run on over the whole sample axis and are scaled
#                  once, at the end, with the last row block's scales;
#   early_wait     the first stage is consumed (its wgmmas issued, its R
#                  products read) before its mbarrier completes; the wait
#                  follows before the slot is freed, so the ring's phases
#                  stay whole;
#   lost_stage     the G products of one stage, the second, are skipped
#                  (the stage is still waited for and freed; R whole).
# Each copy is built and prints one JSON line "MUTANT {...}": at phase 3's
# four int8 shapes (main path at block_l 128 and 32, full, ragged; block_n
# 512, 128-sample stages), five calls each, since a hazard fires only when
# a copy is still in flight: max |x - plain| / max |plain| over G and R
# beside TOL["int8"], and max |G - plain|, which phase 3 asks to be exactly
# 0; "caught" where either gate fails.  The repository is not touched.
#
# Run from the repository root:  bash tools/gram_tri_q_mutant_check.sh [WORKDIR]
set -euo pipefail
WORK=${1:-$(mktemp -d)}
mkdir -p "$WORK"
WORK=$(cd "$WORK" && pwd)  # absolute: each copy's modules are checked by path

# mutant NAME OLD NEW [OLD NEW ...]: a copy of src/ in WORK/NAME with each
# OLD (a line found once in gram.cu) replaced by its NEW
mutant() {
  local name=$1 dir="$WORK/$1" cu
  shift
  mkdir -p "$dir"
  rm -rf "$dir/src"
  cp -r src "$dir/src"
  rm -rf "$dir/src/repro_torch/kernels/_build"
  cu="$dir/src/repro_torch/kernels/gram/csrc/gram.cu"
  while [ $# -gt 0 ]; do
    test "$(grep -cF "$1" "$cu")" = 1
    OLD="$1" NEW="$2" python3 - "$cu" <<'PY'
import os
import sys

path = sys.argv[1]
text = open(path).read()
open(path, "w").write(text.replace(os.environ["OLD"], os.environ["NEW"]))
PY
    grep -qF "$2" "$cu"
    shift 2
  done
}

mutant merged_blocks \
  "const bool first = u == 0, last = u == spb - 1;  // of the row block" \
  "const bool first = u == 0 && nb == 0, last = u == spb - 1 && nb == nnq - 1;"
mutant early_wait \
  "mbar_wait(&full[stage], phase);  // the stage has landed" \
  "if (nb + u > 0) mbar_wait(&full[stage], phase);" \
  "q_r_stage<KS>(sg, rw, dw, racc);  // while this stage's products run" \
  "q_r_stage<KS>(sg, rw, dw, racc); if (nb + u == 0) mbar_wait(&full[stage], phase);"
mutant lost_stage \
  "for (int k = 0; k < KS / 32; ++k)" \
  "for (int k = 0; k < (nb * spb + u == 1 ? 0 : KS / 32); ++k)"

for name in merged_blocks early_wait lost_stage; do
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
from repro_torch.kernels.gram.ops import resolve_block_n

assert kernel.__file__.startswith(os.environ["MUT_SRC"]), kernel.__file__
torch.backends.cuda.matmul.allow_tf32 = False
gen = torch.Generator(device="cuda").manual_seed(0)
tol = chip_smoke.TOL["int8"]
out = {"mutant": os.environ["MUT_NAME"], "tol": tol}
for label, (m, N, L, D, block_l) in (
        ("main_path", (8, 2048, 2048, 3, 128)),
        ("main_path_bl32", (8, 2048, 2048, 3, 32)),
        ("full", (8, 8192, 2048, 8, 128)),
        ("ragged", (3, 1000, 300, 3, 128))):
    bn = resolve_block_n(N, 512)
    H = torch.randn(m, N, L, device="cuda", generator=gen) / math.sqrt(L)
    T = torch.randn(m, N, D, device="cuda", generator=gen).bfloat16()
    Hq, scales = ref.quantize_tiles(H, bn, block_l, gen)
    del H
    Gp, Rp = ref.gram_tri_q_ref(Hq, scales, T, bn, block_l)
    calls = []
    for _ in range(5):
        G, R = kernel.gram_tri_q(Hq, scales, T, block_n=bn, block_l=block_l)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(G).all() and torch.isfinite(R).all())
        rel = max(chip_smoke.rel_err(torch, G, Gp)[1],
                  chip_smoke.rel_err(torch, R, Rp)[1])
        g_abs = float((G - Gp).abs().max())
        calls.append({"finite": finite, "rel_err_over_tol": rel / tol,
                      "g_abs_err": g_abs,
                      "caught": not finite or rel > tol or g_abs != 0.0})
        del G, R
    out[label] = {"body": kernel.LAST_GRAM["body"], "block_n": bn,
                  "stage": kernel.q_layout(N, bn)[0], "calls": calls}
    del Hq, scales, T, Gp, Rp
    torch.cuda.empty_cache()
print("MUTANT", json.dumps(out))
PY
done
