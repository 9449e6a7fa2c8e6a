#!/bin/bash
# Mutation check of the rglru gate in chip_smoke.py, on one CUDA card.
#
# Copies src/ twice into WORKDIR (default: a fresh temporary directory) and
# breaks each copy's ring (rglru.cu):
#   early_wait   cp.async.wait_group waits for one group fewer, so each
#                slice may be read while its copies are still in flight (the
#                first slice right after its copies started);
#   early_reuse  the refill of the slot freed by the last slice is issued
#                before the barrier that frees it, so a fast warp's copies
#                may overwrite the slice a slower warp still reads.
# Each copy is built and prints one JSON line "MUTANT {...}": the broken
# kernel against its plain version as max |h - plain| / max |plain| beside
# TOL["fp32"] (five calls per case, each a run of the gate, since a hazard
# fires only when a copy is still in flight or lands early), at phase 6's
# call (8, 4096, 2560), at phase 3's ragged case (3, 1000, 300) and at a
# ragged S (2, 4099, 2560).  The repository itself is not touched.
#
# Run from the repository root:  bash tools/rglru_mutant_check.sh [WORKDIR]
set -euo pipefail
WORK=${1:-$(mktemp -d)}

# mutant NAME OLD NEW: a copy of src/ in WORK/NAME with OLD (found once in
# rglru.cu) replaced by NEW
mutant() {
  local dir="$WORK/$1" cu
  mkdir -p "$dir"
  rm -rf "$dir/src"
  cp -r src "$dir/src"
  rm -rf "$dir/src/repro_torch/kernels/_build"
  cu="$dir/src/repro_torch/kernels/rglru/csrc/rglru.cu"
  OLD="$2" NEW="$3" python3 - "$cu" <<'PY'
import os
import sys

path = sys.argv[1]
text = open(path).read()
assert text.count(os.environ["OLD"]) == 1, "the anchor is not in rglru.cu once"
open(path, "w").write(text.replace(os.environ["OLD"], os.environ["NEW"]))
PY
}

WAIT="    cp_async_wait<RING - 2>();
    __syncthreads();  // slice g landed; every thread is done with slice g - 1
    issue(g + RING - 1);"
mutant early_wait "$WAIT" "    cp_async_wait<RING - 1>();
    __syncthreads();
    issue(g + RING - 1);"
mutant early_reuse "$WAIT" "    issue(g + RING - 1);
    cp_async_wait<RING - 1>();
    __syncthreads();"

for name in early_wait early_reuse; do
MUT_SRC="$WORK/$name/src" MUT_NAME="$name" python3 - <<'PY'
import json
import os
import sys

sys.path.insert(0, os.environ["MUT_SRC"])
sys.path.insert(1, ".")
import torch

import chip_smoke
from repro_torch.kernels.rglru import kernel
from repro_torch.kernels.rglru.ref import rglru_scan_ref

assert kernel.__file__.startswith(os.environ["MUT_SRC"]), kernel.__file__
gen = torch.Generator(device="cuda").manual_seed(0)
tol = chip_smoke.TOL["fp32"]
out = {"mutant": os.environ["MUT_NAME"], "tol": tol}
for label, (B, S, D) in (("main_path", (8, 4096, 2560)),
                         ("ragged", (3, 1000, 300)),
                         ("ragged_s", (2, 4099, 2560))):
    log_a = -torch.nn.functional.softplus(
        torch.randn(B, S, D, device="cuda", generator=gen))
    b = torch.randn(B, S, D, device="cuda", generator=gen)
    h0 = torch.randn(B, D, device="cuda", generator=gen)
    plain = rglru_scan_ref(log_a, b, h0)
    rel = []
    for _ in range(5):
        h = kernel.rglru(log_a, b, h0)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(h).all())
        rel.append(chip_smoke.rel_err(torch, h, plain)[1] if finite
                   else float("inf"))
    out[label] = {"rel_err": rel, "rel_err_over_tol": [r / tol for r in rel],
                  "fails": sum(r > tol for r in rel)}
    del log_a, b, h0, plain, h
    torch.cuda.empty_cache()
print("MUTANT", json.dumps(out), flush=True)
PY
done
